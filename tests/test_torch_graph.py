"""The sequence entries' chunked loop (klt_tpu_torch/cuda/graph.py) on
the CPU, where it runs each chunk function as it is, without capture: the
bookkeeping that the card's CUDA graphs share (the staging of frames, the
carried stacks and features, the remainder in powers of two, the exact
tier's resume after a repair, the cache).

Each entry runs at 64x80 with a few features over T - 1 = 1, K - 1, K,
K + 3 and 2K + 1 steps (K = cuda.graph.K): its table equals the same entry
run one step a chunk (graph.K = 1 for the entries of `_run`, chunk=1 for
the stream and the exact tier) bit for bit, so the carry between chunks,
the rows, the remainder and the resume are what the two runs differ in;
every kernel call is the same.  At 2K + 1 steps each entry is also held
against klt_tpu's entry of that name (XLA path, KLT_TPU_NO_PALLAS=1) with
the tolerances of the entry's own test file: statuses exact, positions
within POS_TOL (tests/test_torch_replace.py, test_torch_batched.py),
AFFINE_POS_TOL (test_torch_affine.py); the exact tier's repaired frames
and picks as tests/test_torch_exact_sequence.py asks.  The graphs
themselves are held against the same chunk functions run eagerly on a
card in test_torch_cuda.py and chip_smoke.py phase 40.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import klt_tpu
import klt_tpu_torch as kt
from chip_smoke import affine_frames, synthetic_frames, tie_frames
from klt_tpu_torch.cuda import graph
from klt_tpu_torch.parallel import (track_sequences_affine_batched,
                                    track_sequences_batched)
from klt_tpu_torch.runtime import pipeline

POS_TOL = 1e-3          # px, tests/test_torch_replace.py's
AFFINE_POS_TOL = 3.1e-5  # px, tests/test_torch_affine.py's
K = graph.K
STEPS = [1, K - 1, K, K + 3, 2 * K + 1]
ENTRIES = ["track", "replace", "affine", "batched", "batched_affine",
           "stream", "exact"]
H, W = 64, 80
ORIGINS = ((40, 60), (80, 120), (140, 210))   # (row, col) of each crop
AFFINE_ORIGIN = (88, 120)   # around affine_frames' deforming region
N_FEAT = 24

kt.set_verbosity(0)
klt_tpu.set_verbosity(0)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _crop(frames, origin):
    r0, c0 = origin
    return np.ascontiguousarray(frames[..., r0:r0 + H, c0:c0 + W])


def config_fields(entry) -> dict:
    """The configuration of an entry's cell, for both packages: the
    affine ones klt_tpu's affine test configuration (mode 2, 2 levels of
    subsampling 2), mindist 3 to select a few features in 64x80."""
    kw = {"sequential_mode": True, "mindist": 3}
    if entry in ("affine", "batched_affine"):
        kw.update(affine_consistency_check=2, n_pyramid_levels=2,
                  subsampling=2)
    return kw


@functools.lru_cache(maxsize=None)
def _inputs(entry):
    """(cfg, frames [2K+2, H, W] or [B, 2K+2, H, W], x, y, val) as numpy:
    the synthetic scene's known motion; a flat patch and, from frame 5,
    a pasted block (tie_frames: features lost, replacement, integer ties)
    for the replace entries; the deforming region for the affine ones."""
    n = 2 * K + 2
    affine = entry in ("affine", "batched_affine")
    cfg = kt.TrackingConfig(**config_fields(entry))
    if affine:
        one = _crop(affine_frames(n, rate=0.12), AFFINE_ORIGIN)
        frames = np.stack([one, one[..., ::-1]]) if entry.startswith(
            "batched") else one
    else:
        scene = synthetic_frames(n)
        seqs = [_crop(scene, o) for o in ORIGINS]
        if entry in ("replace", "exact"):
            seqs = [tie_frames(s, 5) for s in seqs]
        frames = np.stack(seqs) if entry == "batched" else seqs[0]
    frames = np.ascontiguousarray(frames)
    firsts = frames[:, 0] if frames.ndim == 4 else frames[None, 0]
    feats = []
    for f0 in firsts:
        fl = kt.FeatureList.create(N_FEAT)
        kt.KLTracker(cfg, device="cpu").select_good_features(f0, fl)
        feats.append((fl.x, fl.y, fl.val))
    x, y, val = (np.stack(a) for a in zip(*feats))
    if frames.ndim == 3:
        x, y, val = x[0], y[0], val[0]
    return cfg, frames, x, y, val


def inputs(entry, steps):
    cfg, frames, x, y, val = _inputs(entry)
    frames = frames[..., :steps + 1, :, :]
    return cfg, torch.from_numpy(np.ascontiguousarray(frames)), \
        [torch.from_numpy(a.copy()) for a in (x, y, val)]


def stream_table(frames, feats, cfg, chunk=K):
    """The stream's snapshots, one a chunk, stacked: (t, x, y, val)."""
    snaps = list(pipeline.track_sequence_stream(iter(frames), *feats, cfg,
                                                chunk=chunk, device="cpu"))
    return [s[0] for s in snaps], [np.stack([s[i] for s in snaps])
                                   for i in (1, 2, 3)]


def table(entry, f, feats, cfg, chunk=K):
    """The entry's table as numpy, its chunks of `chunk` steps (the
    stream: its snapshots at the ends of chunks of K)."""
    if entry == "stream":
        ts, got = stream_table(f, feats, cfg)
        if chunk == K:
            return got
        every, snaps = stream_table(f, feats, cfg, chunk)
        return [a[[every.index(t) for t in ts]] for a in snaps]
    if entry == "exact":
        got = kt.track_sequence_replace_exact(f, *feats, cfg, chunk=chunk)
    else:
        seq = {"track": pipeline.track_sequence,
               "replace": pipeline.track_sequence_replace,
               "affine": pipeline.track_sequence_affine,
               "batched": track_sequences_batched,
               "batched_affine": track_sequences_affine_batched}[entry]
        got = seq(f, *feats, cfg)
    return [a.numpy() for a in got]


def runs(entry, steps, monkeypatch):
    """(the chunked loop's table, the table of one step a chunk)."""
    cfg, f, feats = inputs(entry, steps)
    got = table(entry, f, feats, cfg)
    with monkeypatch.context() as m:
        m.setattr(graph, "K", 1)
        ref = table(entry, f, feats, cfg, chunk=1)
    return got, ref


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("entry", ENTRIES)
def test_chunked_loop_equals_the_eager_loop(entry, steps, monkeypatch):
    """The chunked loop against the same entry run one step a chunk."""
    got, ref = runs(entry, steps, monkeypatch)
    assert got[0].shape[0] == (-(-steps // K) if entry == "stream"
                               else steps)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def klt_tpu_table(entry, frames, feats, monkeypatch):
    """klt_tpu's table of the same run (XLA path)."""
    from klt_tpu.parallel import batched_affine as jba, batched_lk as jbl
    from klt_tpu.runtime import pipeline as jp
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    jcfg = klt_tpu.TrackingConfig(**config_fields(entry))
    fr = jnp.asarray(frames)
    jf = [jnp.asarray(a) for a in feats]
    if entry == "stream":
        snaps = list(jp.track_sequence_stream(iter(frames), *feats, jcfg,
                                              chunk=K))
        return [np.stack([np.asarray(s[i]) for s in snaps])
                for i in (1, 2, 3)]
    if entry == "exact":
        monkeypatch.setenv("KLT_TPU_REPLACE_CHUNK", str(K))
        return [np.asarray(a) for a in jp.track_sequence_replace_exact(
            frames, *feats, jcfg)]
    fn = {"track": jp.track_sequence,
          "replace": jp.track_sequence_replace,
          "affine": jp.track_sequence_affine,
          "batched": jbl.track_sequences_batched,
          "batched_affine": jba.track_sequences_affine_batched}[entry]
    return [np.asarray(a) for a in fn(fr, *jf, jcfg)]


@pytest.mark.parametrize("entry", ENTRIES)
def test_chunked_loop_agrees_with_klt_tpu(entry, monkeypatch):
    """2K + 1 steps (chunks K, K and 1) against klt_tpu's entry."""
    steps = 2 * K + 1
    cfg, f, feats = inputs(entry, steps)
    got = table(entry, f, feats, cfg)
    ref = klt_tpu_table(entry, f.numpy(), [a.numpy() for a in feats],
                        monkeypatch)
    np.testing.assert_array_equal(got[2] > 0, ref[2] > 0)
    np.testing.assert_array_equal(got[2][got[2] <= 0], ref[2][ref[2] <= 0])
    tol = AFFINE_POS_TOL if "affine" in entry else POS_TOL
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    if entry in ("replace", "exact"):
        assert (got[2] > 0).sum() >= 5   # slots refilled


def test_exact_repair_resumes_inside_a_chunk(monkeypatch):
    """tie_frames meet an integer tie in the first chunk: the chunked
    loop repairs that frame on the host, resumes from its kept pyramid
    inside the chunk and ends as the run of one step a chunk, repairing
    the same frames."""
    cfg, f, feats = inputs("exact", 2 * K + 1)
    repaired = {K: [], 1: []}
    tables = {}
    orig = pipeline._repair_replacement_host
    for chunk in (K, 1):
        def spy(frame, *args, chunk=chunk):
            repaired[chunk].append(next(i for i in range(len(f))
                                        if torch.equal(f[i], frame)))
            return orig(frame, *args)
        monkeypatch.setattr(pipeline, "_repair_replacement_host", spy)
        tables[chunk] = kt.track_sequence_replace_exact(f, *feats, cfg,
                                                        chunk=chunk)
    assert repaired[K] == repaired[1]
    assert repaired[K] and repaired[K][0] < K
    for a, b in zip(tables[K], tables[1]):
        assert torch.equal(a, b)


def test_chunk_lengths_are_klt_tpus():
    assert graph.chunk_lengths(0, 16) == []
    assert graph.chunk_lengths(2 * K + 1, K) == [K, K, 1]
    assert graph.chunk_lengths(K - 1, K) == [1 << i for i in
                                             range(K.bit_length() - 2, -1,
                                                   -1)]
    assert graph.chunk_lengths(45, 32) == [32, 8, 4, 1]
    assert graph.chunk_lengths(7, 5) == [5, 2]


def test_cache_keeps_its_bound():
    """One key per feature count: the cache keeps the CACHE_KEYS most
    recently used programs."""
    cfg, f, feats = inputs("track", 2)
    graph._clear()
    for n in range(1, graph.CACHE_KEYS + 4):
        pipeline.track_sequence(f, *[a[:n] for a in feats], cfg)
    keys = [k for k, _ in graph.programs()]
    assert len(keys) == graph.CACHE_KEYS
    pipeline.track_sequence(f, *[a[:4] for a in feats], cfg)   # evicted
    assert len(graph.programs()) == graph.CACHE_KEYS
    graph._clear()
    assert graph.programs() == []


def test_debug_checks_warn_once_a_call(monkeypatch):
    """KLT_TPU_DEBUG=1: the checks' flags are collected over the whole
    call and read once after it, one warning per failed check."""
    import warnings
    cfg, f, feats = inputs("track", K + 3)
    feats[0][0], feats[2][0] = -5.0, 0
    monkeypatch.setenv("KLT_TPU_DEBUG", "1")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pipeline.track_sequence(f, *feats, cfg)
    msgs = [str(w.message) for w in caught if "debug check" in
            str(w.message)]
    assert msgs == ["debug check failed: input feature positions out of "
                    "bounds"]
