"""The affine consistency cell `laptops_affine_vga_2000.farm_b8` on the
CPU at a small size: the cell through the harness's own dispatch, its
control, the plain reference of the check (benchmark/reference/affine.py)
against the port's plain batched affine run, the frames' warp, the
configuration's source, the roofline counts of kernel F, and the affine
path's span and counters (on the card too: -m cuda).  This file imports
no jax, so on the card it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_bench_affine.py
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import klt_tpu_torch as kt
from benchmark import control, frames as frame_gen, harness
from benchmark.loops import affine_farm
from benchmark.reference import affine as affine_ref
from benchmark.rooflines import (klt_affine_step, klt_build_pyramid,
                                 klt_build_pyramid_batched, klt_lk_pyramid,
                                 klt_lk_pyramid_batched)
from klt_tpu_torch.parallel.batched_affine import \
    track_sequences_affine_batched
from klt_tpu_torch.utils import profiling

CELL = "laptops_affine_vga_2000.farm_b8"
BLOCKS = {"width": 48, "height": 24, "speeds": [2.0, 3.0, 4.0, 6.0],
          "lanes": [0.1, 0.35, 0.6, 0.85], "directions": [1, 1, -1, -1],
          "phases": [0.0, 0.25, 0.5, 0.75]}
# 2 streams of 6 frames, 64 features: 320x240 keeps candidates inside the
# 64-pixel border that 4 levels of subsampling 2 derive
TINY = {"config": {"width": 320, "height": 240, "n_features": 64},
        "traffic": {"streams": 2, "pool": 5, "sample": 1,
                    "traced_requests": 1, "blocks": BLOCKS}}
SEED = 2 ** 31 + 77

kt.set_verbosity(0)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def tiny_traffic(**kw) -> dict:
    _, _, _, traffic = harness.cell_spec(CELL)
    return {**traffic, **TINY["traffic"], **kw}


def program_and_reference_cfg():
    _, _, config, _ = harness.cell_spec(CELL)
    prog, ref = harness.configs(config)
    return (dataclasses.replace(prog, **config["affine"]), ref,
            affine_ref.AffineConfig(**config["affine"]))


def warped(seed=SEED, **kw):
    traffic = tiny_traffic(**kw)
    raw = frame_gen.streams(320, 240, traffic, seed, torch.device("cpu"))
    return affine_farm.warp(raw, traffic)


def start_features(frames, cfg, n=64):
    tr = kt.KLTracker(cfg, device="cpu")
    lists = []
    for s in range(frames.shape[0]):
        fl = kt.FeatureList.create(n)
        tr.select_good_features(frames[s, 0].numpy(), fl)
        lists.append(fl)
    return tuple(torch.from_numpy(np.stack([getattr(fl, k) for fl in lists]))
                 for k in ("x", "y", "val"))


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_cell_tiny():
    out = harness.execute(CELL, SEED, 0.3, False, "cpu", TINY)
    assert out["correct"], out["checked"]
    assert out["checked"]["track_mismatch"] == {"value": 0, "limit": 0}
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["_steps"] == []
    run = out["_run"]
    assert run.counters["followed_steps"] == 5
    assert run.frames_done == out["attempted"] * 2 * 5
    # the reference's counts for the rooflines: 4 levels a step
    assert len(run.lk_stats) == 5 * 4
    assert len(run.counters["affine_stats"]) == 5


def test_control_in_bfloat16_is_refused():
    got = control.readings(CELL, SEED, 0.3, "cpu", TINY)
    assert got["program"]["track_mismatch"] == 0
    assert got["control"]["track_mismatch"] > 0


def test_reference_equals_the_ports_plain_batched_run():
    cfg, ref_cfg, acfg = program_and_reference_cfg()
    frames = warped()
    x, y, val = start_features(frames, cfg)
    prog = track_sequences_affine_batched(frames, x, y, val, cfg, plain=True)
    killed = 0
    for s in range(frames.shape[0]):
        stats = []
        ref = affine_ref.follow(frames[s], x[s], y[s], val[s], ref_cfg, acfg,
                                affine_stats=stats)
        for a, b in zip(prog, ref):
            assert torch.equal(bits(a[:, s]), bits(b))
        killed += sum(st[3] for st in stats)
        assert stats[0][1] == 0 and all(st[0] == 0 for st in stats[1:])
    # the check killed features (not only the translation tracker)
    assert killed > 0


def test_warp_keeps_frame_pool_as_frame_0():
    traffic = tiny_traffic(streams=1, pool=100)
    raw = frame_gen.streams(96, 72, dict(traffic, blocks=dict(
        BLOCKS, width=16, height=8)), SEED, torch.device("cpu"))
    out = affine_farm.warp(raw, traffic)
    assert out.shape == raw.shape and out.dtype == torch.uint8
    assert torch.equal(out[0, 100], out[0, 0])
    assert not torch.equal(out[0, 50], out[0, 0])
    # zoom 1 and no roll leave every frame as it is
    same = affine_farm.warp(raw, dict(traffic, zoom=[1.0, 1.0],
                                      roll_deg=0.0))
    assert torch.equal(same, raw)


def _urls(text: str) -> set:
    return set(re.findall(r"https?://\S+", text))


def test_config_source_shares_no_url():
    """The configuration's source names its own origin: no URL of it is in
    any other configuration's source, in BENCHMARK.json, pending/ or the
    configuration files."""
    bench = harness.benchmark(pending=True)
    folder = os.path.join(harness.HERE, "configs")
    sources = [(c["name"], c["source"]) for c in bench["configs"]]
    for f in os.listdir(folder):
        with open(os.path.join(folder, f)) as fh:
            c = json.load(fh)
        sources.append((c["name"], c["source"]))
    mine = [src for name, src in sources
            if name == "laptops_affine_vga_2000"]
    assert len(mine) == 2 and mine[0] == mine[1] and len(mine[0]) <= 200
    urls = _urls(mine[0])
    assert urls
    for name, src in sources:
        if name != "laptops_affine_vga_2000":
            assert not urls & _urls(src), name


def test_affine_step_roofline_counts_by_hand():
    _, _, acfg = program_and_reference_cfg()
    # one verified lane of a 15x15 window, one iteration, mode 2: its
    # 16x16 intensity cells and 3-plane footprint, one lane's in and out
    n_bytes, n_flops = klt_affine_step.work(0, 1, 1, 1, acfg, 10 ** 6)
    assert n_bytes == 256 * 4 + 3 * 256 * 4 + 33 + 48
    per_iter = 3 * 7 + 1 + 12 + 2 * (21 + 6)
    assert n_flops == 225 * (7 + per_iter + 9) + 2 * 6 ** 3
    # a saved patch: three 17x17 planes read and written
    assert klt_affine_step.work(1, 0, 0, 1, acfg, 10 ** 6)[0] == \
        2 * 3 * 17 * 17 * 4 + 33 + 48
    _, ref_cfg, _ = program_and_reference_cfg()
    assert klt_build_pyramid_batched.work(64, 48, ref_cfg, 3) == tuple(
        3 * v for v in klt_build_pyramid.work(64, 48, ref_cfg))
    shapes = [(64, 48), (32, 24), (16, 12), (8, 6)]
    stats = [(r, torch.ones(4, dtype=torch.bool),
              torch.full((4,), 2, dtype=torch.int32)) for r in (3, 2, 1, 0)]
    assert klt_lk_pyramid_batched.work(stats, 4, shapes, ref_cfg, 8) == \
        tuple(8 * v for v in klt_lk_pyramid.work(stats, 4, shapes, ref_cfg))


def test_affine_reset_span_and_counters_on_the_cpu():
    cfg, _, _ = program_and_reference_cfg()
    frames = warped()[:, :4]
    x, y, val = start_features(frames, cfg, n=16)
    before = profiling.counters()
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        track_sequences_affine_batched(frames, x, y, val, cfg)
    after = profiling.counters()
    names = [s.name for s in profiling.spans()]
    profiling.reset_spans()
    assert names.count("affine.reset") == 1
    assert after["affine.steps"] - before.get("affine.steps", 0) == 3
    assert after["affine.lanes"] - before.get("affine.lanes", 0) == 3 * 32


def test_counts_taken_at_capture_are_credited_per_replay():
    before = profiling.counters()
    profiling.count("capture.test", 3)
    taken = profiling.take_counts(before)
    assert taken == {"capture.test": 3}
    assert profiling.counters() == before
    for _ in range(2):
        profiling.credit_counts(taken)
    assert profiling.counters()["capture.test"] == 6
    profiling._counters.pop("capture.test")


@pytest.mark.cuda
def test_affine_counters_credited_per_replay_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest --noconftest "
                    "-m cuda tests/test_bench_affine.py` on the GPU")
    from klt_tpu_torch.cuda import graph
    cfg, _, _ = program_and_reference_cfg()
    frames = warped()
    x, y, val = start_features(frames, cfg)
    dev = torch.device("cuda")
    on = [a.to(dev) for a in (frames, x, y, val)]
    t = graph.K + 4          # a captured chunk of K steps, then one of 4
    frames_t = on[0][:, :1].expand(-1, t + 1, -1, -1).contiguous()
    frames_t[:, :6] = on[0]
    for call in range(3):    # the warm-up, the captures, replays alone
        before = profiling.counters()
        out = track_sequences_affine_batched(frames_t, *on[1:], cfg)
        torch.cuda.synchronize()
        after = profiling.counters()
        assert after["affine.steps"] - before.get("affine.steps", 0) == t
        assert after["affine.lanes"] - before.get("affine.lanes", 0) == \
            t * x.numel()
    plain = track_sequences_affine_batched(frames_t.cpu(), x, y, val, cfg)
    for a, b in zip(out, plain):
        assert torch.equal(bits(a.cpu()), bits(b))
