"""The batched affine consistency check
(parallel/batched_affine.py::track_sequences_affine_batched) held lane by
lane against the port's single-sequence run and against klt_tpu on the
CPU, and the algorithm of kernel F's redesign (reduce-scatter of the
window sums, the elimination with a column a thread) written out in numpy
f32 with 32 simulated threads and held bit for bit against the orders the
plain versions use.  Kernel F itself is
held against the plain versions on a card in test_torch_cuda.py.

Tolerance against klt_tpu: statuses exact, positions within POS_TOL = 1e-3
px, what tests/test_parallel.py grants klt_tpu's batched run against its
own single-sequence run (XLA tiles the [B*N]-lane einsums otherwise).  The
two packages' Gauss-Newton paths differ in the last bits of each
iteration, so a lane whose drift ends within a hundredth of a pixel of
affine_max_displacement_differ may be killed as OOB by one and as
LARGE_RESIDUE by the other: at rate 0.12 one lane of these sequences does
(drift 1.4938 px against 1.5), at rate 0.15 none does.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import klt_tpu
import klt_tpu_torch as kt
from chip_smoke import batched_affine_frames, in_affine_region, lane_shift
from klt_tpu_torch.interop import config_from_fields
from klt_tpu_torch.ops.affine import (AffineState, affine_consistency_step,
                                      lane_sequences)
from klt_tpu_torch.ops.interp import sample_stack_at
from klt_tpu_torch.runtime.pipeline import (track_sequence,
                                            track_sequence_affine)

POS_TOL = 1e-3
N_FEAT = 32
CROP = (slice(72, 168), slice(104, 216))   # 96x112 around the region

kt.set_verbosity(0)
klt_tpu.set_verbosity(0)


@functools.lru_cache(maxsize=None)
def frames(n_seq: int = 3) -> np.ndarray:
    """[B, 6, 96, 112]: crops of batched_affine_frames around the
    deforming region, which rate 0.15 covers within 5 frames; sequence b
    flipped by b % 4 and moved on lane_shift(b)."""
    return np.ascontiguousarray(
        batched_affine_frames(n_seq, 6, rate=0.15)[:, :, CROP[0], CROP[1]])


def configs(mode, **kw):
    jcfg = klt_tpu.TrackingConfig(sequential_mode=True,
                                  affine_consistency_check=mode,
                                  n_pyramid_levels=2, subsampling=2, **kw)
    return jcfg, config_from_fields(dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def start_features(n_seq: int = 3):
    """numpy x, y f32 and val i32 [B, N_FEAT], selected on each
    sequence's frame 0."""
    cfg = configs(2)[1]
    out = []
    for b in range(n_seq):
        fl = kt.FeatureList.create(N_FEAT)
        kt.KLTracker(cfg, device="cpu").select_good_features(
            frames(n_seq)[b, 0], fl)
        out.append((fl.x, fl.y, fl.val))
    return tuple(np.stack(a) for a in zip(*out))


def tensors(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


# ------------------------------------------------------------------ #
# the batched run against the port's single-sequence run               #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("mode", [0, 1, 2])
def test_every_lane_equals_its_sequence_alone(mode):
    """Lane (b, n) of the plain batched run is bit-equal to
    track_sequence_affine(plain=True) on sequence b alone, and the check
    killed features in every sequence (TRACKED to the end without it,
    lost with it), in the deforming region."""
    cfg = configs(mode)[1]
    fr = frames()
    feats = start_features()
    bx, by, bv = kt.track_sequences_affine_batched(
        *tensors(fr, *feats), cfg, plain=True)
    assert bx.shape == (fr.shape[1] - 1, fr.shape[0], N_FEAT)
    for b in range(fr.shape[0]):
        one = track_sequence_affine(*tensors(fr[b], *(a[b] for a in feats)),
                                    cfg, plain=True)
        for got, want in zip((bx[:, b], by[:, b], bv[:, b]), one):
            assert torch.equal(got, want), (mode, b)
        free = track_sequence(*tensors(fr[b], *(a[b] for a in feats)),
                              dataclasses.replace(
                                  cfg, affine_consistency_check=-1))[2]
        killed = (free[-1] == kt.TRACKED) & (bv[-1, b] < 0)
        assert killed.sum() >= 1, (mode, b)
        # in the sequence's frame 0, shifted by lane_shift(b, 0) = 0
        x0, y0 = feats[0][b][killed.numpy()], feats[1][b][killed.numpy()]
        assert in_affine_region(x0 + CROP[1].start, y0 + CROP[0].start,
                                margin=12).all(), (mode, b)
    assert lane_shift(1, 3) != lane_shift(2, 3)


def test_one_sequence_equals_the_single_step_and_precomp_is_bit_equal():
    """B = 1 gives track_sequence_affine's bits; precomp=True gives the
    default's, with a batched build of several frame indices a launch."""
    cfg = configs(2)[1]
    fr = frames()
    feats = start_features()
    one = kt.track_sequences_affine_batched(
        *tensors(fr[1:2], *(a[1:2] for a in feats)), cfg)
    ref = track_sequence_affine(*tensors(fr[1], *(a[1] for a in feats)),
                                cfg)
    assert all(torch.equal(a[:, 0], b) for a, b in zip(one, ref))
    full = kt.track_sequences_affine_batched(*tensors(fr, *feats), cfg)
    pre = kt.track_sequences_affine_batched(*tensors(fr, *feats), cfg,
                                            precomp=True)
    assert all(torch.equal(a, b) for a, b in zip(full, pre))


def test_batched_step_equals_the_steps_of_each_sequence():
    """One consistency step over B * N lanes on [B, 3, H, W] stacks equals
    the B single-sequence steps, outputs and the state's tensors alike,
    from a mid-sequence state with saved patches."""
    cfg = configs(2)[1]
    rng = np.random.RandomState(4)
    b, n, h, w = 3, 20, 40, 48
    stacks = [torch.from_numpy(rng.uniform(0, 50, (b, 3, h, w))
                               .astype(np.float32)) for _ in range(2)]
    x_old = torch.from_numpy(rng.uniform(10, 38, b * n).astype(np.float32))
    y_old = torch.from_numpy(rng.uniform(10, 30, b * n).astype(np.float32))
    xn, yn = x_old + 0.3, y_old - 0.2
    vn = torch.from_numpy(rng.choice([0, 0, 0, -1], b * n).astype(np.int32))
    state = AffineState.create(b * n, cfg, "cpu")
    state.valid[::2] = True
    state.patches.copy_(torch.from_numpy(
        rng.uniform(0, 50, state.patches.shape).astype(np.float32)))
    state.x[:] = 8.5
    state.y[:] = 8.25
    singles = [dataclasses.replace(state, **{
        f.name: getattr(state, f.name)[..., s * n:(s + 1) * n].clone()
        if f.name != "patches" else
        state.patches[:, s * n:(s + 1) * n].clone()
        for f in dataclasses.fields(state)}) for s in range(b)]
    out = affine_consistency_step(state, *stacks, x_old, y_old, vn, xn, yn,
                                  vn, cfg)
    for s, one in enumerate(singles):
        lanes = slice(s * n, (s + 1) * n)
        ref = affine_consistency_step(one, stacks[0][s], stacks[1][s],
                                      x_old[lanes], y_old[lanes], vn[lanes],
                                      xn[lanes], yn[lanes], vn[lanes], cfg)
        assert all(torch.equal(a[lanes], r) for a, r in zip(out, ref))
        for f in dataclasses.fields(state):
            got = getattr(state, f.name)
            got = got[:, lanes] if f.name == "patches" else got[lanes]
            assert torch.equal(got, getattr(one, f.name)), f.name
    assert int((out[2] != vn).sum()) > 0   # the check did something


def test_sampler_and_lanes_of_batched_stacks():
    """sample_stack_at with a sequence index reads each lane's own
    sequence, bit-equal to sampling that sequence alone; lane_sequences
    deals N lanes sequence-major and refuses a B that does not divide
    N."""
    rng = np.random.RandomState(9)
    stack = torch.from_numpy(rng.rand(3, 3, 20, 30).astype(np.float32))
    xs = torch.from_numpy(rng.uniform(-2, 31, (6, 5)).astype(np.float32))
    ys = torch.from_numpy(rng.uniform(-2, 21, (6, 5)).astype(np.float32))
    seq = lane_sequences(stack, 6)
    assert seq.tolist() == [0, 0, 1, 1, 2, 2]
    got = sample_stack_at(stack, xs, ys, seq[:, None])
    for i in range(6):
        want = sample_stack_at(stack[seq[i]], xs[i], ys[i])
        assert torch.equal(got[:, i], want)
    assert lane_sequences(stack[0], 6) is None
    with pytest.raises(ValueError, match="dividing"):
        lane_sequences(stack, 7)


# ------------------------------------------------------------------ #
# against klt_tpu                                                      #
# ------------------------------------------------------------------ #

def test_batched_affine_matches_klt_tpu(monkeypatch):
    """klt_tpu's track_sequences_affine_batched on its XLA path
    (KLT_TPU_NO_PALLAS=1, one jit compile), mode 2: equal statuses,
    positions within POS_TOL."""
    from klt_tpu.parallel.batched_affine import \
        track_sequences_affine_batched as jbatched
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    jcfg, cfg = configs(2)
    fr = frames()
    feats = start_features()
    ours = kt.track_sequences_affine_batched(*tensors(fr, *feats), cfg)
    ref = jbatched(jnp.asarray(fr), *(jnp.asarray(a) for a in feats), jcfg)
    vs, jv = ours[2].numpy(), np.asarray(ref[2])
    np.testing.assert_array_equal(vs, jv)
    live = jv >= 0
    for a, j in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy()[live], np.asarray(j)[live],
                                   rtol=0, atol=POS_TOL)
    assert (jv[-1] == kt.TRACKED).sum() >= 10 and (jv[-1] < 0).sum() >= 10


# ------------------------------------------------------------------ #
# kernel F's redesign, 32 simulated threads in numpy f32               #
# ------------------------------------------------------------------ #

WARP = 32


def mode_sizes(mode):
    """(np, nt, ns, m, shift) of csrc/affine.cu's Mode<MODE>."""
    n_par = (2, 4, 6)[mode]
    nt = 3 if mode == 0 else n_par * (n_par + 1) // 2
    ns = nt + n_par
    m = 8 if ns <= 8 else 16 if ns <= 16 else 32
    return n_par, nt, ns, m, {8: 2, 16: 1, 32: 0}[m]


def thread_partials(cells):
    """[NS, ncell] f32 -> [32, NS]: thread t adds cells t, t + 32, ... of
    the window padded with +0.0 to a multiple of 32 (the chunk loop)."""
    ns, ncell = cells.shape
    pad = np.zeros((ns, -ncell % WARP), np.float32)
    chunks = np.concatenate([cells, pad], 1).reshape(ns, -1, WARP)
    acc = chunks[:, 0].copy()
    for k in range(1, chunks.shape[1]):
        acc = acc + chunks[:, k]
    return acc.T.copy()


def reduce_scatter_model(part, m):
    """reduce_scatter<NS, M>: part [32, NS] f32 -> [32] (thread t's
    result), recursive halving over the offsets 16 .. 1, own slot first."""
    lanes = np.arange(WARP)
    w = np.zeros((WARP, m), np.float32)
    w[:, :part.shape[1]] = part
    for s in range(5):
        off, half = 16 >> s, m >> (s + 1)
        if half:
            hi = (lanes & off) != 0
            send = np.where(hi[:, None], w[:, :half], w[:, half:2 * half])
            keep = np.where(hi[:, None], w[:, half:2 * half], w[:, :half])
            w = w.copy()
            w[:, :half] = keep + send[lanes ^ off]
        else:
            w[:, 0] = w[:, 0] + w[lanes ^ off, 0]
    return w[:, 0]


def butterfly_model(part):
    """Today's warp_sum per sum: part [32, NS] -> [NS] (every thread ends
    with the same value; thread 0's)."""
    lanes = np.arange(WARP)
    v = part.copy()
    for off in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ off]
    return v[0]


def adversarial_cells(rng, ns, ncell, kind):
    if kind == "random":
        return rng.standard_normal((ns, ncell)).astype(np.float32) * 100
    if kind == "cancelling":   # large terms of both signs, small remainders
        big = rng.choice([-1, 1], (ns, ncell)) * 3e7
        return (big + rng.standard_normal((ns, ncell))).astype(np.float32)
    if kind == "denormal":
        return (rng.standard_normal((ns, ncell)) * 1e-39).astype(np.float32)
    # signed zeros and zeros beside tiny values
    z = rng.choice(np.array([0.0, -0.0, 1e-45, -1e-45], np.float32),
                   (ns, ncell))
    z[:, ::3] = -0.0
    return z


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("kind", ["random", "cancelling", "denormal",
                                  "zeros"])
@pytest.mark.parametrize("ncell", [225, 81, 55, 256])
def test_reduce_scatter_equals_the_butterfly(mode, kind, ncell):
    """Sum j on thread j << shift after the recursive halving has the bits
    of the xor butterfly and of ops/lk.py::_window_sum (the plain side's
    order), on random, cancelling, denormal and signed-zero cells."""
    from klt_tpu_torch.ops.lk import _window_sum
    _, _, ns, m, shift = mode_sizes(mode)
    rng = np.random.RandomState(ncell + 7 * mode)
    cells = adversarial_cells(rng, ns, ncell, kind)
    part = thread_partials(cells)
    got = reduce_scatter_model(part, m)
    holders = got[np.arange(ns) << shift]
    want = butterfly_model(part)
    plain = _window_sum(torch.from_numpy(cells)).numpy()
    assert holders.tobytes() == want.tobytes() == plain.tobytes()


def tri(a, b, n_par):
    return a * n_par - a * (a - 1) // 2 + (b - a)


def distributed_solve_model(red, mode):
    """solve<MODE>: red [32] (thread t holds sum t >> shift, as the
    reduce-scatter leaves it) -> (solution [np], small).  Thread c <= np
    gathers column c of [T | 0.5 e]; per pivot column k every thread takes
    the pivot column from thread k, divides its own entry of row k by the
    pivot and subtracts that multiple of the pivot column."""
    n_par, nt, _, _, shift = mode_sizes(mode)
    c = np.minimum(np.arange(WARP), n_par)
    col = np.zeros((WARP, n_par), np.float32)   # thread t's column
    for r in range(n_par):
        src = np.array([(tri(min(r, ci), max(r, ci), n_par) if ci < n_par
                         else nt + r) << shift for ci in c])
        v = red[src]
        col[:, r] = np.where(c < n_par, v, v * np.float32(0.5))
    small = False
    with np.errstate(all="ignore"):
        for k in range(n_par):
            f = col[k].copy()                   # broadcast from thread k
            zero = f[k] == 0
            small = small or zero
            safe = np.float32(1) if zero else f[k]
            a = col[:, k] / safe                # one division a thread
            for r in range(n_par):
                col[:, r] = a if r == k else col[:, r] - f[r] * a
    return col[n_par].copy(), small


def plain_solve(cells, mode):
    """The plain side: window sums in _window_sum's order, T and e
    assembled as track_affine_plain does, gj_solve_spd."""
    from klt_tpu_torch.ops.lk import _window_sum
    from klt_tpu_torch.utils.linalg import gj_solve_spd
    n_par, nt, _, _, _ = mode_sizes(mode)
    sums = _window_sum(torch.from_numpy(cells))
    T = torch.empty((1, n_par, n_par))
    i = 0
    for p in range(n_par):
        for q in range(p, n_par):
            T[0, p, q] = T[0, q, p] = sums[i]
            i += 1
    e = sums[nt:][None, :, None] * 0.5
    sol, small = gj_solve_spd(T, e)
    return sol[0, :, 0].numpy(), bool(small[0])


def design_cells(rng, mode, ncell, flat_column=None):
    """[NS, ncell] f32 cells of the normal equations of one iteration:
    products of design columns d (and d * diff) as the chunk loop forms
    them; flat_column zeroes one design column (a zero pivot)."""
    n_par, _, _, _, _ = mode_sizes(mode)
    d = (rng.standard_normal((n_par, ncell)) * 20).astype(np.float32)
    if flat_column is not None:
        d[flat_column] = 0.0
    diff = (rng.standard_normal(ncell) * 5).astype(np.float32)
    terms = [d[a] * d[b] for a in range(n_par) for b in range(a, n_par)]
    terms += [d[a] * diff for a in range(n_par)]
    return np.stack(terms).astype(np.float32)


@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("case", ["random", "zero pivot", "all zero",
                                  "ill-conditioned"])
def test_distributed_elimination_equals_gj_solve_spd(mode, case):
    """The column-a-thread elimination after the reduce-scatter gives
    utils/linalg.py::gj_solve_spd's solution bit for bit, and its zero
    pivots."""
    n_par, _, ns, m, _ = mode_sizes(mode)
    rng = np.random.RandomState(3 + mode)
    for rep in range(20):
        if case == "random":
            cells = design_cells(rng, mode, 225)
        elif case == "zero pivot":
            cells = design_cells(rng, mode, 225, flat_column=rep % n_par)
        elif case == "all zero":
            cells = np.zeros((ns, 225), np.float32)
        else:   # two nearly equal design columns
            cells = design_cells(rng, mode, 225)
            d = (rng.standard_normal((n_par, 225)) * 20).astype(np.float32)
            d[1] = d[0] * np.float32(1 + 1e-4)
            cells = np.stack([d[a] * d[b] for a in range(n_par)
                              for b in range(a, n_par)] +
                             [d[a] * cells[-1] for a in range(n_par)])
        red = reduce_scatter_model(thread_partials(cells), m)
        got, small = distributed_solve_model(red, mode)
        want, want_small = plain_solve(cells, mode)
        assert small == want_small
        assert got.tobytes() == want.tobytes(), (case, rep)
        if case in ("zero pivot", "all zero"):
            assert small
