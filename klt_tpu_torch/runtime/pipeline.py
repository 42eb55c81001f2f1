"""Device-resident sequence trackers.

Each entry runs its frame loop on the frames' device: each frame's
pyramid is built there and kept as the next step's first pyramid, so
nothing but the per-frame feature tables is produced, and with the CUDA
kernels no step waits for the host.  Pyramid levels travel as stacked
[3, H_l, W_l] tensors, the pyramid kernel's output.  On the card the loop
runs as CUDA graphs of chunks of steps (cuda/graph.py), captured once per
key and replayed, as klt_tpu compiles it into one XLA program: a chunk
costs the host one replay and a few copies, not the wrappers of every
step.

* `track_sequence`: tracking only (klt_tpu's `track_sequence`);
* `track_sequence_replace`: tracking, then lost-feature replacement from
  the new frame's level-0 gradients, every frame (the reference's example3
  REPLACE loop, src/V3/example3GPU.c:34-88);
* `track_sequence_affine`: tracking, then the affine consistency check
  of every tracked feature against its saved reference patch, every frame
  (klt_tpu's `track_sequence_affine`);
* `track_sequence_stream`: tracking of an iterable of frames of any
  length in chunks, carrying the last pyramid on the device;
* `track_sequence_replace_exact`: the replace loop on the bit-exact tier
  (klt_tpu's entry of that name), whose table is the reference C
  tracker's to the bit; the frames whose replacement met an integer tie
  are repaired on the host with the native quicksort walk.

`plain=True` runs the plain torch versions of every kernel on any device —
the reference the kernels are held against on the card.  `precomp=True`
builds the pyramids of a chunk's frames in one batched-pyramid launch
ahead of their steps (klt_tpu's KLT_TPU_PRECOMP_PYR=1), with results
bit-equal to the default's.  `_run_eager` (and `_replace_exact_eager`)
is the step loop of the same kernels one call at a time, which the
graphs are held against.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools

import numpy as np
import torch

from ..config import TrackingConfig
from ..cuda import graph
from ..device import default_device
from ..ops.pyramid import (build_pyramid_stacks, build_pyramid_stacks_plain,
                           build_pyramid_stacks_batched,
                           build_pyramid_stacks_batched_plain)
from ..ops.affine import AffineState, affine_consistency_step
from ..ops.lk import track_features_pyramid_stacks
from ..ops.lk_exact import (build_pyramids_exact, check_exact_config,
                            track_features_exact)
from ..ops.replace import replace_lost_
from ..ops.replace_exact import (exact_response_device,
                                 exact_response_from_grads,
                                 replace_lost_exact_)
from ..ops.selection import (candidate_points, corner_response,
                             corner_response_plain)
from ..utils import checks
from ..utils.profiling import span

# Frames per batched-pyramid launch with precomp: bounds the stacks held
# at once (64 VGA frames of 2-level stacks are about 250 MB).
PRECOMP_FRAMES = 64


def _frame_stacks(frames: torch.Tensor, cfg: TrackingConfig, plain: bool,
                  precomp: bool, per_launch: int | None = None):
    """Each frame's finest-first stacks, in order: one pyramid build per
    frame, or with precomp one batched build per `per_launch` frames
    (default PRECOMP_FRAMES), made just before the first of them is
    needed."""
    per_launch = per_launch or PRECOMP_FRAMES
    if not precomp:
        build = build_pyramid_stacks_plain if plain else build_pyramid_stacks
        for frame in frames:
            yield build(frame, cfg)
        return
    build = (build_pyramid_stacks_batched_plain if plain
             else build_pyramid_stacks_batched)
    for t0 in range(0, frames.shape[0], per_launch):
        stacks = build(frames[t0:t0 + per_launch], cfg)
        for i in range(stacks[0].shape[0]):
            yield [s[i] for s in stacks]


def _run_eager(frames, x, y, val, cfg: TrackingConfig, plain: bool,
               precomp: bool, replace: bool = False, affine: bool = False):
    """The step loop of `track_sequence` (replace=True:
    `track_sequence_replace`, affine=True: `track_sequence_affine`), the
    kernels called one step at a time, without graphs: what the graphs
    are held against on the card."""
    if frames.dim() != 3:
        raise ValueError(f"frames must be [T, H, W], got "
                         f"{tuple(frames.shape)}")
    t_len, n = frames.shape[0], x.shape[0]
    xs = torch.empty((max(t_len - 1, 0), n), dtype=torch.float32,
                     device=frames.device)
    ys = torch.empty_like(xs)
    vals = torch.empty((max(t_len - 1, 0), n), dtype=torch.int32,
                       device=frames.device)
    if t_len == 0:
        return xs, ys, vals
    build = build_pyramid_stacks_plain if plain else build_pyramid_stacks
    respond = corner_response_plain if plain else corner_response
    st1 = build(frames[0], cfg)
    state = AffineState.create(n, cfg, frames.device) if affine else None
    for t, st2 in enumerate(_frame_stacks(frames[1:], cfg, plain, precomp)):
        xn, yn, vn = track_features_pyramid_stacks(st1, st2, x, y, val, cfg,
                                                   plain=plain)
        if affine:
            # level 0 of both frames, the positions before the track
            xn, yn, vn = affine_consistency_step(
                state, st1[0], st2[0], x, y, val, xn, yn, vn, cfg,
                plain=plain)
        x, y, val = xn, yn, vn
        xs[t], ys[t], vals[t] = x, y, val
        if replace:
            # the table rows are the state carried on: replacement fills
            # them in place from the new frame's level-0 gradients
            x, y, val = xs[t], ys[t], vals[t]
            resp = respond(st2[0][1], st2[0][2], cfg.window_width,
                           cfg.window_height)
            replace_lost_(resp, x, y, val, cfg, plain=plain)
        st1 = st2
    return xs, ys, vals


@dataclasses.dataclass
class _Buffers:
    """The static buffers of a sequence program (cuda/graph.py)."""

    frames: torch.Tensor   # [L, H, W] or [L, B, H, W]: a chunk's frames
    st1: list              # the carried first stacks
    feats: tuple           # the carried x, y, val
    rows: tuple | None     # [L, ...] x, y, val: the chunk's table rows
    state: AffineState | None   # the carried affine state


def _buffers(chunk_shape, frames, st1, feats, cfg: TrackingConfig,
             table: bool, affine: bool) -> _Buffers:
    x = feats[0]
    return _Buffers(
        frames=torch.empty(chunk_shape, dtype=frames.dtype,
                           device=frames.device),
        st1=[torch.empty_like(s) for s in st1],
        feats=tuple(torch.empty_like(a) for a in feats),
        rows=tuple(torch.empty((chunk_shape[0], *a.shape), dtype=a.dtype,
                               device=a.device) for a in feats)
        if table else None,
        state=AffineState.create(x.numel(), cfg, x.device) if affine
        else None)


def _copy(dsts, srcs) -> None:
    for dst, src in zip(dsts, srcs):
        dst.copy_(src)


def _load(b: _Buffers, st1, feats) -> None:
    """A call's initial state into the static buffers: the affine state
    reset in place (span `affine.reset`)."""
    _copy((*b.st1, *b.feats), (*st1, *feats))
    if b.state is not None:
        with span("affine.reset"):
            b.state.reset_()


def _chunk_stacks(frames: torch.Tensor, cfg: TrackingConfig, plain: bool,
                  precomp: bool):
    """The stacks of a chunk's frames ([n, H, W], or [n, B, H, W] of B
    sequences), step by step: one pyramid build a step (kernel A, or E on
    the B frames), or with precomp one batched build (E) of up to
    PRECOMP_FRAMES images, max(1, PRECOMP_FRAMES // B) steps a launch."""
    batched = frames.dim() == 4
    if not precomp:
        if batched:
            build = (build_pyramid_stacks_batched_plain if plain
                     else build_pyramid_stacks_batched)
        else:
            build = build_pyramid_stacks_plain if plain \
                else build_pyramid_stacks
        for frame in frames:
            yield build(frame, cfg)
        return
    b = frames.shape[1] if batched else 1
    per = max(1, PRECOMP_FRAMES // b)
    build = (build_pyramid_stacks_batched_plain if plain
             else build_pyramid_stacks_batched)
    for k0 in range(0, frames.shape[0], per):
        imgs = frames[k0:k0 + per]
        stacks = build(imgs.reshape((-1,) + frames.shape[-2:]), cfg)
        for j in range(imgs.shape[0]):
            yield [s[j * b:(j + 1) * b] if batched else s[j] for s in stacks]


def _sequence_chunk(b: _Buffers, n: int, cfg: TrackingConfig, plain: bool,
                    precomp: bool, replace: bool):
    """n steps of a sequence program on its static buffers: the step of
    `_run_eager` (and of the batched tier's), the rows into b.rows, the
    last step's stacks and features carried into b.st1 and b.feats."""
    respond = corner_response_plain if plain else corner_response
    st1, (x, y, val) = b.st1, b.feats
    for k, st2 in enumerate(_chunk_stacks(b.frames[:n], cfg, plain,
                                          precomp)):
        xn, yn, vn = track_features_pyramid_stacks(st1, st2, x, y, val, cfg,
                                                   plain=plain)
        if b.state is not None:
            # level 0 of both frames, the positions before the track; B
            # sequences' lanes flattened sequence-major
            flat = [a.reshape(-1) for a in (x, y, val, xn, yn, vn)]
            out = affine_consistency_step(b.state, st1[0], st2[0], *flat,
                                          cfg, plain=plain)
            xn, yn, vn = (a.reshape(x.shape) for a in out)
        if b.rows is None:
            x, y, val = xn, yn, vn
        else:
            x, y, val = (r[k] for r in b.rows)
            x.copy_(xn), y.copy_(yn), val.copy_(vn)
        if replace:
            # the table rows are the state carried on: replacement fills
            # them in place from the new frame's level-0 gradients
            resp = respond(st2[0][1], st2[0][2], cfg.window_width,
                           cfg.window_height)
            replace_lost_(resp, x, y, val, cfg, plain=plain)
        st1 = st2
    _copy((*b.st1, *b.feats), (*st1, x, y, val))


def _sequence_key(entry: str, step_shape, frames, feats,
                  cfg: TrackingConfig, plain, precomp, longest: int) -> tuple:
    """What a sequence program is cached by: the entry and its flags, the
    shape of a step's frames, the dtypes and devices of the frames and the
    features and the features' shapes, the configuration, the chunk length
    and the debug switch (with it the graphs hold the checks)."""
    return (entry, tuple(step_shape), plain, precomp, longest, cfg,
            checks.debug_enabled(),
            tuple((tuple(a.shape), a.dtype, a.device) for a in feats),
            frames.dtype, frames.device)


def _run(frames, x, y, val, cfg: TrackingConfig, plain: bool,
         precomp: bool, replace: bool = False, affine: bool = False,
         batched: bool = False):
    """The graphed frame loop of the sequence entries: frames [T, H, W]
    with features [N], or with batched=True [B, T, H, W] with [B, N] (the
    batched tier, whose entries check their arguments).  Returns the
    [T-1, ...] tables."""
    if not batched and frames.dim() != 3:
        raise ValueError(f"frames must be [T, H, W], got "
                         f"{tuple(frames.shape)}")
    t_len = frames.shape[int(batched)]
    shape = (max(t_len - 1, 0), *x.shape)
    xs = torch.empty(shape, dtype=torch.float32, device=frames.device)
    ys = torch.empty_like(xs)
    vals = torch.empty(shape, dtype=torch.int32, device=frames.device)
    if t_len == 0:
        return xs, ys, vals
    feats = (x, y, val)
    if batched:
        build = (build_pyramid_stacks_batched_plain if plain
                 else build_pyramid_stacks_batched)
        first = frames[:, 0].contiguous()
        step_shape = (frames.shape[0],) + frames.shape[2:]
    else:
        build = build_pyramid_stacks_plain if plain else build_pyramid_stacks
        first = frames[0]
        step_shape = frames.shape[1:]
    key = _sequence_key("replace" if replace else "affine" if affine
                        else "track", step_shape, frames, feats, cfg, plain,
                        precomp, graph.K)

    def make():
        b = _buffers((graph.K, *step_shape), frames, st1, feats, cfg,
                     table=True, affine=affine)
        return graph.Program(
            b, lambda n: _sequence_chunk(b, n, cfg, plain, precomp, replace),
            frames.device, frames.is_cuda and not plain)

    with span("sequence"), contextlib.ExitStack() as held:
        with span("sequence.load"):
            st1 = build(first, cfg)
            prog = held.enter_context(graph.program(key, make))
            b = prog.static
            _load(b, st1, feats)
        flags = checks.Flags()
        t = 0
        for n in graph.chunk_lengths(t_len - 1, graph.K):
            with span("sequence.stage"):
                b.frames[:n].copy_(frames[:, 1 + t:1 + t + n].transpose(0, 1)
                                   if batched else frames[1 + t:1 + t + n])
            prog.run(n, flags)
            with span("sequence.rows"):
                for out, rows in zip((xs, ys, vals), b.rows):
                    out[t:t + n].copy_(rows[:n])
            t += n
        flags.report()
    return xs, ys, vals


def track_sequence(frames: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   val: torch.Tensor, cfg: TrackingConfig,
                   plain: bool = False, precomp: bool = False):
    """Track features through a whole sequence.

    frames: uint8/f32 [T, H, W]; x, y f32 [N]; val i32 [N], all on one
    device.  Returns (xs, ys, vals) of shape [T-1, N]: the state after
    tracking into each frame t (t = 1..T-1).
    """
    return _run(frames, x, y, val, cfg, plain, precomp)


def track_sequence_replace(frames: torch.Tensor, x: torch.Tensor,
                           y: torch.Tensor, val: torch.Tensor,
                           cfg: TrackingConfig, plain: bool = False,
                           precomp: bool = False):
    """Whole-sequence tracking with lost-feature replacement after every
    frame, on the device (ops/replace.py: the greedy masked argmax, no
    host round trip with the kernels).

    The device analogue of the reference's example3 REPLACE loop
    (src/V3/example3GPU.c:34-88: KLTTrackFeatures then
    KLTReplaceLostFeatures every frame).  frames: uint8/f32 [T, H, W];
    x, y f32 [N]; val i32 [N], all on one device.  Returns (xs, ys, vals)
    of shape [T-1, N]: the state after tracking into frame t and
    replacing.
    """
    return _run(frames, x, y, val, cfg, plain, precomp, replace=True)


def _selection_response(frame, stacks, cfg: TrackingConfig, plain: bool):
    """klt_tpu's response of a raw frame for its replacement
    (replace_exact.exact_response_device): smoothed before selecting or
    not, as the configuration says.  The first is the level-0 gradients
    of the frame's pyramid `stacks` (kernel A keeps the C order), so only
    the second builds anything."""
    if cfg.smooth_before_selecting:
        return exact_response_from_grads(stacks[0][1], stacks[0][2], cfg,
                                         plain=plain)
    return exact_response_device(frame, cfg, plain=plain)


def _repair_replacement_host(frame, stacks, pre_x, pre_y, pre_val,
                             cfg: TrackingConfig, plain: bool):
    """The reference's replacement for one tie-flagged frame: the exact
    response of the raw frame on its device (`stacks`: its pyramid), then
    on the host the candidate list, the native quicksort (the reference's
    own tie order, src/V1/selectGoodFeatures.c:62-96) and the
    minimum-distance walk (:171-239) from the state before replacement.
    Returns numpy (x, y, val)."""
    from .. import native
    resp = _selection_response(frame, stacks, cfg, plain).cpu().numpy()
    h, w = resp.shape
    fx = pre_x.cpu().numpy().astype(np.float32)
    fy = pre_y.cpu().numpy().astype(np.float32)
    fv = pre_val.cpu().numpy().astype(np.int32)
    pts = native.sort_points_desc(candidate_points(resp, cfg, w, h))
    native.min_dist_suppress(pts, fx, fy, fv, w, h, cfg.mindist,
                             cfg.min_eigenvalue, False)
    return fx, fy, fv


def _exact_inputs(frames, x, y, val, cfg: TrackingConfig, tier: str,
                  chunk: int, device):
    """The exact tier's arguments checked and placed: (frames, (x, y,
    val), device, exact)."""
    if tier not in ("exact", "fast"):
        raise ValueError(f"tier must be 'exact' or 'fast', got {tier!r}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    exact = tier == "exact"
    if exact:
        check_exact_config(cfg)
    if isinstance(frames, torch.Tensor) and device is None:
        dev = frames.device
    else:
        dev = default_device(device)
    frames = torch.as_tensor(frames).to(dev)
    if frames.dim() != 3:
        raise ValueError(f"frames must be [T, H, W], got "
                         f"{tuple(frames.shape)}")
    feats, _ = _features_on(x, y, val, dev)
    return frames, feats, dev, exact


@dataclasses.dataclass
class _ExactBuffers:
    """The static buffers of an exact-tier program (cuda/graph.py)."""

    frames: torch.Tensor   # [chunk, H, W]
    st1: list              # the carried first stacks
    feats: tuple           # the carried x, y, val
    rows: tuple            # [chunk, N] x, y, val after replacement
    pre: tuple             # [chunk, N] x, y, val before replacement
    ties: torch.Tensor     # i32 [chunk]: a step's pick met a tie


def _exact_chunk(b: _ExactBuffers, n: int, cfg: TrackingConfig, exact: bool,
                 plain: bool):
    """n steps of the exact tier on its static buffers; returns each
    step's pyramid (kept for a repair)."""
    skip = plain or b.frames.device.type == "cpu"
    if skip:
        b.ties[:n].zero_()
    st1, (x, y, val) = b.st1, b.feats
    kept = []
    for k in range(n):
        frame = b.frames[k]
        st2 = build_pyramids_exact(frame, cfg, plain=plain)
        kept.append(st2)
        if exact:
            xn, yn, vn = track_features_exact(st1, st2, x, y, val, cfg,
                                              plain=plain)
        else:
            xn, yn, vn = track_features_pyramid_stacks(
                st1, st2, x, y, val, cfg, plain=plain)
        for dst in (b.pre, b.rows):
            dst[0][k], dst[1][k], dst[2][k] = xn, yn, vn
        # the table rows are the state carried on: replacement fills them
        # in place
        x, y, val = (r[k] for r in b.rows)
        # the plain loop asks the host anyway: no response without a lost
        # slot (the tie flag stays 0, as klt_tpu's no_replace)
        if not skip or bool((val < 0).any()):
            resp = (exact_response_from_grads(st2[0][1], st2[0][2], cfg,
                                              plain=plain) if exact
                    else _selection_response(frame, st2, cfg, plain))
            replace_lost_exact_(resp, x, y, val, cfg, b.ties[k:k + 1],
                                plain=plain)
        st1 = st2
    _copy((*b.st1, *b.feats), (*st1, x, y, val))
    return kept


def track_sequence_replace_exact(frames, x, y, val, cfg: TrackingConfig,
                                 tier: str = "exact", chunk: int = 32,
                                 plain: bool = False, device=None):
    """Whole-sequence tracking with lost-feature replacement every frame,
    with the reference's semantics to the bit (klt_tpu's entry of this
    name).

    tier="exact": tracking on the bit-exact tier (ops/lk_exact: kernel A's
    pyramids, which keep the C order, and kernel G) and replacement from
    the exact response of the new frame's level-0 gradients (kernel H2) by
    the masked argmax (kernel R's tie entry), so positions, kills and
    picks are the reference C tracker's, except where a pick met an
    integer tie of the response.  Each chunk of `chunk` frames runs on the
    device without a host round trip (on the card one replay of a CUDA
    graph), keeping each frame's pyramid, its state before replacement
    and its tie flag; the flags are read once per chunk.  The first
    flagged frame is repaired on the host with the reference's quicksort
    walk (`_repair_replacement_host`), the frames
    after it are dropped, and the run resumes from the repaired state and
    the kept pyramid, the remaining frames in chunks of `chunk` and then
    of powers of two.  tier="fast": tracking with kernels A and B,
    replacement as above from the exact response of the raw frame
    (klt_tpu's KLT_TPU_REPLACE_TRACK_TIER=fast).  The table does not
    depend on `chunk`.  klt_tpu reads the tier and the chunk from
    KLT_TPU_REPLACE_* variables; the port takes them as arguments only.

    frames: uint8/f32 [T, H, W] tensor (it runs on its device) or numpy
    (to the card; device="cpu" asks for the CPU); x, y f32 [N]; val i32
    [N].  plain=True runs every kernel's plain version.  Returns (xs, ys,
    vals) tensors of shape [T-1, N] on the frames' device: the state after
    tracking into frame t and replacing.
    """
    frames, feats, dev, exact = _exact_inputs(frames, x, y, val, cfg, tier,
                                              chunk, device)
    t_len, n_feats = frames.shape[0], feats[0].shape[0]
    shape = (max(t_len - 1, 0), n_feats)
    xs = torch.empty(shape, dtype=torch.float32, device=dev)
    ys = torch.empty_like(xs)
    vals = torch.empty(shape, dtype=torch.int32, device=dev)
    if t_len < 2:
        return xs, ys, vals
    st1 = build_pyramids_exact(frames[0], cfg, plain=plain)
    key = _sequence_key(tier, frames.shape[1:], frames, feats, cfg, plain,
                        False, chunk)

    def make():
        rows = lambda: tuple(torch.empty((chunk, *a.shape), dtype=a.dtype,
                                         device=dev) for a in feats)
        b = _ExactBuffers(
            frames=torch.empty((chunk, *frames.shape[1:]),
                               dtype=frames.dtype, device=dev),
            st1=[torch.empty_like(s) for s in st1],
            feats=tuple(torch.empty_like(a) for a in feats), rows=rows(),
            pre=rows(), ties=torch.zeros(chunk, dtype=torch.int32,
                                         device=dev))
        return graph.Program(
            b, lambda n: _exact_chunk(b, n, cfg, exact, plain), dev,
            dev.type == "cuda" and not plain)

    with graph.program(key, make) as prog:
        b = prog.static
        _copy((*b.st1, *b.feats), (*st1, *feats))
        flags = checks.Flags()
        t = 1  # the next frame to track into
        while t < t_len:
            n = graph.chunk_lengths(t_len - t, chunk)[0]
            b.frames[:n].copy_(frames[t:t + n])
            kept = prog.run(n, flags)
            flagged = torch.nonzero(b.ties[:n].cpu()).flatten()  # one read
            k = int(flagged[0]) if len(flagged) else n
            for out, rows in zip((xs, ys, vals), b.rows):
                out[t - 1:t - 1 + k].copy_(rows[:k])
            if k == n:
                t += n
                continue
            row = t - 1 + k
            fixed = _repair_replacement_host(frames[t + k], kept[k],
                                             *(p[k] for p in b.pre), cfg,
                                             plain)
            for out, a in zip((xs, ys, vals), fixed):
                out[row] = torch.from_numpy(a).to(dev)
            _copy((*b.st1, *b.feats), (*kept[k], xs[row], ys[row], vals[row]))
            t += k + 1
        flags.report()
    return xs, ys, vals


def _replace_exact_eager(frames, x, y, val, cfg: TrackingConfig,
                         tier: str = "exact", chunk: int = 32,
                         plain: bool = False, device=None):
    """`track_sequence_replace_exact`'s loop with the kernels called one
    step at a time, without graphs: what the graphs are held against on
    the card."""
    frames, (x, y, val), dev, exact = _exact_inputs(frames, x, y, val, cfg,
                                                    tier, chunk, device)
    t_len, n = frames.shape[0], x.shape[0]
    xs = torch.empty((max(t_len - 1, 0), n), dtype=torch.float32, device=dev)
    ys = torch.empty_like(xs)
    vals = torch.empty((max(t_len - 1, 0), n), dtype=torch.int32, device=dev)
    if t_len < 2:
        return xs, ys, vals

    st1 = build_pyramids_exact(frames[0], cfg, plain=plain)
    t = 1  # the next frame to track into
    while t < t_len:
        step = min(chunk, t_len - t)
        pre = (torch.empty((step, n), dtype=torch.float32, device=dev),
               torch.empty((step, n), dtype=torch.float32, device=dev),
               torch.empty((step, n), dtype=torch.int32, device=dev))
        ties = torch.zeros(step, dtype=torch.int32, device=dev)
        pyramids = []
        for k in range(step):
            frame = frames[t + k]
            st2 = build_pyramids_exact(frame, cfg, plain=plain)
            pyramids.append(st2)
            if exact:
                xn, yn, vn = track_features_exact(st1, st2, x, y, val, cfg,
                                                  plain=plain)
            else:
                xn, yn, vn = track_features_pyramid_stacks(
                    st1, st2, x, y, val, cfg, plain=plain)
            pre[0][k], pre[1][k], pre[2][k] = xn, yn, vn
            row = t - 1 + k
            xs[row], ys[row], vals[row] = xn, yn, vn
            # the table rows are the state carried on: replacement fills
            # them in place
            x, y, val = xs[row], ys[row], vals[row]
            # the plain loop asks the host anyway: no response without a
            # lost slot (the tie flag stays 0, as klt_tpu's no_replace)
            if not (plain or dev.type == "cpu") or bool((val < 0).any()):
                resp = (exact_response_from_grads(st2[0][1], st2[0][2], cfg,
                                                  plain=plain) if exact
                        else _selection_response(frame, st2, cfg, plain))
                replace_lost_exact_(resp, x, y, val, cfg, ties[k:k + 1],
                                    plain=plain)
            st1 = st2
        flagged = torch.nonzero(ties.cpu()).flatten()  # one read a chunk
        if not len(flagged):
            t += step
            continue
        k = int(flagged[0])
        row = t - 1 + k
        st1 = pyramids[k]
        fixed = _repair_replacement_host(frames[t + k], st1, pre[0][k],
                                         pre[1][k], pre[2][k], cfg, plain)
        for out, a in zip((xs, ys, vals), fixed):
            out[row] = torch.from_numpy(a).to(dev)
        x, y, val = xs[row], ys[row], vals[row]
        t += k + 1
    return xs, ys, vals


def _features_on(x, y, val, device):
    """(x f32, y f32, val i32) tensors and the device they run on:
    tensors run where they lie, numpy arrays go to the card, and `device`
    overrides both (device="cpu" asks for the plain torch versions)."""
    if device is None and isinstance(x, torch.Tensor):
        dev = x.device
    else:
        dev = default_device(device)
    return tuple(torch.as_tensor(a, dtype=dt).to(dev)
                 for a, dt in ((x, torch.float32), (y, torch.float32),
                               (val, torch.int32))), dev


def track_sequence_affine(frames: torch.Tensor, x: torch.Tensor,
                          y: torch.Tensor, val: torch.Tensor,
                          cfg: TrackingConfig, plain: bool = False,
                          precomp: bool = False):
    """Whole-sequence tracking with the affine consistency check after
    every frame's translation track.

    Carries the per-feature affine state (reference aff_* fields,
    src/V1/klt.h:96-105) through the loop: reference patches saved at
    each feature's first successful track, then verified against the
    current frame every step; drifting features are killed
    (src/V1/trackFeatures.c:1438-1497).  cfg.affine_consistency_check
    must be 0, 1 or 2.

    frames: uint8/f32 [T, H, W]; x, y f32 [N]; val i32 [N], all on one
    device.  Returns (xs, ys, vals) of shape [T-1, N].
    """
    if cfg.affine_consistency_check not in (0, 1, 2):
        raise ValueError("track_sequence_affine needs "
                         "affine_consistency_check 0, 1 or 2, got "
                         f"{cfg.affine_consistency_check}")
    return _run(frames, x, y, val, cfg, plain, precomp, affine=True)


def track_sequence_stream(frames_iter, x, y, val, cfg: TrackingConfig,
                          chunk: int = 64, precomp: bool = False,
                          device=None):
    """Track an arbitrarily long sequence in O(chunk) device memory.

    frames_iter: iterable of uint8/f32 [H, W] frames (numpy or tensors),
    the first frame included; x, y f32 [N] and val i32 [N]: tensors run
    on the device they lie on, numpy arrays on the card (a RuntimeError
    without one), and device="cpu" asks for the CPU.  Each chunk of
    frames is uploaded in one copy; the last pyramid stays on the device
    from chunk to chunk, the unbounded version of the reference's
    sequential mode (src/V1/trackFeatures.c:1285-1294).  On the card a
    chunk is one replay of a CUDA graph of `chunk` steps, a shorter last
    chunk a replay for each power of two it splits into.  With precomp,
    each chunk's pyramids come from one batched launch.

    Yields (t, x, y, val) numpy snapshots after each chunk, t being the
    index of the last frame tracked into.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    feats, dev = _features_on(x, y, val, device)
    it = iter(frames_iter)
    first = torch.as_tensor(next(it)).to(dev)
    st1 = build_pyramid_stacks(first, cfg)
    key = _sequence_key("stream", first.shape, first, feats, cfg, False,
                        precomp, chunk)

    def make():
        b = _buffers((chunk, *first.shape), first, st1, feats, cfg,
                     table=False, affine=False)
        return graph.Program(
            b, lambda n: _sequence_chunk(b, n, cfg, False, precomp, False),
            dev, dev.type == "cuda")

    with graph.program(key, make) as prog:
        b = prog.static
        _load(b, st1, feats)
        t = 0
        while True:
            block = list(itertools.islice(it, chunk))
            if not block:
                return
            frames = torch.stack([torch.as_tensor(f) for f in block]).to(dev)
            if frames.dtype != first.dtype:
                raise ValueError(f"frames of {frames.dtype} after a first "
                                 f"frame of {first.dtype}")
            flags = checks.Flags()
            off = 0
            for n in graph.chunk_lengths(len(block), chunk):
                b.frames[:n].copy_(frames[off:off + n])
                prog.run(n, flags)
                off += n
            flags.report()
            t += len(block)
            # copies: on the CPU .numpy() would share the static buffers
            yield t, *(a.to("cpu", copy=True).numpy() for a in b.feats)


@dataclasses.dataclass
class _PairBuffers:
    """The static buffers of `track_pair_carry`'s step program."""

    st1: list              # image 1's stacks
    img2: torch.Tensor
    feats: tuple           # x, y, val


def _pair_step(b: _PairBuffers, cfg: TrackingConfig):
    """A call of `track_pair_carry` on its static buffers; returns the
    features and image 2's stacks (of the graph's pool on the card)."""
    x, y, val = b.feats
    st2 = build_pyramid_stacks(b.img2, cfg)
    return (*track_features_pyramid_stacks(b.st1, st2, x, y, val, cfg),
            *st2)


def track_pair_carry(pyr1_state, img2: torch.Tensor, feat,
                     cfg: TrackingConfig):
    """One frame-pair step with explicit device-resident pyramid carry
    (stacked-level state, as produced by prepare_pyramids).

    Returns ((x, y, val), pyr2_state): the building block for host-driven
    streaming (e.g. with lost-feature replacement between frames).  On the
    card a replay of the step's CUDA graph (cached by shapes, dtypes,
    devices, cfg and KLT_TPU_DEBUG, as klt_tpu's jit): the arguments are
    copied into its static buffers, and what it returns is copied out, so
    the caller owns every tensor it gets.  `_track_pair_carry_eager` is
    the same step without graphs.
    """
    inputs = (*pyr1_state, img2, *feat)
    dev = img2.device
    key = ("pair_carry", cfg, checks.debug_enabled(),
           tuple((tuple(a.shape), a.dtype, a.device) for a in inputs))

    def make():
        b = _PairBuffers(st1=[torch.empty_like(s) for s in pyr1_state],
                         img2=torch.empty_like(img2),
                         feats=tuple(torch.empty_like(a) for a in feat))
        return graph.Program(b, lambda n: _pair_step(b, cfg), dev,
                             dev.type == "cuda")

    with graph.program(key, make) as prog:
        b = prog.static
        _copy((*b.st1, b.img2, *b.feats), inputs)
        flags = checks.Flags()
        out = [a.clone() for a in prog.run(1, flags)]
        flags.report()
    return tuple(out[:3]), tuple(out[3:])


def _track_pair_carry_eager(pyr1_state, img2: torch.Tensor, feat,
                            cfg: TrackingConfig):
    """`track_pair_carry` as the kernels' calls one at a time: what its
    graph is held against."""
    x, y, val = feat
    st2 = tuple(build_pyramid_stacks(img2, cfg))
    xn, yn, vn = track_features_pyramid_stacks(list(pyr1_state), list(st2),
                                               x, y, val, cfg)
    return (xn, yn, vn), st2


def prepare_pyramids(img: torch.Tensor, cfg: TrackingConfig):
    """Pyramid stacks of the first frame of a stream: one call of kernel
    A a stream, left eager."""
    return tuple(build_pyramid_stacks(img, cfg))
