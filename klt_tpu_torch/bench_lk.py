"""Times of the kernels inside the sequence entry points, on one GPU.

    python3 -m klt_tpu_torch.bench_lk [--tag NAME] [--reps N]
                                      [--wrapper-only] [--kernels-only]

run from the root of a checkout (it takes its synthetic frames from
chip_smoke.py).  For each cell it prints one JSON line: frames/s and wall
per step of the entry point (host clock around synchronised runs, median
of --reps), and from one torch.profiler run the device time per step of
the LK kernels, of the pyramid kernels (A, E), of the replacement (R),
the corner response (D) and the affine check (F) and of everything else,
the device launches per step, and the device-busy share of the wall time.
The cells: `track_sequence` at 320x240 and 640x480, the replace run, the
two batched cells, `track_sequence_affine` at the laptops size (640x480,
2000 requested, mode 2, 4 levels of subsampling 2, 100 `affine_frames`)
and `track_sequences_affine_batched` at 8 x that size over 101
`batched_affine_frames` (skipped on a revision without it).

Then one JSON line of kernel F alone (both entries, device us per call
with the host enqueued ahead, the histogram of the iterations its lanes
ran, the track entry with every lane capped at one iteration and with its
longest lane alone) on the state at step 10 of each affine cell; the
batched cell's is skipped on a revision whose F takes one sequence's
stacks.

After the affine lines, the exact replace run
(`track_sequence_replace_exact`, 640x480, 500 features, 101 frames) as a
cell, and one JSON line of device us per call of its kernels alone: G
and H2 on the state at step 50 (G also with min_displacement 0, so that
every lane it does not kill runs max_iterations on every level), R's tie
entry and R on the state of the step from there on that refilled the most
slots (skipped on a revision without the exact tier; its pyramid is
kernel A's, timed below).

Then one JSON line of device us per call of kernels A, E, R and D alone
(CUDA events around back-to-back calls with the host enqueued ahead):
A at 320x240 and 640x480, E at 32 x 320x240 and 64 x 640x480, R at
640x480 with 500 slots on a tracked state with lost slots and on one with
none, D on kernel A's level-0 gradients at 320x240 and 640x480 (7x7
window); and, from torch.profiler, the device us of each launch of one
call of A, of E and of D, in order.  --kernels-only prints that line
and the exact kernels' line alone (the exact run then runs once, untimed,
to give their states).

A last JSON line gives the host's cost of enqueueing one frame pair at
640x480 (clock around a tight loop of calls, nothing awaited): the LK
pyramid wrapper and its parts, kernel A's wrapper and a table-row copy;
--wrapper-only prints that line alone.  A revision without the pyramid
wrapper skips it.

The script uses only entry points that every revision of the port has
(track_sequence, track_sequence_replace, track_sequences_batched), so two
revisions can be compared on one card within one command: unpack the
other revision into a git-ignored directory, copy this file into its
klt_tpu_torch/, and run the two in turns (other, this, this, other), e.g.

    git archive <rev> | tar -x -C build/parent
    cp klt_tpu_torch/bench_lk.py build/parent/klt_tpu_torch/
    for d in build/parent . . build/parent; do
        (cd $d && python3 -m klt_tpu_torch.bench_lk --tag $d); done
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

import klt_tpu_torch as klt
from chip_smoke import batched_frames, synthetic_frames
from klt_tpu_torch.parallel import track_sequences_batched
from klt_tpu_torch.runtime.pipeline import (track_sequence,
                                            track_sequence_replace)


def select(frame, n, cfg):
    fl = klt.FeatureList.create(n)
    klt.KLTracker(cfg).select_good_features(frame, fl)
    return fl.x, fl.y, fl.val


def profile(run, steps: int) -> dict:
    """Device time and launches per step of run(), LK kernels apart."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    lk_us = all_us = 0.0
    lk_n = all_n = 0
    groups = {"pyramid": ("hpass", "vpass", "pyramid_tiles"),
              "replace": ("replace_lost",),
              "response": ("hsum_products", "vsum_eigen", "response_tiles"),
              "affine": ("affine_step_kernel", "affine_track_kernel"),
              "exact": ("exact_response", "exact_track")}
    group_us = dict.fromkeys(groups, 0.0)
    group_n = dict.fromkeys(groups, 0)
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us <= 0 or "CUDA" not in str(ev.device_type):
            continue
        all_us += us
        all_n += ev.count
        if "lk_" in ev.key:
            lk_us += us
            lk_n += ev.count
        for name, keys in groups.items():
            if any(k in ev.key for k in keys):
                group_us[name] += us
                group_n[name] += ev.count
    per_group = {}
    for name in groups:
        per_group[f"{name}_device_us_per_step"] = group_us[name] / steps
        per_group[f"{name}_launches_per_step"] = group_n[name] / steps
    return {"lk_device_us_per_step": lk_us / steps,
            "lk_launches_per_step": lk_n / steps,
            **per_group,
            "other_device_us_per_step": (all_us - lk_us) / steps,
            "other_launches_per_step": (all_n - lk_n) / steps,
            "device_busy_share_profiled": all_us / (wall * 1e6),
            "wall_us_per_step_profiled": wall * 1e6 / steps}


def measure(name: str, run, steps: int, frames_per_step: int, reps: int,
            tag: str, card: str) -> None:
    run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    out = {"tag": tag, "card": card, "cell": name,
           "frames_per_s": steps * frames_per_step / wall,
           "wall_us_per_step": wall * 1e6 / steps,
           "runs_frames_per_s": [round(steps * frames_per_step / w, 1)
                                 for w in walls]}
    out.update(profile(run, steps))
    print(json.dumps(out), flush=True)


def wrapper_costs(cfg, tag: str, card: str) -> None:
    """Host us per call of the wrappers a `track_sequence` step runs."""
    try:
        from klt_tpu_torch.cuda.lk_level import (_check_pyramid,
                                                 lk_pyramid_cuda)
    except ImportError:
        return
    from klt_tpu_torch.cuda.pyramid import build_pyramid_stacks_cuda
    frames = synthetic_frames(2, scale=2)
    f = torch.from_numpy(frames).cuda()
    feats = [torch.from_numpy(a).cuda() for a in select(frames[0], 2000, cfg)]
    st1, st2 = (build_pyramid_stacks_cuda(f[i], cfg) for i in (0, 1))
    table = torch.empty((4,) + feats[0].shape, device="cuda")

    def copy_row():
        table[1] = feats[0]

    def host_us(fn, n=2000):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return round(us, 2)

    print(json.dumps({"tag": tag, "card": card, "host_us_per_call": {
        "lk_pyramid_cuda": host_us(
            lambda: lk_pyramid_cuda(st1, st2, *feats, cfg)),
        "its checks": host_us(
            lambda: _check_pyramid(st1, st2, *feats, cfg, False)),
        "its three empty_like": host_us(
            lambda: [torch.empty_like(a) for a in feats]),
        "its current_stream": host_us(
            lambda: torch.cuda.current_stream().cuda_stream),
        "build_pyramid_stacks_cuda": host_us(
            lambda: build_pyramid_stacks_cuda(f[1], cfg), 1000),
        "table row copy": host_us(copy_row)}}), flush=True)


def launch_times(fn) -> list:
    """[kernel name, device us] of every launch of one fn(), in order."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    fn()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((e.time_range.start, e.name, getattr(
        e, "device_time", getattr(e, "cuda_time", 0.0)))
        for e in prof.events() if "CUDA" in str(e.device_type))
    short = lambda name: (re.findall(r"(\w+)\(", name) or [name[:40]])[0]
    return [[short(name), round(us, 1)] for _, name, us in evs]


def kernel_costs(cfg, tag: str, card: str) -> None:
    """Device us per call of kernels A, E, R and D alone."""
    from chip_smoke import kernel_times, lost_state
    from klt_tpu_torch.cuda.corner_response import corner_response_cuda
    from klt_tpu_torch.cuda.pyramid import (
        build_pyramid_stacks_batched_cuda, build_pyramid_stacks_cuda)
    from klt_tpu_torch.cuda.replace import replace_lost_cuda_
    qvga = torch.from_numpy(batched_frames(32, 1)[:, 0]).cuda()
    frames = synthetic_frames(65, scale=2)
    vga = torch.from_numpy(frames).cuda()
    us = lambda fn, reps: round(kernel_times(fn, reps, launches=8)[0] * 1e3,
                                2)
    out = {
        "A 320x240": us(lambda: build_pyramid_stacks_cuda(qvga[0], cfg), 100),
        "A 640x480": us(lambda: build_pyramid_stacks_cuda(vga[1], cfg), 100),
        "E 32 x 320x240": us(
            lambda: build_pyramid_stacks_batched_cuda(qvga, cfg), 50),
        "E 64 x 640x480": us(
            lambda: build_pyramid_stacks_batched_cuda(vga[1:], cfg), 20)}
    lost, resp = lost_state(frames, 500, cfg, 5)
    state = [torch.from_numpy(a).cuda() for a in (lost.x, lost.y, lost.val)]
    live = [torch.from_numpy(a).cuda() for a in select(frames[0], 500, cfg)]
    fresh = lambda: [a.clone() for a in state]
    n_lost = int((lost.val < 0).sum())
    out[f"R 640x480, {n_lost} of 500 lost, input copies included"] = us(
        lambda: replace_lost_cuda_(resp, *fresh(), cfg), 100)
    out["the input copies"] = us(fresh, 100)
    out["R 640x480, no slot lost"] = us(
        lambda: replace_lost_cuda_(resp, *live, cfg), 100)
    win = (cfg.window_width, cfg.window_height)
    grads = {"D 320x240": build_pyramid_stacks_cuda(qvga[0], cfg)[0][1:],
             "D 640x480": build_pyramid_stacks_cuda(vga[1], cfg)[0][1:]}
    for name, (gx, gy) in grads.items():
        out[name] = us(lambda: corner_response_cuda(gx, gy, *win), 200)
    per_launch = {
        "A 320x240": launch_times(
            lambda: build_pyramid_stacks_cuda(qvga[0], cfg)),
        "A 640x480": launch_times(
            lambda: build_pyramid_stacks_cuda(vga[1], cfg)),
        "E 32 x 320x240": launch_times(
            lambda: build_pyramid_stacks_batched_cuda(qvga, cfg)),
        "E 64 x 640x480": launch_times(
            lambda: build_pyramid_stacks_batched_cuda(vga[1:], cfg)),
        **{name: launch_times(lambda: corner_response_cuda(gx, gy, *win))
           for name, (gx, gy) in grads.items()}}
    print(json.dumps({"tag": tag, "card": card, "device_us_per_call": out,
                      "device_us_per_launch": per_launch}), flush=True)


AFFINE_STEP = 10   # the step whose state kernel F is timed on


def affine_config():
    """klt_tpu's laptops_2000feat_affine_4level."""
    return klt.TrackingConfig(sequential_mode=True, affine_consistency_check=2,
                              n_pyramid_levels=4, subsampling=2)


def affine_inputs():
    """[(name, frames [B, T, H, W] u8, numpy features [B, N])] of the
    affine cells this revision runs."""
    from chip_smoke import affine_frames
    cfg = affine_config()
    one = affine_frames(100, scale=2)[None]
    cells = [("affine 640x480 x 2000 requested", one)]
    try:
        from chip_smoke import batched_affine_frames
        from klt_tpu_torch.parallel import track_sequences_affine_batched  # noqa
    except ImportError:
        return cells, cfg
    cells.append(("affine batched 8 x 640x480 x 2000 requested",
                  batched_affine_frames(8, 101, scale=2)))
    return cells, cfg


def features_of(frames, n, cfg):
    return [np.stack(a) for a in zip(*[select(frames[i, 0], n, cfg)
                                       for i in range(frames.shape[0])])]


def affine_state(frames, feats, cfg, step: int):
    """Kernel F's inputs at `step` of the affine run on frames [B, T, H, W]
    (B = 1: the single-sequence kernels and [3, H, W] stacks; else kernels
    E and C and [B, 3, H, W] stacks): (the state before the step, the
    step's inputs (stack1, stack2, x_old, y_old, xn, yn, vn), the
    verification's inputs (patches, stack2, x1, y1, x2, y2, maps,
    active))."""
    from klt_tpu_torch.cuda.affine import affine_step_cuda_
    from klt_tpu_torch.cuda.lk_level import (lk_pyramid_batched_cuda,
                                             lk_pyramid_cuda)
    from klt_tpu_torch.cuda.pyramid import (
        build_pyramid_stacks_batched_cuda, build_pyramid_stacks_cuda)
    from klt_tpu_torch.ops.affine import AffineState, verification_inputs
    b = frames.shape[0]
    f = torch.from_numpy(frames[:, :step + 2]).cuda()
    if b == 1:
        stacks = lambda t: build_pyramid_stacks_cuda(f[0, t], cfg)
        lk = lk_pyramid_cuda
        x, y, val = (torch.from_numpy(a[0]).cuda() for a in feats)
    else:
        stacks = lambda t: build_pyramid_stacks_batched_cuda(
            f[:, t].contiguous(), cfg)
        lk = lk_pyramid_batched_cuda
        x, y, val = (torch.from_numpy(a).cuda() for a in feats)
    flat = lambda a: a.reshape(-1)
    state = AffineState.create(x.numel(), cfg, "cuda")
    st1 = stacks(0)
    for t in range(step + 1):
        st2 = stacks(t + 1)
        xn, yn, vn = lk(st1, st2, x, y, val, cfg)
        inputs = (st1[0], st2[0], flat(x), flat(y), flat(xn), flat(yn),
                  flat(vn))
        if t == step:
            before = AffineState(*(a.clone() for a in (
                state.valid, state.patches, state.x, state.y, state.axx,
                state.ayx, state.axy, state.ayy)))
            args = verification_inputs(state, st1[0], flat(x), flat(y),
                                       flat(xn), flat(yn), flat(vn), cfg)
            return before, inputs, (args[0], st2[0]) + args[1:]
        out = affine_step_cuda_(state, *inputs, cfg)
        x, y, val = (a.reshape(x.shape) for a in out[:3])
        st1 = st2


def affine_kernel_costs(cells, cfg, tag: str, card: str) -> None:
    """Device us per call of kernel F's two entries on the state at step
    AFFINE_STEP of each affine cell, and its lanes' iteration counts."""
    from chip_smoke import kernel_times
    from klt_tpu_torch.cuda.affine import affine_step_cuda_, track_affine_cuda
    from klt_tpu_torch.ops.affine import AffineState
    out = {}
    for name, frames, feats in cells:
        before, inputs, args = affine_state(frames, feats, cfg, AFFINE_STEP)
        active = args[7]
        iters = track_affine_cuda(*args, cfg)[4]
        hist = np.bincount(iters[active].cpu().numpy(),
                           minlength=cfg.affine_max_iterations + 1)
        reps = max(10, 2000 // frames.shape[0] // 10)
        t_ms = kernel_times(lambda: track_affine_cuda(*args, cfg), reps)[0]
        ring = iter([AffineState(*(a.clone() for a in (
            before.valid, before.patches, before.x, before.y, before.axx,
            before.ayx, before.axy, before.ayy)))
            for _ in range(2 * reps + 1)])
        s_ms = kernel_times(lambda: affine_step_cuda_(next(ring), *inputs,
                                                      cfg), reps)[0]
        del ring
        # one chain or the sum of the lanes: the track entry with every
        # lane capped at one iteration, and one 10-iteration lane alone
        one_it = dataclasses.replace(cfg, affine_max_iterations=1)
        c_ms = kernel_times(lambda: track_affine_cuda(*args, one_it),
                            reps)[0]
        longest = int((iters * active).argmax())
        alone = torch.zeros_like(active)
        alone[longest] = True
        lone = args[:7] + (alone,)
        l_ms = kernel_times(lambda: track_affine_cuda(*lone, cfg), reps)[0]
        out[name] = {"lanes": int(active.numel()),
                     "active": int(active.sum()),
                     "iterations": int(iters.sum()),
                     "iteration_histogram": hist.tolist(),
                     "track_entry_us": round(t_ms * 1e3, 2),
                     "step_entry_us": round(s_ms * 1e3, 2),
                     "track_entry_one_iteration_us": round(c_ms * 1e3, 2),
                     f"one_lane_of_{int(iters[longest])}_iterations_us":
                         round(l_ms * 1e3, 2)}
        torch.cuda.empty_cache()
    print(json.dumps({"tag": tag, "card": card, "step": AFFINE_STEP,
                      "kernel_F": out}), flush=True)


def affine_runs(args, tag: str, card: str) -> None:
    """The affine cells end to end, then kernel F alone on their states."""
    from klt_tpu_torch.runtime.pipeline import track_sequence_affine
    cells, cfg = affine_inputs()
    states = []
    for name, frames in cells:
        feats = features_of(frames, 2000, cfg)
        f = torch.from_numpy(frames).cuda()
        featd = [torch.from_numpy(a).cuda() for a in feats]
        if frames.shape[0] == 1:
            run = lambda: track_sequence_affine(f[0], *[a[0] for a in featd],
                                                cfg)
        else:
            from klt_tpu_torch.parallel import track_sequences_affine_batched
            run = lambda: track_sequences_affine_batched(f, *featd, cfg)
        measure(f"{name}, {int((feats[2] >= 0).sum())} live", run,
                frames.shape[1] - 1, frames.shape[0], args.reps, tag, card)
        states.append((name, frames, feats))
        del f, featd
        torch.cuda.empty_cache()
    affine_kernel_costs(states, cfg, tag, card)


EXACT_STEP = 50   # the step of the exact run whose state G, R are timed on


def exact_kernel_costs(f, table, cfg, tag: str, card: str) -> None:
    """Device us per call of kernels G, H2 at step EXACT_STEP of the
    exact run, and of R's tie entry (and kernel R on the same state) at the
    step from there on that refilled the most slots."""
    from chip_smoke import kernel_times
    from klt_tpu_torch.cuda.exact import exact_response_cuda, track_exact_cuda
    from klt_tpu_torch.cuda.pyramid import build_pyramid_stacks_cuda
    from klt_tpu_torch.cuda.replace import (replace_lost_cuda_,
                                            replace_lost_tie_cuda_)
    t = EXACT_STEP
    p1, p2 = (build_pyramid_stacks_cuda(f[i], cfg) for i in (t - 1, t))
    lanes = [a[t - 2] for a in table]
    us = lambda fn, reps, n=1: round(kernel_times(fn, reps, n)[0] * 1e3, 2)
    # R on the state before replacement at the step from t on that
    # refilled the most slots
    tr = t + int((table[2][t - 1:] > 0).sum(dim=1).argmax())
    q1, q2 = (build_pyramid_stacks_cuda(f[i], cfg) for i in (tr - 1, tr))
    pre = track_exact_cuda(q1, q2, *[a[tr - 2] for a in table], cfg)
    win = (cfg.window_width, cfg.window_height)
    resp = exact_response_cuda(q2[0][1], q2[0][2], *win)
    tie = torch.zeros(1, dtype=torch.int32, device=f.device)
    fresh = lambda: [a.clone() for a in pre]
    n_lost = int((pre[2] < 0).sum())
    worst = dataclasses.replace(cfg, min_displacement=0.0)
    out = {
        f"G 640x480, {int((lanes[2] >= 0).sum())} live lanes": us(
            lambda: track_exact_cuda(p1, p2, *lanes, cfg), 50),
        "G 640x480, min_displacement 0": us(
            lambda: track_exact_cuda(p1, p2, *lanes, worst), 20),
        "H2 640x480": us(lambda: exact_response_cuda(p2[0][1], p2[0][2],
                                                     *win), 200),
        f"R tie entry 640x480, step {tr}, {n_lost} of {len(pre[0])} lost, "
        "input copies included": us(lambda: replace_lost_tie_cuda_(resp, *fresh(), cfg,
                                                      tie), 100, 4),
        f"R 640x480 on the same state, input copies included": us(
            lambda: replace_lost_cuda_(resp, *fresh(), cfg), 100, 4),
        "the input copies": us(fresh, 100, 3)}
    print(json.dumps({"tag": tag, "card": card, "exact_step": t,
                      "device_us_per_call": out}), flush=True)


def exact_runs(args, tag: str, card: str, timed: bool = True) -> None:
    """The exact replace run (640x480, 500 features, 101 frames) end to
    end (unless not `timed`), then its kernels alone; a revision without
    it says so."""
    try:
        from klt_tpu_torch.runtime.pipeline import (
            track_sequence_replace_exact)
    except ImportError:
        print(json.dumps({"tag": tag, "card": card,
                          "exact": "not in this revision"}), flush=True)
        return
    cfg = klt.TrackingConfig(sequential_mode=True)
    frames = synthetic_frames(101, scale=2)
    f = torch.from_numpy(frames).cuda()
    feats = [torch.from_numpy(a).cuda() for a in select(frames[0], 500, cfg)]
    run = lambda: track_sequence_replace_exact(f, *feats, cfg)
    if timed:
        measure(f"track_sequence_replace_exact 640x480 x 500, "
                f"{int((feats[2] >= 0).sum())} live", run, len(frames) - 1,
                1, args.reps, tag, card)
    exact_kernel_costs(f, run(), cfg, tag, card)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="this")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--wrapper-only", action="store_true")
    ap.add_argument("--kernels-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_lk: no CUDA device", file=sys.stderr)
        return 1
    klt.set_verbosity(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = klt.TrackingConfig(sequential_mode=True)
    dev = lambda arrs: [torch.from_numpy(a).cuda() for a in arrs]
    if args.wrapper_only:
        wrapper_costs(cfg, args.tag, card)
        return 0
    if args.kernels_only:
        kernel_costs(cfg, args.tag, card)
        exact_runs(args, args.tag, card, timed=False)
        return 0

    qvga = synthetic_frames(10)
    vga = synthetic_frames(101, scale=2)
    for name, frames, n, seq in (
            ("track_sequence 320x240 x 150", qvga, 150, track_sequence),
            ("track_sequence 640x480 x 2000 requested", vga, 2000,
             track_sequence),
            ("track_sequence_replace 640x480 x 500", vga, 500,
             track_sequence_replace)):
        f = torch.from_numpy(frames).cuda()
        feats = dev(select(frames[0], n, cfg))
        measure(f"{name}, {int((feats[2] >= 0).sum())} live", lambda: seq(
            f, *feats, cfg), len(frames) - 1, 1, args.reps, args.tag, card)

    for name, (b, t), scale, n in (
            ("track_sequences_batched 32 x 320x240 x 150", (32, 10), 1, 150),
            ("track_sequences_batched 3 x 640x480 x 4096 requested", (3, 10),
             2, 4096)):
        frames = batched_frames(b, t, scale=scale)
        feats = [np.stack(a) for a in zip(*[select(frames[i, 0], n, cfg)
                                            for i in range(b)])]
        f = torch.from_numpy(frames).cuda()
        featd = dev(feats)
        measure(f"{name}, {int((feats[2] >= 0).sum())} live",
                lambda: track_sequences_batched(f, *featd, cfg), t - 1, b,
                args.reps, args.tag, card)
    kernel_costs(cfg, args.tag, card)
    affine_runs(args, args.tag, card)
    exact_runs(args, args.tag, card)
    wrapper_costs(cfg, args.tag, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
