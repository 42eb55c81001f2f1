"""Times of the kernels inside the sequence entry points, on one GPU.

    python3 -m klt_tpu_torch.bench_lk [--tag NAME] [--reps N]
                                      [--wrapper-only] [--kernels-only]
                                      [--graphs [--graph-k K,K,..]]
                                      [--tracker] [--slam]

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

--graphs times the whole-sequence programs (cuda/graph.py) against the
eager step loops they replaced (`_run_eager`, `_replace_exact_eager`) on
the six cells of PERF.md section 5: `track_sequence` 640x480 x 2000
requested over 101 frames, the replace run 640x480 x 500 over 551, the
batched flagship 32 x 320x240 x 150, the affine run 640x480 x 2000
requested over 100 affine frames, the batched affine run 8 x 640x480 over
101, the exact run 640x480 x 500 over 101.  In one process, in turns
eager, graphs, graphs, eager, --reps runs each: one JSON line per cell
with the wall per step and frames/s of every run (host clock around
synchronised runs), device time per step and busy share from one profiled
run of each, and the capture and instantiation time of the cell's key
(its first call, cache emptied).  --graph-k 8,16,32 repeats the cells with
each chunk length K (cuda/graph.py's constant, set for the measurement).

--tracker times KLTracker's step programs (runtime/tracker.py) and
track_pair_carry's graph against their eager bodies
(`KLTracker._track_features_eager`, `pipeline._track_pair_carry_eager`)
on the cells of PERF.md section 5: `track_features` 640x480 x 2000
requested in sequential mode over 101 frames; the reference loop with
replacement (`track_features` + `replace_lost_features`) at 640x480 x 500;
the affine check (mode 2, 640x480 x 2000 requested, 4 levels of
subsampling 2, 101 `affine_frames`); the flagship 320x240 x 150 in
non-sequential mode over 10 frames; `track_pair_carry` 640x480 x 2000
requested (a sync after every call).  In one process, in turns eager,
graphs, copy, copy, graphs, eager (copy: the carried pyramid in one slot,
image 2's copied into it, `copy_carry_step`; only where a pyramid is
carried), --reps runs each with a new tracker: one JSON line per cell
with the wall of each steady call (host clock; the call ends in the
features' copy to the host), median, min, p90, max; the frame's wall with
replacement; kernel launches per call; from one profiled run of each
mode the device time and device launches per call, the host time of the
CUDA runtime calls and the busy share (device time / median wall); and
the capture and instantiation ms of each program (key) made.

--slam times the SLAM solvers' programs (slam/solvers.py::LMSolve: CUDA
graphs of each LM iteration's steps, CG's stop flag read after every
chunk of CG_CHECK_EVERY masked iterations; design (a)) against their
eager bodies and against design (b) (`fused_cg`: the whole LM iteration
one graph, CG run to cg_iters masked, no host read) on chip_smoke.py
phase 37's three solves: bundle_adjust_cg at 200 x 20,000 x 4
(cg_iters 120), optimize_pose_graph(solver="cg") at 800 keyframes
(cg_iters 400), bundle_adjust_gated at 30 x 2,000 with 40% spikes (3
rounds of 10).  In one process, in turns eager, (a), (b), (b), (a),
eager (the gated BA too), --reps runs each: one JSON line per solve with
the wall of the whole solve per LM iteration (host clock around a
synchronised solve: its first iteration, eager, and the captures
included) and of each steady LM iteration (replays only: the
iterations after the second, which captures; each timed with the card
synchronised before and after), median and range; from one profiled solve of two LM iterations the device time
and device launches per LM iteration; from a profile of two replayed LM
iterations (`device_idle`) the device's idle time between its events,
in gaps under 10 us and longer ones; host syncs per LM iteration over a
whole solve; busy share (device time / median steady iteration); the
capture and instantiation ms of every graph; and whether the outputs
equal the eager body's bit for bit.  Then phase 36's back end (the front
end run on the 1003 laptops-width frames, 1000 features, keyframes
evenly spaced) in turns eager, graphs, graphs, eager: the seconds of the
pose graph's build, its optimization and the gated BA.

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
import contextlib
import dataclasses
import functools
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


def graph_cells(cfg):
    """The six cells of PERF.md section 5: (name, graphed run, eager run,
    steps, frames a step), inputs on the card."""
    from chip_smoke import (affine_config, batched_affine_frames,
                            batched_features, affine_frames)
    from klt_tpu_torch.parallel import (batched_affine, batched_lk,
                                        track_sequences_affine_batched)
    from klt_tpu_torch.runtime import pipeline
    acfg = affine_config()
    cells = []
    for name, frames, n, c, kw in (
            ("track_sequence 640x480 x 2000 requested",
             synthetic_frames(101, scale=2), 2000, cfg, {}),
            ("track_sequence_replace 640x480 x 500",
             synthetic_frames(551, scale=2), 500, cfg, {"replace": True}),
            ("track_sequence_affine 640x480 x 2000 requested",
             affine_frames(100, scale=2), 2000, acfg, {"affine": True})):
        f = torch.from_numpy(frames).cuda()
        feats = [torch.from_numpy(a).cuda() for a in select(frames[0], n, c)]
        seq = (pipeline.track_sequence_replace if kw.get("replace") else
               pipeline.track_sequence_affine if kw.get("affine") else
               track_sequence)
        cells.append((f"{name}, {int((feats[2] >= 0).sum())} live",
                      functools.partial(seq, f, *feats, c),
                      functools.partial(pipeline._run_eager, f, *feats, c,
                                        False, False, **kw),
                      len(frames) - 1, 1))
    for name, frames, n, c, seq, eager in (
            ("track_sequences_batched 32 x 320x240 x 150",
             batched_frames(32, 10), 150, cfg, track_sequences_batched,
             batched_lk._run_eager),
            ("track_sequences_affine_batched 8 x 640x480 x 2000 requested",
             batched_affine_frames(8, 101, scale=2), 2000, acfg,
             track_sequences_affine_batched, batched_affine._run_eager)):
        feats = batched_features(frames, n, c)
        f = torch.from_numpy(frames).cuda()
        featd = [torch.from_numpy(a).cuda() for a in feats]
        cells.append((f"{name}, {int((feats[2] >= 0).sum())} live",
                      functools.partial(seq, f, *featd, c),
                      functools.partial(eager, f, *featd, c),
                      frames.shape[1] - 1, frames.shape[0]))
    frames = synthetic_frames(101, scale=2)
    f = torch.from_numpy(frames).cuda()
    feats = [torch.from_numpy(a).cuda() for a in select(frames[0], 500, cfg)]
    cells.append(("track_sequence_replace_exact 640x480 x 500",
                  functools.partial(pipeline.track_sequence_replace_exact, f,
                                    *feats, cfg),
                  functools.partial(pipeline._replace_exact_eager, f,
                                    *feats, cfg), len(frames) - 1, 1))
    return cells


def graph_runs(args, tag: str, card: str) -> None:
    """The graphed entries against their eager loops, in turns."""
    from klt_tpu_torch.cuda import graph
    cells = graph_cells(klt.TrackingConfig(sequential_mode=True))
    k0 = graph.K
    try:
        _graph_sweep(args, cells, tag, card)
    finally:
        graph.K = k0
        graph._clear()


def _graph_sweep(args, cells, tag: str, card: str) -> None:
    from klt_tpu_torch.cuda import graph
    for k in args.graph_k:
        graph.K = k
        for name, graphed, eager, steps, per in cells:
            graph._clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graphed()
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            progs = [p for _, p in graph.programs()]
            walls = {"eager": [], "graphs": []}
            for mode in ("eager", "graphs", "graphs", "eager"):
                run = graphed if mode == "graphs" else eager
                run()
                torch.cuda.synchronize()
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    walls[mode].append(time.perf_counter() - t0)
            out = {"tag": tag, "card": card, "K": k, "cell": name,
                   "steps": steps,
                   "capture_ms": 1e3 * sum(p.capture_seconds()
                                           for p in progs),
                   "n_graphs": sum(len(p.graphs) for p in progs),
                   "first_call_ms": first * 1e3}
            for mode, run in (("eager", eager), ("graphs", graphed)):
                w = sorted(walls[mode])
                prof = profile(run, steps)
                dev_us = prof["lk_device_us_per_step"] + \
                    prof["other_device_us_per_step"]
                out[mode] = {
                    "wall_us_per_step": [round(v * 1e6 / steps, 1)
                                         for v in w],
                    "frames_per_s": [round(steps * per / v, 1)
                                     for v in w[::-1]],
                    "device_us_per_step": dev_us,
                    "busy_share_profiled":
                        prof["device_busy_share_profiled"],
                    "busy_share": dev_us / (float(np.median(w)) * 1e6 /
                                            steps),
                    "launches_per_step": prof["lk_launches_per_step"] +
                        prof["other_launches_per_step"]}
            print(json.dumps(out), flush=True)


# ------------------------------------------------------------------ #
# --tracker: KLTracker's step programs and track_pair_carry's against   #
# their eager bodies                                                    #
# ------------------------------------------------------------------ #

def tracker_cells():
    """PERF.md section 5's KLTracker cells: (name, frames, features
    requested, cfg, replace every frame)."""
    from chip_smoke import affine_config, affine_frames
    cfg = klt.TrackingConfig(sequential_mode=True)
    vga = synthetic_frames(101, scale=2)
    return [
        ("track_features 640x480 x 2000 requested, sequential", vga, 2000,
         cfg, False),
        ("track_features + replace_lost_features 640x480 x 500", vga, 500,
         cfg, True),
        ("track_features, affine mode 2, 640x480 x 2000 requested, 4 "
         "levels of subsampling 2", affine_frames(101, scale=2), 2000,
         affine_config(), False),
        ("track_features 320x240 x 150, non-sequential",
         synthetic_frames(10), 150, klt.TrackingConfig(), False)]


def copy_carry_step(b, cfg, state, src):
    """The carry PERF.md section 5 measured against the two parity slots:
    one slot, image 2's pyramid built anew and copied into it (one copy a
    level) after the step."""
    from klt_tpu_torch.ops.affine import affine_consistency_step
    from klt_tpu_torch.ops.lk import track_features_pyramid_stacks
    from klt_tpu_torch.ops.pyramid import build_pyramid_stacks
    x, y = (b.feats[i].view(torch.float32) for i in (0, 1))
    val = b.feats[2]
    pyr1 = build_pyramid_stacks(b.frames[0], cfg) if src is None \
        else b.slots[0]
    pyr2 = build_pyramid_stacks(b.frames[1], cfg)
    xn, yn, vn = track_features_pyramid_stacks(pyr1, pyr2, x, y, val, cfg)
    if state is not None:
        xn, yn, vn = affine_consistency_step(state, pyr1[0], pyr2[0], x, y,
                                             val, xn, yn, vn, cfg)
    torch.stack([xn.view(torch.int32), yn.view(torch.int32), vn],
                out=b.out)
    for dst, st in zip(b.slots[0], pyr2):
        dst.copy_(st)


class _CopyCarry(klt.KLTracker):
    """KLTracker with copy_carry_step for its step programs."""

    def track_features(self, img1, img2, fl):
        from klt_tpu_torch.runtime import tracker
        saved = tracker._track_step, tracker._carry_slot
        tracker._track_step = copy_carry_step
        tracker._carry_slot = lambda src: 0
        try:
            super().track_features(img1, img2, fl)
        finally:
            tracker._track_step, tracker._carry_slot = saved


def tracker_profile(run, calls: int) -> dict:
    """From one torch.profiler run of run() (`calls` calls): device us and
    device launches per call, and the host us per call of each CUDA
    runtime call."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = dev_n = 0.0
    host = {}
    for ev in prof.key_averages():
        if "CUDA" in str(ev.device_type):
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            if us > 0:
                dev_us += us
                dev_n += ev.count
        elif ev.key.startswith("cuda"):
            host[ev.key] = round(ev.self_cpu_time_total / calls, 1)
    return {"device_us_per_call": dev_us / calls,
            "device_launches_per_call": dev_n / calls,
            "wall_us_per_call_profiled": wall * 1e6 / calls,
            "host_us_per_call_cuda_api": dict(sorted(
                host.items(), key=lambda kv: -kv[1])[:6])}


def tracker_flow(frames, start, cfg, replace: bool, mode: str,
                 warm: int, profiled: bool = False) -> dict:
    """One flow over the frames with a new tracker (mode: "eager" the
    eager body, "graphs" track_features, "copy" _CopyCarry's): the host
    seconds of each steady tracking call (after the first `warm`) and of
    its frame with replacement, the kernel launches per steady call, the
    capture seconds of each program; with profiled, tracker_profile over
    the steady calls instead of times."""
    from klt_tpu_torch import cuda
    tr = (_CopyCarry if mode == "copy" else klt.KLTracker)(cfg)
    track = tr._track_features_eager if mode == "eager" \
        else tr.track_features
    fl = start.copy()
    secs, frame_secs = [], []

    def step(i):
        t0 = time.perf_counter()
        track(frames[i - 1], frames[i], fl)
        t1 = time.perf_counter()
        if replace:
            tr.replace_lost_features(frames[i], fl)
        secs.append(t1 - t0)
        frame_secs.append(time.perf_counter() - t0)
    for i in range(1, warm + 1):
        step(i)
    calls = len(frames) - 1 - warm
    steady = lambda: [step(i) for i in range(warm + 1, len(frames))]
    if profiled:
        return tracker_profile(steady, calls)
    secs.clear()
    frame_secs.clear()
    before = {k.symbol: k.launches for k in cuda.KERNELS}
    steady()
    torch.cuda.synchronize()
    launches = {k.symbol: round((k.launches - before[k.symbol]) / calls, 3)
                for k in cuda.KERNELS if k.launches != before[k.symbol]}
    progs = [p for _, ps in tr._steps.values() for p in ps.values()]
    return {"secs": secs, "frame_secs": frame_secs, "launches": launches,
            "capture_ms": [round(p.capture_seconds() * 1e3, 2)
                           for p in progs if p.graphs],
            "final": [a.tobytes() for a in (fl.x, fl.y, fl.val)]}


def pair_carry_flow(frames, feats, cfg, mode: str, warm: int,
                    profiled: bool = False) -> dict:
    """track_pair_carry (mode "graphs", its cache emptied first) or the
    eager body over the frames on the card, a sync after every call: the
    host seconds of the steady calls, their launches per call, the key's
    capture seconds."""
    from klt_tpu_torch import cuda
    from klt_tpu_torch.cuda import graph
    from klt_tpu_torch.runtime import pipeline
    graph._clear()
    fn = pipeline.track_pair_carry if mode == "graphs" \
        else pipeline._track_pair_carry_eager
    state = pipeline.prepare_pyramids(frames[0], cfg)
    secs = []
    carry = [feats, state]

    def step(i):
        t0 = time.perf_counter()
        carry[:] = fn(carry[1], frames[i], carry[0], cfg)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    for i in range(1, warm + 1):
        step(i)
    calls = len(frames) - 1 - warm
    steady = lambda: [step(i) for i in range(warm + 1, len(frames))]
    if profiled:
        return tracker_profile(steady, calls)
    secs.clear()
    before = {k.symbol: k.launches for k in cuda.KERNELS}
    steady()
    launches = {k.symbol: round((k.launches - before[k.symbol]) / calls, 3)
                for k in cuda.KERNELS if k.launches != before[k.symbol]}
    progs = [p for k, p in graph.programs() if k[0] == "pair_carry"]
    return {"secs": secs, "frame_secs": secs, "launches": launches,
            "capture_ms": [round(p.capture_seconds() * 1e3, 2)
                           for p in progs if p.graphs],
            "final": [a.cpu().numpy().tobytes() for a in carry[0]]}


def tracker_runs(args, tag: str, card: str) -> None:
    """KLTracker's cells and track_pair_carry's, eager body against graphs
    (and, where a pyramid is carried, the copy carry), in turns eager,
    graphs, copy, copy, graphs, eager: one JSON line a cell."""
    # the calls before the steady ones: a pair, each parity's first call
    # (the warm-ups) and its second (the captures); without a carried
    # pyramid the pair's first and second
    cells = [(name, frames, select(frames[0], n, cfg), cfg, replace,
              5 if cfg.sequential_mode else 2, "tracker")
             for name, frames, n, cfg, replace in tracker_cells()]
    vga = synthetic_frames(101, scale=2)
    cfg = klt.TrackingConfig(sequential_mode=True)
    feats = [torch.from_numpy(a).cuda() for a in select(vga[0], 2000, cfg)]
    cells.append(("track_pair_carry 640x480 x 2000 requested",
                  torch.from_numpy(vga).cuda(), feats, cfg, False, 2,
                  "pair"))
    for name, frames, start, cfg, replace, warm, kind in cells:
        if kind == "pair":
            flow = functools.partial(pair_carry_flow, frames, start, cfg)
            modes = ("eager", "graphs", "graphs", "eager")
        else:
            fl = klt.FeatureList(*start)
            flow = lambda mode, warm, **kw: tracker_flow(
                frames, fl, cfg, replace, mode, warm, **kw)
            modes = ("eager", "graphs", "copy", "copy", "graphs", "eager") \
                if cfg.sequential_mode else ("eager", "graphs", "graphs",
                                             "eager")
        flow("graphs", warm)    # the kernels loaded, the allocator warm
        runs, finals = {}, []
        for mode in modes:
            for _ in range(args.reps):
                r = flow(mode, warm)
                finals.append(r["final"])
                prev = runs.setdefault(mode, {"secs": [], "frame_secs": [],
                                              "launches": r["launches"],
                                              "capture_ms": r["capture_ms"]})
                prev["secs"] += r["secs"]
                prev["frame_secs"] += r["frame_secs"]
        out = {"tag": tag, "card": card, "cell": name,
               "live": int((np.asarray(start[2].cpu() if kind == "pair"
                                       else start[2]) >= 0).sum()),
               "steady_calls_a_run": len(frames) - 1 - warm,
               "runs": 2 * args.reps,
               "last_features_equal_in_every_run": all(
                   f == finals[0] for f in finals)}
        for mode, r in runs.items():
            w = np.asarray(r["secs"]) * 1e6
            fw = np.asarray(r["frame_secs"]) * 1e6
            prof = flow(mode, warm, profiled=True)
            med = float(np.median(w))
            out[mode] = {
                "wall_us_per_call": {"median": med, "min": float(w.min()),
                                     "p90": float(np.percentile(w, 90)),
                                     "max": float(w.max())},
                "frame_wall_us_median": float(np.median(fw)),
                "kernel_launches_per_call": r["launches"],
                "busy_share": prof["device_us_per_call"] / med,
                "capture_ms": r["capture_ms"], **prof}
        print(json.dumps(out), flush=True)


@contextlib.contextmanager
def fused_cg(made: list):
    """Design (b) of CG's stop rule for the CG solves inside: each LM
    iteration one program (the linearization, all cg_iters CG iterations
    masked, no host read, the update) in place of the solvers' own
    design (a).  An iteration past CG's stop changes nothing, so the
    results are the same bits.  `made` collects the fused programs."""
    from klt_tpu_torch.slam import solvers
    own = solvers.LMSolve.iteration

    def iteration(self, eager):
        if self.cg is None:
            return own(self, eager)
        prog = self.__dict__.get("fused")
        if prog is None:
            prog = self.fused = self.program(lambda: (
                self._linearize(), self.cg.chunk(self.cg.cg_iters),
                self._update()))
            made.append(prog)
        prog.run(1, warm_up=eager)
    solvers.LMSolve.iteration = iteration
    try:
        yield
    finally:
        solvers.LMSolve.iteration = own


@contextlib.contextmanager
def timed_iterations(walls: list):
    """Each LM iteration of the solves inside timed on the host clock,
    the card synchronised before and after (seconds into walls)."""
    from klt_tpu_torch.slam import solvers
    inner = solvers.LMSolve.iteration

    def iteration(self, eager):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner(self, eager)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    solvers.LMSolve.iteration = iteration
    try:
        yield
    finally:
        solvers.LMSolve.iteration = inner


@contextlib.contextmanager
def marked_iteration(first: int):
    """A marker kernel (utils/profiling.py) before the LM iteration of
    index `first` of the solves inside."""
    from klt_tpu_torch.slam import solvers
    from klt_tpu_torch.utils import profiling
    inner = solvers.LMSolve.iteration
    count = [0]

    def iteration(self, eager):
        if count[0] == first:
            profiling.marker()
        count[0] += 1
        inner(self, eager)
    solvers.LMSolve.iteration = iteration
    try:
        yield
    finally:
        solvers.LMSolve.iteration = inner


def slam_solve(kind: str, x, mode: str, iterations: int, rounds: int,
               made: list, *hooks):
    """One of phase 37's solves in a mode ("eager", "graphs", "fused"),
    the fused programs into made, inside the context managers hooks."""
    from chip_smoke import scale_solve
    with contextlib.ExitStack() as stack:
        if mode == "fused":
            stack.enter_context(fused_cg(made))
        for hook in hooks:
            stack.enter_context(hook)
        return scale_solve(kind, x, mode == "eager", iterations, rounds)


def device_idle(kind: str, x, mode: str, iterations: int = 4,
                read_from: int = 2) -> dict:
    """From a profile of a graphed solve of `iterations` LM iterations
    (one round), over its iterations from index read_from on (replays
    only): the device's busy time and its idle time between consecutive
    device events, per LM iteration, split into gaps under 10 us (between
    a graph's nodes) and longer ones (round trips through the host), with
    their count."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    from klt_tpu_torch.utils import profiling
    with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
        slam_solve(kind, x, mode, 1, 1, [])   # not read
        slam_solve(kind, x, mode, iterations, 1, [],
                   marked_iteration(read_from))
        torch.cuda.synchronize()
        profiling.close_window()
    ev = sorted((e for e in prof.events() if "CUDA" in str(e.device_type)),
                key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(ev) if "spin_kernel" in e.name]
    if len(marks) != 2:
        return {"markers": len(marks)}
    window = ev[marks[0] + 1:marks[1]]
    gaps = [max(0.0, b.time_range.start - a.time_range.end)
            for a, b in zip(window, window[1:])]
    n = iterations - read_from
    large = [g for g in gaps if g >= 10.0]
    return {"busy_ms": sum(e.time_range.elapsed_us() for e in window)
            / 1e3 / n,
            "gaps_under_10us_ms": sum(g for g in gaps if g < 10.0) / 1e3 / n,
            "gaps_from_10us_ms": sum(large) / 1e3 / n,
            "gaps_from_10us": len(large) / n}


def slam_front_end():
    """Phase 36's back end inputs: the front end over the 1003 laptops
    frames (track_sequence_replace with precomp, 1000 features), its
    table's chains and 5 evenly spaced keyframes."""
    from chip_smoke import SLAM_FRAMES, TRAFFIC_FRAMES
    from klt_tpu_torch.examples.slam_pipeline import keyframe_observations
    traffic = synthetic_frames(TRAFFIC_FRAMES, scale=2)
    frames = np.concatenate([traffic, synthetic_frames(
        SLAM_FRAMES, scale=2, start=len(traffic))])
    cfg = klt.TrackingConfig(sequential_mode=True)
    fl = klt.FeatureList.create(1000)
    klt.KLTracker(cfg).select_good_features(frames[0], fl)
    out = track_sequence_replace(
        torch.from_numpy(frames).cuda(),
        *[torch.from_numpy(a).cuda() for a in (fl.x, fl.y, fl.val)], cfg,
        precomp=True)
    xs, ys, vs = (a.cpu().numpy() for a in out)
    table = klt.FeatureTable.create(len(frames), 1000)
    table.store_list(fl, 0)
    table.x[:, 1:], table.y[:, 1:], table.val[:, 1:] = xs.T, ys.T, vs.T
    return keyframe_observations(table), frames.shape[1:]


def slam_runs(args, tag: str, card: str) -> None:
    """The solvers' programs against their eager bodies and design (b),
    then phase 36's back end, eager against graphs: one JSON line a
    cell."""
    from chip_smoke import (back_ends_bit_equal, bits_equal, count_syncs,
                            graph_captures, made_solves, profile_device,
                            scale_cells, slam_back_end, solve_bits)
    for kind, (name, x, iterations, rounds) in scale_cells().items():
        its = iterations * rounds
        modes = ("eager", "graphs", "fused", "fused", "graphs", "eager")
        runs = {m: {"solve": [], "steady": [], "captures": []}
                for m in modes}
        ref = None
        slam_solve(kind, x, "graphs", iterations, rounds, [])   # warm
        for mode in modes:
            for _ in range(args.reps):
                fused = []
                with made_solves() as made:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = solve_bits(slam_solve(kind, x, mode, iterations,
                                                rounds, fused))
                    torch.cuda.synchronize()
                runs[mode]["solve"].append(time.perf_counter() - t0)
                if mode == "graphs":
                    runs[mode]["captures"] = graph_captures(made[-1])
                elif mode == "fused":
                    runs[mode]["captures"] = [
                        round(g.seconds * 1e3, 1) for p in fused
                        for g in p.graphs.values()]
                if ref is None:
                    ref = out
                runs[mode].setdefault("same", True)
                runs[mode]["same"] &= all(bits_equal(a, b)
                                          for a, b in zip(out, ref))
                if mode != "eager":
                    walls = []
                    slam_solve(kind, x, mode, iterations, rounds, [],
                               timed_iterations(walls))
                    runs[mode]["steady"] += walls[2:]
        cell = {"tag": tag, "card": card, "cell": name,
                "lm_iterations": its, "runs": 2 * args.reps}
        for mode, r in runs.items():
            w = np.asarray(r["solve"]) * 1e3 / its
            steady = np.asarray(r["steady"] or r["solve"]) * 1e3 / \
                (1 if r["steady"] else its)
            dev = profile_device(
                lambda: slam_solve(kind, x, mode, 2, 1, []), 2, tag,
                f"{name}, {mode}", {}, host=False) or {}
            syncs = count_syncs(lambda: slam_solve(kind, x, mode,
                                                   iterations, rounds, []))
            med = float(np.median(steady))
            cell[mode] = {
                "solve_ms_per_lm_iteration": {
                    "median": float(np.median(w)), "min": float(w.min()),
                    "max": float(w.max())},
                "steady_lm_iteration_ms": {
                    "median": med, "min": float(steady.min()),
                    "max": float(steady.max()), "n": len(steady)},
                "device_ms_per_lm_iteration": dev.get("device_us", 0) / 1e3,
                "device_launches_per_lm_iteration": dev.get("launches"),
                "host_syncs_per_lm_iteration": syncs / its,
                "busy_share": dev.get("device_us", 0) / 1e3 / med,
                "capture_ms": r["captures"],
                "bit_equal_to_first_eager_run": r["same"]}
            if mode != "eager":
                cell[mode]["device_idle_per_lm_iteration"] = device_idle(
                    kind, x, mode)
        print(json.dumps(cell), flush=True)

    obs, shape = slam_front_end()
    secs = {"eager": [], "graphs": []}
    first = None
    for mode in ("eager", "graphs", "graphs", "eager"):
        for _ in range(args.reps):
            r = slam_back_end(obs, shape, "cuda", eager=mode == "eager")
            first = first or r
            secs[mode].append(r["secs"] + [back_ends_bit_equal(r, first)])
    print(json.dumps({
        "tag": tag, "card": card,
        "cell": "SLAM back end (phase 36: 5 keyframes, 1000 features, "
                "1003 frames of 640x480)",
        "seconds_build_optimize_gated_equal": secs}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="this")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--wrapper-only", action="store_true")
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--graphs", action="store_true")
    ap.add_argument("--tracker", action="store_true")
    ap.add_argument("--slam", action="store_true")
    ap.add_argument("--graph-k", default="",
                    type=lambda v: [int(k) for k in v.split(",") if k])
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
    if args.tracker:
        tracker_runs(args, args.tag, card)
        return 0
    if args.slam:
        slam_runs(args, args.tag, card)
        return 0
    if args.graphs:
        from klt_tpu_torch.cuda import graph
        args.graph_k = args.graph_k or [graph.K]
        graph_runs(args, args.tag, card)
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
