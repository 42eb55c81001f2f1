"""Chip smoke run of klt_tpu_torch on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Builds the CUDA kernels from klt_tpu_torch/csrc, holds each against its
plain torch version on the card, then drives the port's main path (the
reference's example3 flow: select features on frame 0, track them in
sequential mode, write the feature table) at 320x240 with 150 features
and at 640x480 with 2000 features, checks the tracks against the known
motion of the synthetic frames, and times kernels and sequences.  Every
check raises on failure; the exit code is then non-zero and no result
line is printed.  Without a CUDA device the script fails: it never runs
on the CPU.

The frames are synthetic: the 240x320 scene crop in
tests/fixtures/smoothed_img0.f32 (upsampled 2x for 640x480), translated
with bilinear interpolation by a known sub-pixel path per frame and
quantized to u8.  When KLT_IMAGES_PROVIDED names a directory holding the
reference's images_provided sequence (img0.pgm .. img9.pgm), the 320x240
flagship phase tracks those frames instead; their motion is unknown, so
that phase then checks them against the CPU run alone.

Prints, before its last line, one JSON object with every kernel's
launches on the main path, its error against the plain version and
both times; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import klt_tpu_torch as klt
from klt_tpu_torch import cuda
from klt_tpu_torch.config import pyramid_shapes
from klt_tpu_torch.cuda.lk_level import lk_level_cuda
from klt_tpu_torch.cuda.pyramid import build_pyramid_stacks_cuda
from klt_tpu_torch.io.pnm import read_pgm
from klt_tpu_torch.ops.lk import lk_level_plain
from klt_tpu_torch.ops.pyramid import build_pyramid_stacks_plain
from klt_tpu_torch.runtime.pipeline import track_sequence

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "tests", "fixtures", "smoothed_img0.f32")


# ------------------------------------------------------------------ #
# synthetic frames                                                     #
# ------------------------------------------------------------------ #

def shift(k: int) -> tuple[float, float]:
    """Known (tx, ty) displacement of frame k from frame 0, in pixels:
    within +-4 px so features stay in view."""
    return 3.2 * math.sin(0.3 * k), 2.1 * math.sin(0.23 * k)


def bilinear_warp(img: np.ndarray, src_x: np.ndarray,
                  src_y: np.ndarray) -> np.ndarray:
    """img sampled bilinearly at (src_x, src_y), edge-clamped (f64)."""
    h, w = img.shape
    sx = np.clip(src_x, 0.0, w - 1.0)
    sy = np.clip(src_y, 0.0, h - 1.0)
    x0 = np.minimum(np.floor(sx).astype(np.int64), w - 2)
    y0 = np.minimum(np.floor(sy).astype(np.int64), h - 2)
    fx = sx - x0
    fy = sy - y0
    im = img.astype(np.float64)
    return ((1 - fx) * (1 - fy) * im[y0, x0] + fx * (1 - fy) * im[y0, x0 + 1]
            + (1 - fx) * fy * im[y0 + 1, x0] + fx * fy * im[y0 + 1, x0 + 1])


def synthetic_frames(n_frames: int, scale: int = 1) -> np.ndarray:
    """uint8 [T, 240*scale, 320*scale]: frame k is the fixture scene
    (upsampled by `scale`) translated by shift(k)."""
    base = np.fromfile(FIXTURE, dtype=np.float32).reshape(240, 320)
    h, w = 240 * scale, 320 * scale
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    if scale != 1:
        base = bilinear_warp(base, xx / scale, yy / scale)
    frames = np.empty((n_frames, h, w), np.uint8)
    for k in range(n_frames):
        tx, ty = shift(k)
        frames[k] = np.clip(np.rint(bilinear_warp(base, xx - tx, yy - ty)),
                            0, 255).astype(np.uint8)
    return frames


def provided_frames():
    """The reference's images_provided frames, if KLT_IMAGES_PROVIDED
    names their directory; else None."""
    d = os.environ.get("KLT_IMAGES_PROVIDED", "")
    if not d or not os.path.isdir(d):
        return None
    return np.stack([read_pgm(os.path.join(d, f"img{i}.pgm"))
                     for i in range(10)])


# ------------------------------------------------------------------ #
# checks and timing                                                    #
# ------------------------------------------------------------------ #

class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    """name, power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over reps runs (CUDA
    events), after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sequence_fps(frames, feats, cfg, plain: bool, reps: int) -> list[float]:
    """Frames/s of track_sequence, host clock around synchronised runs,
    after one warm-up run."""
    run = lambda: track_sequence(frames, *feats, cfg, plain=plain)
    run()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append((frames.shape[0] - 1) / (time.perf_counter() - t0))
    return out


# ------------------------------------------------------------------ #
# phases                                                               #
# ------------------------------------------------------------------ #

def phase_build(card: str) -> None:
    print(f"[1 build] card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    cuda.load_library()
    if cuda.build_seconds is None:
        print("[1 build] libklt_kernels.so up to date, not rebuilt")
    else:
        print(f"[1 build] nvcc build of {len(cuda.SOURCES)} sources: "
              f"{cuda.build_seconds:.2f} s")
    for line in cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[1 build] ptxas: {line.strip()}")


def phase_pyramid(frames_by_size, cfg, errs) -> None:
    for frames in frames_by_size:
        img = torch.from_numpy(frames[1]).cuda()
        got = build_pyramid_stacks_cuda(img, cfg)
        ref = build_pyramid_stacks_plain(img, cfg)
        torch.cuda.synchronize()
        for lvl, (a, b) in enumerate(zip(got, ref)):
            check(a.shape == b.shape,
                  f"level {lvl} shape {a.shape} vs {b.shape}")
            diffs = [(a[c] - b[c]).abs().max().item() for c in range(3)]
            check(all(math.isfinite(v) for v in diffs) and
                  torch.isfinite(a).all().item(), "non-finite pyramid")
            errs.append(max(diffs))
            print(f"[2 kernel A] {frames.shape[2]}x{frames.shape[1]} level "
                  f"{lvl} {tuple(a.shape)}: max |kernel - plain| intensity "
                  f"{diffs[0]:.3g}, gradx {diffs[1]:.3g}, "
                  f"grady {diffs[2]:.3g}")
            check(max(diffs) <= 1e-3, f"kernel A differs from plain by "
                  f"{max(diffs)} at level {lvl}")


def level_inputs(fl, cfg, r):
    """Kernel B inputs at level r: selected features scaled down by
    repeated division, guess = start."""
    x = torch.from_numpy(fl.x).cuda()
    y = torch.from_numpy(fl.y).cuda()
    s = float(np.float32(cfg.subsampling))
    for _ in range(r):
        x, y = x / s, y / s
    return x, y, x.clone(), y.clone(), torch.from_numpy(fl.val >= 0).cuda()


def phase_lk(frames_by_size, cfgs, n_feats, errs) -> None:
    for frames, n in zip(frames_by_size, n_feats):
        for cfg in cfgs:
            fl = klt.FeatureList.create(n)
            klt.KLTracker(cfg).select_good_features(frames[0], fl)
            st1, st2 = (build_pyramid_stacks_cuda(
                torch.from_numpy(f).cuda(), cfg) for f in frames[:2])
            for r in range(cfg.n_pyramid_levels):
                args = (st1[r], st2[r], *level_inputs(fl, cfg, r), cfg,
                        r == 0)
                got = lk_level_cuda(*args)
                ref = lk_level_plain(*args)
                torch.cuda.synchronize()
                act = args[6]
                same = (got[2] == ref[2]) & act
                agree = same.sum().item() / max(act.sum().item(), 1)
                dpos = torch.maximum((got[0] - ref[0]).abs(),
                                     (got[1] - ref[1]).abs())[same]
                dmax = dpos.max().item() if dpos.numel() else 0.0
                dres = (got[4] - ref[4]).abs()[same].max().item() \
                    if dpos.numel() else 0.0
                errs.append(dmax)
                tag = "lighting" if cfg.lighting_insensitive else "default"
                print(f"[3 kernel B] {frames.shape[2]}x{frames.shape[1]} "
                      f"{tag} level {r}: {int(act.sum())} features, status "
                      f"agreement {agree:.4f}, max |dpos| {dmax:.3g} px, "
                      f"max |dresidue| {dres:.3g}, statuses "
                      f"{sorted(set(got[2][act].tolist()))}")
                for i in torch.nonzero(act & ~same).flatten().tolist():
                    print(f"[3 kernel B]   mismatch feature {i}: kernel "
                          f"({got[0][i]:.4f}, {got[1][i]:.4f}, "
                          f"{int(got[2][i])}) plain ({ref[0][i]:.4f}, "
                          f"{ref[1][i]:.4f}, {int(ref[2][i])})")
                check(agree >= 0.995, f"kernel B status agreement {agree}")
                check(dmax <= 1e-3, f"kernel B positions differ by {dmax}")


def run_main_path(frames, n_feats, cfg, tag, known_motion: bool) -> None:
    """Select on frame 0, track through every frame with KLTracker in
    sequential mode, rerun with track_sequence, check, write the table."""
    t_len = frames.shape[0]
    tracker = klt.KLTracker(cfg, device="cuda")
    fl = klt.FeatureList.create(n_feats)
    tracker.select_good_features(frames[0], fl)
    start = fl.copy()
    sel = start.val >= 0
    n_sel = int(sel.sum())
    check(n_sel > 0, "no features selected")
    table = klt.FeatureTable.create(t_len, n_feats)
    table.store_list(fl, 0)
    t0 = time.perf_counter()
    for i in range(1, t_len):
        tracker.track_features(frames[i - 1], frames[i], fl)
        table.store_list(fl, i)
    t_tracker = time.perf_counter() - t0

    dev_frames = torch.from_numpy(frames).cuda()
    feats = [torch.from_numpy(a).cuda()
             for a in (start.x, start.y, start.val)]
    xs, ys, vs = track_sequence(dev_frames, *feats, cfg)
    torch.cuda.synchronize()
    xs, ys, vs = xs.cpu().numpy(), ys.cpu().numpy(), vs.cpu().numpy()
    check(xs.shape == (t_len - 1, n_feats), f"table shape {xs.shape}")
    check(np.isfinite(xs).all() and np.isfinite(ys).all(),
          "non-finite tracks")
    check(np.array_equal(xs, table.x[:, 1:].T) and
          np.array_equal(ys, table.y[:, 1:].T) and
          np.array_equal(vs, table.val[:, 1:].T),
          "track_sequence and KLTracker tables differ")

    # the same sequence through the plain versions on the CPU
    cpu = track_sequence(torch.from_numpy(frames),
                         *[torch.from_numpy(a) for a in
                           (start.x, start.y, start.val)], cfg)
    cx, cy, cv = (a.numpy() for a in cpu)
    st_agree = float((cv == vs)[:, sel].mean())
    both = (cv == vs) & (vs == 0)
    dcpu = float(np.abs(np.concatenate([(cx - xs)[both], (cy - ys)[both]]))
                 .max(initial=0.0))
    print(f"[{tag}] {frames.shape[2]}x{frames.shape[1]}, {t_len} frames: "
          f"{n_sel} of {n_feats} requested features selected; card vs CPU "
          f"plain: status agreement {st_agree:.4f}, max |dpos| {dcpu:.3g} px; "
          f"KLTracker loop {t_tracker:.3f} s")
    check(st_agree >= 0.995 and dcpu <= 1e-3,
          "card run disagrees with the plain CPU run")

    final_tracked = float((vs[-1][sel] == klt.TRACKED).mean())
    codes, counts = np.unique(vs[-1][sel], return_counts=True)
    print(f"[{tag}] still TRACKED at frame {t_len - 1}: {final_tracked:.4f}; "
          f"final statuses {dict(zip(codes.tolist(), counts.tolist()))}")
    check(final_tracked >= 0.90, f"only {final_tracked} still tracked")

    if known_motion:
        worst_med, worst_frac, errs_1 = 0.0, 1.0, None
        for k in range(1, t_len):
            tx, ty = shift(k)
            ok = sel & (vs[k - 1] == klt.TRACKED)
            err = np.maximum(np.abs(xs[k - 1][ok] - start.x[ok] - tx),
                             np.abs(ys[k - 1][ok] - start.y[ok] - ty))
            errs_1 = err if errs_1 is None else errs_1
            worst_med = max(worst_med, float(np.median(err)))
            worst_frac = min(worst_frac, float((err <= 1.0).mean()))
        print(f"[{tag}] error against the known motion: frame 1 median "
              f"{np.median(errs_1):.4f} px, max {errs_1.max():.4f} px; worst "
              f"frame median {worst_med:.4f} px, worst share within 1 px "
              f"{worst_frac:.4f}")
        check(np.median(errs_1) <= 0.15, "frame 1 median error above 0.15 px")
        check(worst_med <= 0.5, "a frame's median error is above 0.5 px")
        check(worst_frac >= 0.90, "under 90% of a frame's tracks within 1 px")

    with tempfile.TemporaryDirectory() as d:
        txt = os.path.join(d, "features.txt")
        ft = os.path.join(d, "features.ft")
        klt.write_feature_table(table, txt, "%5.1f")
        klt.write_feature_table(table, ft)
        back = klt.read_feature_table(ft)
        check(np.array_equal(back.x, table.x) and
              np.array_equal(back.val, table.val), "binary table round trip")
        with open(txt) as f:
            n_lines = sum(1 for _ in f)
        print(f"[{tag}] wrote feature table: {os.path.getsize(ft)} bytes "
              f"binary, {n_lines} text lines (%5.1f)")


def expected_lk_launches(shape, cfg) -> int:
    """LK kernel launches per frame pair: one per level that holds a
    window plus one."""
    return sum(1 for c, r in pyramid_shapes(shape[1], shape[0], cfg)
               if r >= cfg.window_height + 1 and c >= cfg.window_width + 1)


def phase_times(card, frames_by_size, cfg, n_feats, times):
    for frames, n in zip(frames_by_size, n_feats):
        size = f"{frames.shape[2]}x{frames.shape[1]}"
        fl = klt.FeatureList.create(n)
        klt.KLTracker(cfg).select_good_features(frames[0], fl)
        dev_frames = torch.from_numpy(frames).cuda()
        feats = [torch.from_numpy(a).cuda() for a in (fl.x, fl.y, fl.val)]
        reps = max(2, 200 // frames.shape[0])
        k_fps = sequence_fps(dev_frames, feats, cfg, False, reps)
        p_fps = sequence_fps(dev_frames, feats, cfg, True, 2)
        runs = lambda v: [round(f, 1) for f in v]
        print(f"[6 times] {card} | track_sequence {size}, {frames.shape[0]} "
              f"frames, {int((fl.val >= 0).sum())} features: kernels "
              f"{np.median(k_fps):.1f} frames/s (runs {runs(k_fps)}), plain "
              f"torch on the card {np.median(p_fps):.1f} frames/s (runs "
              f"{runs(p_fps)})", flush=True)

        img = dev_frames[1]
        a_ms = cuda_ms(lambda: build_pyramid_stacks_cuda(img, cfg), 200)
        a_plain = cuda_ms(lambda: build_pyramid_stacks_plain(img, cfg), 20)
        st1 = build_pyramid_stacks_cuda(dev_frames[0], cfg)
        st2 = build_pyramid_stacks_cuda(img, cfg)
        args = (st1[0], st2[0], *level_inputs(fl, cfg, 0), cfg, True)
        b_ms = cuda_ms(lambda: lk_level_cuda(*args), 200)
        b_plain = cuda_ms(lambda: lk_level_plain(*args), 10)
        print(f"[6 times] {card} | {size}: kernel A {a_ms * 1e3:.1f} us per "
              f"launch (plain {a_plain * 1e3:.1f} us); kernel B level 0, "
              f"{int((fl.val >= 0).sum())} features {b_ms * 1e3:.1f} us per "
              f"launch (plain {b_plain * 1e3:.1f} us)", flush=True)
        times[size] = {"pyramid": (a_ms, a_plain), "lk_level": (b_ms, b_plain)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1

    klt.set_verbosity(0)
    card = card_line()
    phase_build(card)

    cfg = klt.TrackingConfig(sequential_mode=True)
    lighting = klt.TrackingConfig(sequential_mode=True,
                                  lighting_insensitive=True)
    qvga = synthetic_frames(10)
    vga = synthetic_frames(100, scale=2)
    print("[inputs] synthetic frames: fixture scene translated by "
          "(3.2 sin 0.3k, 2.1 sin 0.23k) px, bilinear, u8; "
          f"{len(qvga)} x 320x240 and {len(vga)} x 640x480 (scene "
          "upsampled 2x)", flush=True)
    errs = {"pyramid": [], "lk_level": []}
    phase_pyramid((qvga, vga), cfg, errs["pyramid"])
    phase_lk((qvga, vga), (cfg, lighting), (150, 2000), errs["lk_level"])

    cuda.reset_launch_counts()
    real = provided_frames()
    if real is not None:
        print("[4 flagship] images_provided frames from KLT_IMAGES_PROVIDED")
    run_main_path(qvga if real is None else real, 150, cfg, "4 flagship",
                  known_motion=real is None)
    run_main_path(vga, 2000, cfg, "5 real size", known_motion=True)
    launches = {k.symbol: k.launches for k in cuda.KERNELS}
    # KLTracker and track_sequence each build every frame's pyramid once
    # and run one LK launch per level that holds the window
    want_a = 2 * (len(qvga) + len(vga))
    want_b = 2 * sum((len(f) - 1) * expected_lk_launches(f.shape[1:], cfg)
                     for f in (qvga, vga))
    print(f"[4-5 launches] {launches} (expected pyramid {want_a}, "
          f"lk_level {want_b})")
    check(cuda.PYRAMID.launches == want_a and
          cuda.LK_LEVEL.launches == want_b,
          "main path launch counts differ from the expected")

    times = {}
    phase_times(card, (qvga, vga), cfg, (150, 2000), times)

    report = {"kernels": []}
    for k, name in ((cuda.PYRAMID, "pyramid"), (cuda.LK_LEVEL, "lk_level")):
        ms, plain_ms = times["320x240"][name]
        report["kernels"].append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[k.symbol],
            "max_abs_err": max(errs[name]), "ms": ms, "plain_ms": plain_ms})
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
