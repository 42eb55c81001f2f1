"""Chip smoke run of klt_tpu_torch on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Builds the CUDA kernels from klt_tpu_torch/csrc (one nvcc per source, in
parallel), holds each against its plain torch version on the card (the
pyramid and replacement kernels also on adversarial configurations, sizes
and states: pyramid_cases, replace_cases), then drives the port's main
paths:

* tracking (the reference's example3 flow: select features on frame 0,
  track them in sequential mode, write the feature table) at 320x240 with
  150 features and at 640x480 with 2000 features;
* tracking with lost-feature replacement every frame (example3's REPLACE
  flow): at 320x240 with 150 features over 10 frames, through KLTracker
  and track_sequence_replace, and at the traffic configuration's size,
  640x480 with 500 features over 551 frames (images_traffic in the
  reference), with kernels, with batched pyramids (precomp) and through
  KLTracker;
* batched multi-sequence tracking (track_sequences_batched: one
  batched-pyramid launch and one kernel C launch per step for all
  sequences): 32 different sequences of 320x240 with 150 features each
  and 3 of 640x480 with 4096 features requested, over 10 frames;
* level-by-level tracking (track_features_pyramid_levels: the torch level
  loop over the level entries of kernels B and C, one launch per level),
  held against the one-launch pyramid entries on the same frames;
* tracking with the affine consistency check (the reference's laptops
  configuration: 640x480, 2000 features requested, mode 2, 4 pyramid
  levels of subsampling 2) over 100 frames in which a region is slowly
  covered and zoomed (affine_frames), through track_sequence_affine and
  through KLTracker: kernel F verifies every tracked feature against its
  saved patch and kills the ones that drifted;
* the same check on 8 different sequences at once
  (track_sequences_affine_batched, klt_tpu's laptops_affine_batched_b8:
  one launch each of kernels E, C and F a step for all 16,000 lanes) over
  101 frames of batched_affine_frames;
* selection from the response computed on the card (KLT_TPU_EXACT_SELECT=0)
  with the default window and with one that no tile of kernel D holds;
  kernel S (the candidate list and the lazy sort's large partitions, on
  the card) makes that selection's list and every sequential
  replacement's of KLTracker, held bit for bit against its plain version
  on kernel D's maps of the traffic frames;
* selection and replacement through the prefilter (KLTracker with
  prefilter=True: the candidates cut to the best few of each cell on the
  card), held bit for bit against the full list at 640x480;
* the SLAM pipeline of klt_tpu's bench (bench_slam_e2e) at the laptops
  width, 640x480 with 1000 features over 1003 frames: the front end
  (track_sequence_replace with precomp: kernels A, B, D, R, E), the
  feature table, chains, keyframes, the keyframe pose graph and the gated
  bundle adjustment (plain torch on the card), held against the plain CPU
  run, a second card run and the CPU's back end; and klt_tpu's SLAM scale
  tests (bundle_adjust_cg at 200 poses x 20,000 landmarks, the CG pose
  graph of 800 keyframes, the gated BA on 40% outliers) against their
  ground truth;
* the bit-exact replace run (track_sequence_replace_exact, klt_tpu's
  traffic row on its exact tier: kernels A, G, H2 and kernel R's tie
  entry, tie-flagged frames repaired on the host) on the 551 traffic
  frames with 500 features, held bit for bit against the plain CPU run
  over its first EXACT_CPU_FRAMES frames, and at 320x240 with 150
  features over 10 frames with a block pasted at two places (a tie that
  the host repairs); the same run with tier="fast"; and at 320x240 with
  a 121x121 window, which no tile of kernel H2 holds (its global-memory
  entry), over EXACT_WIDE_FRAMES frames;
* the tooling: the debug checks (KLT_TPU_DEBUG unset: the launches and
  host syncs of no checks; set: one warning for a feature planted outside
  the frame), write_internal_images from kernel A's stacks, the profiler
  wrapper's op_breakdown against profile_device, the track_sequence
  example at 640x480 with 1000 features over 64 frames written as PGMs
  (plain, --replace, --affine 2) against a KLTracker loop, and the graft
  entry's pair step against the plain CPU step;
* multi-device in a world of one rank on NCCL: make_batch_step and
  track_batch over a mesh at the batched flagship's size, the bundle
  adjustments and the CG pose graph at the scale tests' sizes, each
  bit-equal to mesh=None, and dryrun_multichip(1);
* the whole-sequence programs: every sequence entry runs its frame loop
  as CUDA graphs of chunks of steps (cuda/graph.py), and every path above
  goes through them; phase 40 holds each graphed entry bit-equal to the
  same call with every chunk run eagerly (Program.run's warm_up=True) on
  the six cells of PERF.md section 5 (the exact run over the first 100
  traffic frames, and the tie flagship, whose repair resumes inside a
  chunk), with the eager run's launches, one warning from the debug
  checks inside the graphs, and a capture that fails raising;
* KLTracker's per-frame calls and track_pair_carry as CUDA graphs of one
  step (runtime/tracker.py, runtime/pipeline.py), which every KLTracker
  flow above goes through: phase 41 holds them bit-equal to the same
  calls with every step run eagerly on the translation run (640x480 x 2000 requested, 100 frames), the replace loop
  (640x480 x 500, 100 traffic frames) and the affine run with replacement
  (20 frames), with the eager runs' launches, two trackers interleaved
  call by call, and a capture that fails raising;
* the SLAM solvers as programs of CUDA graphs (slam/solvers.py::LMSolve:
  each LM iteration after a solve's first replays its steps' graphs),
  which phases 36 and 37 go through: phase 42 holds phase 37's three
  solves and phase 36's back end bit-equal to their eager bodies
  (`_lm_drive_eager`, `_refit_landmarks_eager`,
  `_optimize_pose_graph_eager`, `_pair_solve_eager`), counts their
  replays, host syncs and device launches per LM iteration against the
  eager bodies', runs every step under the sync debug mode's "error",
  and has a capture that fails raise;

checks the tracks against the known motion of the synthetic frames and
against the plain versions on the CPU, checks that the replacement loop
and the batched loop never wait for the host, and times kernels and
sequences.  Every check
raises on failure; the exit code is then non-zero and no result line is
printed.  Without a CUDA device the script fails: it never runs on the
CPU.

The frames are synthetic: the 240x320 scene crop in
tests/fixtures/smoothed_img0.f32 (upsampled 2x for 640x480), translated
with bilinear interpolation by a known sub-pixel path per frame and
quantized to u8.  When KLT_IMAGES_PROVIDED names a directory holding the
reference's images_provided sequence (img0.pgm .. img9.pgm), the 320x240
flagship phase tracks those frames instead; their motion is unknown, so
that phase then checks them against the CPU run alone.

Prints, before its last line, one JSON object with every kernel's
launches on the main paths, its error against the plain version, its time
on the card (device time of back-to-back launches), the plain version's,
and the least time the card could take for the same work (bound_ms: the
larger of the bytes moved over 3.35 TB/s and the operations over
67 TFLOP/s f32, both counted from this run's inputs); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

import numpy as np
import torch

import klt_tpu_torch as klt
from klt_tpu_torch import cuda, native
from klt_tpu_torch.config import pyramid_shapes
from klt_tpu_torch.cuda.affine import affine_step_cuda_, track_affine_cuda
from klt_tpu_torch.cuda.corner_response import (corner_response_cuda,
                                                library_tile_rows)
from klt_tpu_torch.cuda.lk_level import (lk_level_batched_cuda, lk_level_cuda,
                                         lk_pyramid_batched_cuda,
                                         lk_pyramid_cuda)
from klt_tpu_torch.cuda.pyramid import (build_pyramid_stacks_batched_cuda,
                                        build_pyramid_stacks_cuda)
from klt_tpu_torch.cuda.replace import replace_lost_cuda_
from klt_tpu_torch.cuda.select_sort import (candidate_list_cuda,
                                            head_partitions_cuda, scratch_for)
from klt_tpu_torch.io.pnm import read_pgm
from klt_tpu_torch.kernels import gaussian_kernels
from klt_tpu_torch.ops.affine import (AffineState,
                                      affine_consistency_step_plain,
                                      track_affine_plain, verification_inputs)
from klt_tpu_torch.ops.lk import (lk_level_batched_plain, lk_level_plain,
                                  track_features_pyramid_levels,
                                  track_features_pyramid_stacks)
from klt_tpu_torch.ops.pyramid import (build_pyramid_stacks_batched_plain,
                                       build_pyramid_stacks_plain)
from klt_tpu_torch.ops.replace import replace_lost_plain_
from klt_tpu_torch.ops import select_sort
from klt_tpu_torch.ops.select_sort import (candidate_list_plain,
                                           head_partitions_plain)
from klt_tpu_torch.ops.selection import (corner_response_plain,
                                         response_tile_rows)
from klt_tpu_torch.parallel import (track_sequences_affine_batched,
                                    track_sequences_batched)
from klt_tpu_torch.runtime import pipeline
from klt_tpu_torch.runtime.pipeline import (PRECOMP_FRAMES, track_sequence,
                                            track_sequence_affine,
                                            track_sequence_replace,
                                            track_sequence_replace_exact)
from klt_tpu_torch.utils import profiling
from klt_tpu_torch.cuda import graph
from klt_tpu_torch.cuda.exact import (exact_response_cuda,
                                      exact_response_global_cuda,
                                      library_exact_tile_rows,
                                      track_exact_cuda)
from klt_tpu_torch.cuda.replace import replace_lost_tie_cuda_
from klt_tpu_torch.ops import lk_exact, replace_exact
from klt_tpu_torch.ops import lk as lk_ops
from klt_tpu_torch.ops import pyramid as pyramid_ops
from klt_tpu_torch.ops import replace as replace_ops
from klt_tpu_torch.ops import selection as selection_ops
from klt_tpu_torch.ops.lk_exact import (build_pyramids_exact,
                                        track_features_exact_plain)
from klt_tpu_torch.ops.replace_exact import (exact_response_plain,
                                             exact_response_tile,
                                             replace_lost_exact_)
from klt_tpu_torch.utils.parity import table_parity_stats
from klt_tpu_torch.interop import ba_problem_from_numpy, pose_graph_from_numpy
from klt_tpu_torch.runtime.tracker import KLTracker
from klt_tpu_torch.examples.slam_pipeline import (keyframe_observations,
                                                  unit_depth_landmarks)
from klt_tpu_torch.slam import (BAProblem, bundle_adjust_cg,
                                bundle_adjust_gated, optimize_pose_graph,
                                pose_graph, select_keyframes)
from klt_tpu_torch.slam import ba as slam_ba
from klt_tpu_torch.slam import frontend as slam_frontend
from klt_tpu_torch.slam import solvers as slam_solvers
from klt_tpu_torch.slam.ba import _residual_norms
from klt_tpu_torch.slam.frontend import build_keyframe_pose_graph
from klt_tpu_torch.slam.geometry import project as slam_project
from klt_tpu_torch.slam.geometry import so3_exp

HERE = os.path.dirname(os.path.abspath(__file__))
PROCESS_START = time.perf_counter()
FIXTURE = os.path.join(HERE, "tests", "fixtures", "smoothed_img0.f32")
# images_traffic, the reference's traffic sequence: 551 frames of 640x480
TRAFFIC_FRAMES = 551
# traffic frames whose kernel D maps phase 43 gives kernel S
SELECT_SORT_FRAMES = (1, 150, 300, 450)
# the least young features a frame's known-motion bounds are taken over
MIN_YOUNG = 20
# batched tracking: (sequences, frames) of klt_tpu's bench rows
# flagship_batched_b32 (320x240, 150 features) and batched_3seq_4096feat
# (640x480, 4096 features requested)
BATCHED_FLAGSHIP = (32, 10)
BATCHED_REAL = (3, 10)
# the affine run: frames of klt_tpu's bench row laptops_2000feat_affine_4level
# cut to 100, and the frames of it the plain CPU run repeats
AFFINE_FRAMES = 100
AFFINE_CPU_FRAMES = 12
# steps of the affine run whose states kernel F is held against its plain
# version on (none verified yet, the first verification, one timed, a late
# one with killed lanes)
AFFINE_STEPS = (0, 1, 10, 60)
# the batched affine run: (sequences, frames) of klt_tpu's bench row
# laptops_affine_batched_b8 (640x480, 2000 requested each, mode 2), the
# sequences and frames of it the plain CPU run repeats, and the step whose
# state kernel F is held and timed on
BATCHED_AFFINE = (8, 101)
BATCHED_AFFINE_CPU = (2, 6)
BATCHED_AFFINE_STEP = 10
# the exact replace run (track_sequence_replace_exact on the traffic
# frames): the frames of it the plain CPU runs repeat (both tiers), the
# steps whose states kernel G is held on, and the card's timed runs
EXACT_CPU_FRAMES = 100
EXACT_G_STEPS = (1, 100, 400)
EXACT_RUNS = 3
# the exact run with a window no tile of kernel H2 holds: 320x240 frames,
# the card's table against the plain CPU run over all of them
EXACT_WIDE = {"window_width": 121, "window_height": 121,
              "smooth_sigma_fact": 0.02, "borderx": 64, "bordery": 64,
              "n_pyramid_levels": 1, "subsampling": 2,
              "sequential_mode": True}
EXACT_WIDE_FRAMES = 4


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


def lane_shift(b: int, k: int) -> tuple[float, float]:
    """Known (tx, ty) displacement of frame k of batched sequence b from
    its frame 0: each lane has its own amplitude and phase, within +-4 px
    so features stay in view."""
    ax = 2.0 + 2.0 * ((0.37 * b) % 1.0)
    ay = 1.5 + 2.5 * ((0.61 * b) % 1.0)
    ph = 0.9 * b
    return (ax * (math.sin(0.3 * k + ph) - math.sin(ph)) / 2,
            ay * (math.sin(0.23 * k + ph) - math.sin(ph)) / 2)


def _scene(scale: int):
    """The fixture scene upsampled by `scale` (f64), and its pixel grid."""
    base = np.fromfile(FIXTURE, dtype=np.float32).reshape(240, 320)
    h, w = 240 * scale, 320 * scale
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    if scale != 1:
        base = bilinear_warp(base, xx / scale, yy / scale)
    return base, xx, yy


def _warp_u8(img, xx, yy, t) -> np.ndarray:
    return np.clip(np.rint(bilinear_warp(img, xx - t[0], yy - t[1])), 0,
                   255).astype(np.uint8)


def synthetic_frames(n_frames: int, scale: int = 1,
                     start: int = 0) -> np.ndarray:
    """uint8 [T, 240*scale, 320*scale]: frame k (k = start .. n_frames-1)
    is the fixture scene (upsampled by `scale`) translated by shift(k)."""
    base, xx, yy = _scene(scale)
    return np.stack([_warp_u8(base, xx, yy, shift(k))
                     for k in range(start, n_frames)])


def batched_frames(n_seq: int, n_frames: int, scale: int = 1) -> np.ndarray:
    """uint8 [B, T, 240*scale, 320*scale] of B different sequences: lane
    b is the fixture scene flipped by b % 4 (none, x, y, both), frame k
    of it translated by lane_shift(b, k)."""
    base, xx, yy = _scene(scale)
    out = np.empty((n_seq, n_frames) + base.shape, np.uint8)
    for b in range(n_seq):
        img = base[::-1 if b & 2 else 1, ::-1 if b & 1 else 1]
        for k in range(n_frames):
            out[b, k] = _warp_u8(img, xx, yy, lane_shift(b, k))
    return out


def tie_frames(frames: np.ndarray, start: int, seed: int = 5) -> np.ndarray:
    """A copy of uint8 [T, H, W] frames with a flat patch from frame 3 on
    (its features are lost) and, from frame `start` on, one block of
    seeded high-contrast texture pasted at two places: the two copies give
    equal exact responses to the bit, so the replacement at `start` meets
    integer ties at its picks (the input of the host repair)."""
    fr = frames.copy()
    t, h, w = fr.shape
    fr[3:, h // 4:h // 2, 5 * w // 16:9 * w // 16] = 128
    side = max(min(h, w) // 6, 12)
    cells = np.random.RandomState(seed).randint(0, 2, (-(-side // 4),) * 2)
    block = (40 + 170 * np.kron(cells, np.ones((4, 4))))[:side, :side]
    for y0, x0 in ((h // 8, w // 16), (5 * h // 8, 11 * w // 16)):
        fr[start:, y0:y0 + side, x0:x0 + side] = block.astype(np.uint8)
    return fr


# The deforming region of affine_frames, in the 320x240 scene's
# coordinates: centre and half sides.
AFFINE_REGION = (160.0, 120.0, 28.0, 24.0)


def in_affine_region(x, y, scale: int = 1, margin: float = 0.0):
    """Whether frame-0 positions (numpy) lie in the deforming region of
    affine_frames, widened by `margin` pixels."""
    cx, cy, hx, hy = (v * scale for v in AFFINE_REGION)
    return (np.abs(x - cx) <= hx + margin) & (np.abs(y - cy) <= hy + margin)


def _texture(scale: int, seed: int, xx, yy):
    """The smooth noise texture of affine_frames, made from `seed`."""
    h, w = xx.shape
    rng = np.random.RandomState(seed)
    coarse = rng.uniform(40.0, 215.0, (h // (8 * scale) + 2,
                                       w // (8 * scale) + 2))
    return bilinear_warp(coarse, xx / (8 * scale), yy / (8 * scale))


def _deforming(base, texture, xx, yy, scale: int, rate: float, path,
               n_frames: int) -> np.ndarray:
    """Frames of `base` translated by path(k), AFFINE_REGION covered by
    `texture` and zoomed as affine_frames says."""
    cx, cy, hx, hy = (v * scale for v in AFFINE_REGION)
    out = []
    for k in range(n_frames):
        tx, ty = path(k)
        sx, sy = xx - tx, yy - ty          # scene coordinates of a pixel
        inside = (np.abs(sx - cx) <= hx) & (np.abs(sy - cy) <= hy)
        zoom = 1.0 + 0.2 * rate * k
        zx = np.where(inside, cx + (sx - cx) / zoom, sx)
        zy = np.where(inside, cy + (sy - cy) / zoom, sy)
        alpha = min(1.0, rate * k)
        img = bilinear_warp(base, zx, zy)
        img = np.where(inside, (1 - alpha) * img +
                       alpha * bilinear_warp(texture, zx, zy), img)
        out.append(np.clip(np.rint(img), 0, 255).astype(np.uint8))
    return np.stack(out)


def affine_frames(n_frames: int, scale: int = 1, rate: float = 0.01,
                  seed: int = 5) -> np.ndarray:
    """uint8 [T, 240*scale, 320*scale] for the affine consistency check:
    the fixture scene translated by shift(k), and inside AFFINE_REGION
    (which moves with the scene) slowly covered and deformed: there frame
    k shows the scene zoomed about the region's centre by 1 + 0.2 rate k
    and blended with a smooth noise texture (made from `seed`) of weight
    min(1, rate k).  Frame to frame the region changes little, so the
    translation tracker follows it; against the patch saved at a
    feature's first track it drifts apart, which is what the check
    kills.  Outside the region the motion is the known shift(k)."""
    base, xx, yy = _scene(scale)
    return _deforming(base, _texture(scale, seed, xx, yy), xx, yy, scale,
                      rate, shift, n_frames)


def batched_affine_frames(n_seq: int, n_frames: int, scale: int = 1,
                          rate: float = 0.01, seed: int = 5) -> np.ndarray:
    """uint8 [B, T, 240*scale, 320*scale] of B different sequences for the
    batched affine check: sequence b is affine_frames with the scene and
    the texture flipped by b % 4 (none, x, y, both) and moved on
    lane_shift(b, k) instead of shift(k).  The flips keep AFFINE_REGION
    (centred in the scene) where it was, so the check kills features there
    in every sequence."""
    base, xx, yy = _scene(scale)
    texture = _texture(scale, seed, xx, yy)
    out = np.empty((n_seq, n_frames) + base.shape, np.uint8)
    for b in range(n_seq):
        flip = (slice(None, None, -1 if b & 2 else 1),
                slice(None, None, -1 if b & 1 else 1))
        out[b] = _deforming(base[flip], texture[flip], xx, yy, scale, rate,
                            lambda k, b=b: lane_shift(b, k), n_frames)
    return out


def provided_frames():
    """The reference's images_provided frames, if KLT_IMAGES_PROVIDED
    names their directory; else None."""
    d = os.environ.get("KLT_IMAGES_PROVIDED", "")
    if not d or not os.path.isdir(d):
        return None
    return np.stack([read_pgm(os.path.join(d, f"img{i}.pgm"))
                     for i in range(10)])


# ------------------------------------------------------------------ #
# adversarial inputs of kernels R, A and E                             #
# ------------------------------------------------------------------ #

def replace_cases():
    """Adversarial states of kernel R beside the tracked ones: (name,
    TrackingConfig keywords, response f32 [H, W], x, y f32 [N], val i32
    [N]), made from a seed.  The response takes few distinct values, with
    fractions to truncate, so equal maxima lie in different 32x32 tiles and
    rows; features sit on tile corners, on the map's borders and outside
    it, so squares cross both."""
    rng = np.random.RandomState(11)
    small = {"borderx": 0, "bordery": 0}  # candidates up to the window margin

    def state(hw, n, lost_share, levels=4):
        h, w = hw
        resp = (rng.randint(-1, levels, hw) * 40 +
                rng.uniform(0.0, 0.99, hw)).astype(np.float32)
        x = rng.uniform(-3.0, w + 2.0, n).astype(np.float32)
        y = rng.uniform(-3.0, h + 2.0, n).astype(np.float32)
        k = n // 3  # on tile corners and on the map's edges
        x[:k] = rng.choice([0.0, 31.6, 32.0, 63.9, 64.2, w - 1.0], k)
        y[:k] = rng.choice([0.3, 31.0, 32.5, 63.0, 64.9, h - 1.0], k)
        val = rng.randint(0, 500, n).astype(np.int32)
        lost = rng.rand(n) < lost_share
        val[lost] = rng.randint(-5, 0, int(lost.sum()))
        return resp, x, y, val

    return [
        ("ties, a map that is no multiple of the tile", {},
         *state((251, 333), 160, 0.4)),
        ("squares across tile corners and map borders", small,
         *state((96, 128), 90, 0.5)),
        ("all slots lost", small, *state((64, 80), 60, 1.0)),
        ("more lost slots than candidates", small,
         *state((40, 50), 80, 0.9)),
        ("mindist 1", {"mindist": 1, **small}, *state((70, 90), 120, 0.5)),
        ("mindist larger than a tile", {"mindist": 40, **small},
         *state((251, 333), 100, 0.6)),
        ("n_skipped_pixels 2", {"n_skipped_pixels": 2, **small},
         *state((100, 130), 80, 0.5)),
        ("a map smaller than a tile", {"mindist": 4, **small},
         *state((20, 27), 24, 0.5)),
        ("a high floor", {"min_eigenvalue": 81, **small},
         *state((64, 80), 50, 0.6)),
        ("no slot lost", small, *state((64, 80), 40, 0.0)),
        ("no slot at all", small, *state((64, 80), 0, 0.0)),
    ]


def pyramid_cases():
    """Configurations and frame sizes of kernels A and E beside the main
    paths': (name, TrackingConfig keywords, (rows, cols))."""
    return [
        ("default", {}, (240, 320)),
        ("default, enough tiles for tall ones", {}, (480, 640)),
        ("3 levels, subsampling 2",
         {"n_pyramid_levels": 3, "subsampling": 2}, (240, 320)),
        ("wide taps, 3 levels of subsampling 8",
         {"search_range": 60, "window_width": 9}, (240, 320)),
        ("wide taps that no tile holds (global-memory decimation)",
         {"n_pyramid_levels": 2, "subsampling": 16,
          "pyramid_sigma_fact": 0.5}, (240, 320)),
        ("an odd-sized frame", {}, (251, 333)),
        ("a frame smaller than a tile plus halo", {}, (20, 27)),
        ("gradient taps of two widths", {"grad_sigma": 0.9}, (64, 80)),
    ]


def response_cases():
    """Maps and windows of kernel D beside the main paths': (name, gradx,
    grady f32 [H, W], (window_width, window_height)), noise gradients made
    from a seed.  Flat and tall tiles, windows the kernel unrolls and
    windows it loops over, maps that are no multiple of a tile or smaller
    than one, values whose eigenvalue passes the 2147483583 clamp, and a
    window that no tile holds."""
    rng = np.random.RandomState(31)

    def case(name, hw, win, scale=40.0):
        gx, gy = ((rng.standard_normal(hw) * scale).astype(np.float32)
                  for _ in range(2))
        return name, gx, gy, win

    return [
        case("333x251, 7x7", (251, 333), (7, 7)),
        case("333x251, 3x3", (251, 333), (3, 3)),
        case("333x251, 5x9", (251, 333), (5, 9)),
        case("333x251, 15x15", (251, 333), (15, 15)),
        case("27x20, 7x7, a map smaller than one tile", (20, 27), (7, 7)),
        case("27x20, 3x3", (20, 27), (3, 3)),
        case("27x20, 15x15", (20, 27), (15, 15)),
        case("27x20, 5x9", (20, 27), (5, 9)),
        case("640x480, 7x7, tall tiles, values up to the clamp", (480, 640),
             (7, 7), scale=7e3),
        case("640x480, 5x9, tall tiles", (480, 640), (5, 9)),
        case("333x251, 111x111, no tile: the global-memory entry",
             (251, 333), (111, 111)),
    ]


def affine_cases():
    """Made states of kernel F beside the ones taken from the affine run:
    (name, TrackingConfig keywords, patches f32 [3, N, ph, pw], stack2 f32
    [3, H, W], x1, y1, x2, y2 f32 [N], (axx, ayx, axy, ayy) f32 [N],
    active bool [N]), made from a seed; each is run in modes 0, 1 and 2.
    The image is smooth noise with a flat rectangle; a lane's patch is cut
    around its position, which then moves by up to 0.7 px under a map up to
    3% off the identity.  Lanes 0-3 sit in the flat rectangle (zero
    gradients: a zero pivot), lanes 4-7 at the image's border under a map
    of scale 1.25 (a warped corner leaves the image), lanes 8-10 hold the
    patch of another place (a large residue), every seventh lane is
    inactive."""
    rng = np.random.RandomState(17)
    h, w = 120, 160
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = bilinear_warp(rng.uniform(0.0, 255.0, (h // 6 + 2, w // 6 + 2)),
                        xx / 6, yy / 6)
    img[40:75, 60:110] = 100.0
    gy, gx = np.gradient(img)
    stack = np.stack([img, gx, gy]).astype(np.float32)

    def case(name, kw, n=28):
        aw = kw.get("affine_window_width", 15)
        ah = kw.get("affine_window_height", 15)
        ph, pw = ah + 2, aw + 2
        cx = rng.uniform(pw, w - pw, n)
        cy = rng.uniform(ph, h - ph, n)
        cx[:4], cy[:4] = rng.uniform(75, 95, 4), rng.uniform(52, 62, 4)
        cx[4:8] = [aw / 2 + 0.6, w - aw / 2 - 1.4, 40.3, 90.8]
        cy[4:8] = [30.2, 70.7, ah / 2 + 0.4, h - ah / 2 - 1.2]
        px0 = np.clip(cx.astype(np.int64) - pw // 2, 0, w - pw)
        py0 = np.clip(cy.astype(np.int64) - ph // 2, 0, h - ph)
        src = np.arange(n)
        src[8:11] = [20, 21, 22]    # another place's patch
        patches = np.stack([stack[:, py0[i]:py0[i] + ph, px0[i]:px0[i] + pw]
                            for i in src], axis=1)
        f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
        x1 = f32(cx - np.trunc(cx) + pw // 2)
        y1 = f32(cy - np.trunc(cy) + ph // 2)
        x2 = f32(cx + rng.uniform(-0.7, 0.7, n))
        y2 = f32(cy + rng.uniform(-0.7, 0.7, n))
        maps = [f32(d + rng.uniform(-0.03, 0.03, n)) for d in (1, 0, 0, 1)]
        maps[0][4:8] = 1.25
        maps[3][4:8] = 1.25
        active = np.arange(n) % 7 != 6
        return (name, kw, f32(patches), stack, x1, y1, x2, y2, tuple(maps),
                active)

    return [case("15x15 window", {}),
            case("9x9 window", {"affine_window_width": 9,
                                "affine_window_height": 9}),
            case("11x5 window, 3 iterations",
                 {"affine_window_width": 11, "affine_window_height": 5,
                  "affine_max_iterations": 3}),
            case("no active lane", {}, n=24)[:9] + (np.zeros(24, bool),)]


def exact_cases():
    """Frames and configurations of kernel A as the exact tier takes it
    (every level, and level 0 alone without the pre-smoothing) and of
    kernel H2, beside the main paths': (name, TrackingConfig keywords,
    frame uint8 or f32 [H, W]),
    made from a seed.  The sizes of the main paths, an odd size, a frame
    narrower than the pyramid taps (every pass of it zero), f32 input, and
    the three sigmas of the default configuration (smoothing 0.7,
    gradients 1.0, pyramid 3.6) in each pass."""
    rng = np.random.RandomState(37)
    base, xx, yy = _scene(2)
    vga = _warp_u8(base, xx, yy, (0.3, 0.7))
    return [
        ("640x480", {}, vga),
        ("320x240", {}, vga[::2, ::2].copy()),
        ("333x251, odd", {}, vga[100:351, 200:533].copy()),
        ("18x40, narrower than the pyramid taps", {},
         rng.randint(0, 256, (40, 18)).astype(np.uint8)),
        ("333x251 f32, gradient sigma 0.7", {"grad_sigma": 0.7},
         rng.uniform(0.0, 255.0, (251, 333)).astype(np.float32)),
        ("320x240, gradient sigma 3.6, 3 levels of subsampling 2",
         {"grad_sigma": 3.6, "n_pyramid_levels": 3, "subsampling": 2},
         vga[1::2, 1::2].copy()),
        ("320x240, 9x9 window, smoothing sigma 0.9",
         {"window_width": 9, "window_height": 9}, vga[::2, 1::2].copy()),
    ]


def exact_lk_cases():
    """Made frame pairs and lanes of kernel G beside the tracked ones:
    (name, TrackingConfig keywords, frame1, frame2 uint8 [H, W], x, y f32
    [N], val i32 [N]), made from a seed.  Frame 2 is frame 1 (a 120x160
    crop of the fixture scene) moved by (0.6, -0.4) px, with a flat
    rectangle in both frames that reaches the left edge and, in frame 2
    only, a block of foreign texture.  Lanes 0-1 start out of bounds,
    2-4 sit in the flat rectangle (a zero determinant), 5-6 in it inside
    the border band (SMALL_DET there: klt_tpu's order, C records OOB),
    7-9 under the foreign block (a large residue), 10-11 are lost slots,
    the rest lie on the scene's texture.  The cases after the first four
    take windows kernel G chunks differently (15x15: 8 cells a thread;
    27x27: 23 cells a thread, in chunks of 256), with the flat rectangle
    widened to 60x60 so that lanes 2-4 stay flat under them; lanes that run
    max_iterations on every level (min_displacement 0); a lane count that
    is no multiple of a block's warps (43); and a 139x139 window, whose
    image-1 samples no block's shared memory holds (G samples image 1 again
    every iteration there), on the whole 320x240 scene with its left 170
    columns flat, 20 lanes."""
    rng = np.random.RandomState(23)
    base, xx, yy = _scene(1)
    crop = (slice(60, 180), slice(80, 240))
    f1 = _warp_u8(base, xx, yy, (0.0, 0.0))[crop]
    f2 = _warp_u8(base, xx, yy, (0.6, -0.4))[crop]
    for f in (f1, f2):
        f[70:110, 0:40] = 90
    f2[15:45, 100:130] = rng.randint(0, 256, (30, 30))
    n = 40
    x = rng.uniform(30.0, 130.0, n).astype(np.float32)
    y = rng.uniform(20.0, 60.0, n).astype(np.float32)
    x[:2], y[:2] = [1.5, 158.2], [50.0, 40.0]
    x[2:5], y[2:5] = [25.3, 30.8, 33.1], [85.2, 90.7, 95.4]
    x[5:7], y[5:7] = [12.2, 14.9], [88.6, 93.1]
    x[7:10], y[7:10] = [110.4, 115.7, 120.2], [25.3, 30.1, 36.6]
    val = np.zeros(n, np.int32)
    val[10:12] = [-1, -4]
    wide1, wide2 = f1.copy(), f2.copy()
    for f in (wide1, wide2):
        f[60:120, 0:60] = 90
    big1 = _warp_u8(base, xx, yy, (0.0, 0.0))
    big2 = _warp_u8(base, xx, yy, (0.6, -0.4))
    for f in (big1, big2):
        f[:, 0:170] = 90
    xb = rng.uniform(160.0, 245.0, 20).astype(np.float32)
    yb = rng.uniform(75.0, 160.0, 20).astype(np.float32)
    xb[:4], yb[:4] = [60.5, 252.3, 82.3, 86.8], [120.0, 100.0, 110.5, 140.2]
    valb = np.zeros(20, np.int32)
    valb[10:12] = [-1, -3]
    x43 = np.concatenate([x, rng.uniform(30.0, 130.0, 3).astype(np.float32)])
    y43 = np.concatenate([y, rng.uniform(20.0, 60.0, 3).astype(np.float32)])
    val43 = np.concatenate([val, np.zeros(3, np.int32)])
    return [("default, 2 levels of subsampling 4", {}, f1, f2, x, y, val),
            ("3 iterations at most", {"max_iterations": 3}, f1, f2, x, y,
             val),
            ("9x9 window, 3 levels of subsampling 2",
             {"window_width": 9, "window_height": 9, "n_pyramid_levels": 3,
              "subsampling": 2}, f1, f2, x, y, val),
            ("5x5 window, one level, no residue check",
             {"window_width": 5, "window_height": 5, "n_pyramid_levels": 1,
              "max_residue": 0.0}, f1, f2, x, y, val),
            ("15x15 window, 2 levels of subsampling 2, 43 lanes",
             {"window_width": 15, "window_height": 15, "n_pyramid_levels": 2,
              "subsampling": 2},
             wide1, wide2, x43, y43, val43),
            ("27x27 window, one level: 23 cells a thread",
             {"window_width": 27, "window_height": 27, "n_pyramid_levels": 1,
              "subsampling": 2},
             wide1, wide2, x, y, val),
            ("min displacement 0: max_iterations on every level",
             {"min_displacement": 0.0}, f1, f2, x, y, val),
            ("139x139 window, one level: image 1 not hoisted",
             {"window_width": 139, "window_height": 139,
              "smooth_sigma_fact": 0.02, "n_pyramid_levels": 1,
              "subsampling": 2}, big1, big2, xb, yb,
             valb)]


def exact_replace_cases():
    """States of kernel R's tie entry beside replace_cases (where most
    picks are ties): (name, TrackingConfig keywords, response f32 [H, W],
    x, y f32 [N], val i32 [N]), made from a seed.  Responses with no
    equal integers except where made: a block copied to another place
    (equal values to the bit, a tie), and two equal cells of which a
    first pick's square kills one (no tie left), or neither (a tie)."""
    rng = np.random.RandomState(29)
    small = {"borderx": 0, "bordery": 0}

    def unique(h, w):  # every truncated value differs
        return (rng.permutation(h * w).reshape(h, w) * 3 + 1000 +
                rng.uniform(0.0, 0.9, (h, w))).astype(np.float32)

    def lost(n, share, h, w):
        x = rng.uniform(0.0, w - 1.0, n).astype(np.float32)
        y = rng.uniform(0.0, h - 1.0, n).astype(np.float32)
        val = np.where(rng.rand(n) < share, -1, 1).astype(np.int32)
        return x, y, val

    copied = unique(96, 128)
    copied[60:84, 90:114] = copied[10:34, 20:44]
    copied[20:24, 30:34] += 1e6  # the copied block holds the maxima
    copied[70:74, 100:104] = copied[20:24, 30:34]
    cases = [("a block copied to two places", small, copied,
              *lost(40, 0.5, 96, 128)),
             ("unique maxima", small, unique(96, 128),
              *lost(40, 0.5, 96, 128))]
    for name, far in (("a stamp kills one of two equal cells", False),
                      ("two equal cells that no stamp reaches", True)):
        resp = unique(64, 96)
        resp[10, 10] = resp[10, 30] = 5e6 + 0.5
        resp[10, 4 if not far else 60] = 6e6 + 0.5
        x = np.full(6, 80.0, np.float32)
        y = np.full(6, 50.0, np.float32)
        val = np.array([-1, -1, 5, 5, 5, 5], np.int32)
        cases.append((name, {"mindist": 10, **small}, resp, x, y, val))
    return cases


def noise_frames(n: int, hw, seed: int) -> np.ndarray:
    """uint8 [n, rows, cols] of uniform noise."""
    return np.random.RandomState(seed).randint(0, 256, (n, *hw), np.uint8)


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


def kernel_times(fn, reps: int, launches: int = 1) -> tuple[float, float]:
    """(device ms, host ms) per call of fn(), which enqueues `launches`
    kernels.  Host: the clock around reps calls, nothing awaited.  Device:
    CUDA events around reps calls enqueued while the card spins in a sleep
    kernel long enough for the host to finish enqueueing, so the kernels
    run back to back however long the host takes to launch one."""
    reps = max(2, min(reps, 800 // launches))
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2.0e9 * (1.5 * host + 2e-3)))  # cycles, <= 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, host * 1e3 / reps


# ------------------------------------------------------------------ #
# the least time the card could take                                   #
# ------------------------------------------------------------------ #

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12          # f32 outside the tensor cores
SAMPLE_FLOPS = 7           # a bilinear sample: 4 products, 3 sums


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the operations over its f32 peak."""
    by, op = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / F32_FLOPS * 1e3
    return (by, "bytes") if by >= op else (op, "operations")


def pyramid_work(img, cfg, batch: int = 1) -> tuple[float, float]:
    """(bytes, flops) of a pyramid build: the frame read once, every
    level's 3 maps written once; per level a separable smoothing at the
    source resolution and two separable gradient maps."""
    h, w = img.shape[-2:]
    taps = [len(gaussian_kernels(sig)[0]) for sig in
            (cfg.smooth_sigma, cfg.grad_sigma, cfg.pyramid_sigma)]
    n_bytes, n_flops, src = h * w * img.element_size(), 0, h * w
    for lvl, (c, r) in enumerate(pyramid_shapes(w, h, cfg)):
        n_bytes += 3 * r * c * 4
        n_flops += 2 * 2 * taps[0 if lvl == 0 else 2] * src
        n_flops += 2 * 2 * 2 * taps[1] * r * c
        src = r * c
    return batch * n_bytes, batch * n_flops


def response_work(rows: int, cols: int, cfg) -> tuple[float, float]:
    """(bytes, flops) of the corner response: two gradient maps read, one
    response written; 3 products, 3 separable box sums and the eigenvalue
    per pixel."""
    box = 3 * (cfg.window_width - 1 + cfg.window_height - 1)
    return 3 * rows * cols * 4, rows * cols * (3 + box + 12)


def replace_work(rows: int, cols: int, n: int, picks: int
                 ) -> tuple[float, float]:
    """(bytes, flops) of the greedy replacement: the response map and the
    feature state read once, the state written once; one comparison per
    map cell for each pick this state needs."""
    return rows * cols * 4 + 2 * 12 * n, max(picks, 1) * rows * cols


def select_list_work(n: int) -> tuple[float, float]:
    """(bytes, flops) of kernel S's list entry for n rows: a response
    value read and a row of three int32 written a row; the cast's two
    comparisons."""
    return 16 * n, 2 * n


def select_partitions_work(parts) -> tuple[float, float]:
    """(bytes, flops) of kernel S's partition entry over the partitions
    (rows of the range, rows moved) it made: each range's rows read once,
    each moved row written once; two comparisons a row in each of the
    count and rank passes."""
    return (sum(12 * (rows + moved) for rows, moved in parts),
            sum(4 * rows for rows, _ in parts))


def lk_level_work(act: int, iters: int, lanes: int, cfg,
                  residue: bool) -> tuple[float, float]:
    """(bytes, flops) of one LK level for `act` live lanes that ran
    `iters` Newton iterations together: each live lane's (w+1)x(h+1)
    3-channel footprint once in each frame, the lanes' state in and out;
    per cell 3 first-image samples, per iteration 3 second-image samples,
    3 differences and 5 products and sums, and the residue's sample."""
    w, h = cfg.window_width, cfg.window_height
    n_bytes = act * 2 * 3 * (w + 1) * (h + 1) * 4 + lanes * (17 + 20)
    per_cell = act * 3 * SAMPLE_FLOPS + iters * (3 * SAMPLE_FLOPS + 13) + \
        (act * (SAMPLE_FLOPS + 3) if residue else 0)
    return n_bytes, w * h * per_cell


def lk_pyramid_work(stacks1, stacks2, feats, cfg) -> tuple[float, float]:
    """(bytes, flops) of one frame pair of LK on this state: every
    level's work for the lanes that reach it and the iterations they run
    (taken from the level loop on the card), and the lanes' x, y, val in
    and out once."""
    stats = []
    track_features_pyramid_levels(stacks1, stacks2, *feats, cfg, stats=stats)
    n_bytes, n_flops = 2 * 12 * feats[0].numel(), 0
    for r, in_loop, iters in stats:
        rows, cols = stacks1[r].shape[-2:]
        if rows < cfg.window_height + 1 or cols < cfg.window_width + 1:
            continue
        by, fl = lk_level_work(int(in_loop.sum()), int(iters.sum()), 0, cfg,
                               r == 0)
        n_bytes, n_flops = n_bytes + by, n_flops + fl
    return n_bytes, n_flops


def affine_work(act: int, iters: int, lanes: int, cfg,
                frame_px: int) -> tuple[float, float]:
    """(bytes, flops) of one verify pass of kernel F for `act` live lanes
    that ran `iters` Gauss-Newton iterations together, in frames of
    frame_px pixels in all (B frames of a batch).  Bytes: the (w+1)x(h+1)
    cells of each live lane's patch that its bilinear samples touch, in the
    planes the mode reads (mode 0 all three, modes 1 and 2 the intensity
    alone), its (w+1)x(h+1) 3-channel footprint in image 2 once (the window
    moves by under a pixel from one iteration to the next, so later
    iterations need no new bytes), all footprints together at most the
    frames' three planes, and the lanes' state in and out.  Operations: per
    cell the patch samples once, per iteration 3 samples, the design
    columns and the products and sums of the normal equations, and once the
    residue's sample; per iteration the elimination."""
    aw, ah = cfg.affine_window_width, cfg.affine_window_height
    mode = cfg.affine_consistency_check
    n_par = (2, 4, 6)[mode]
    planes = 3 if mode == 0 else 1
    n_bytes = act * planes * (aw + 1) * (ah + 1) * 4 + \
        min(act * 3 * (aw + 1) * (ah + 1) * 4, 3 * frame_px * 4) + \
        lanes * (8 * 4 + 1 + 8 * 4)
    per_iter = 3 * SAMPLE_FLOPS + 1 + 2 * n_par + \
        2 * (n_par * (n_par + 1) // 2 + n_par)
    per_cell = act * planes * SAMPLE_FLOPS + \
        iters * per_iter + act * (SAMPLE_FLOPS + 2)
    return n_bytes, aw * ah * per_cell + iters * 2 * n_par ** 3


def frame_px(stack) -> int:
    """Pixels of the frames of a level-0 stack [3, H, W] or [B, 3, H, W]."""
    return stack[..., 0, :, :].numel()


def iteration_histogram(iters, active, cfg) -> list:
    """How many active lanes ran 0, 1, .. max_iterations iterations."""
    return np.bincount(iters[active].cpu().numpy(),
                       minlength=cfg.affine_max_iterations + 1).tolist()


def launches_per_step(run, steps: int) -> dict:
    """Each kernel's launches per step of run(), counted on one run."""
    cuda.reset_launch_counts()
    run()
    torch.cuda.synchronize()
    return {k.symbol: round(k.launches / steps, 3) for k in cuda.KERNELS}


@contextmanager
def phase(tag: str):
    """Prints how many seconds the phase took."""
    t0 = time.perf_counter()
    yield
    print(f"[{tag}] phase took {time.perf_counter() - t0:.2f} s", flush=True)


def sequence_fps(frames, feats, cfg, plain: bool, reps: int,
                 seq=track_sequence, **kw) -> list[float]:
    """Frames/s of a sequence entry point, host clock around synchronised
    runs, after one warm-up run."""
    run = lambda: seq(frames, *feats, cfg, plain=plain, **kw)
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
    # ptxas' report, one line per kernel: registers, stack and spills
    name = None
    lk = ("lk_level_batched_kernel", "lk_pyramid_batched_kernel",
          "lk_level_kernel", "lk_pyramid_kernel", "pyramid_tiles",
          "hpass_global", "vpass_global", "replace_lost", "hsum_products",
          "vsum_eigen", "response_tiles", "affine_track_kernel",
          "affine_step_kernel", "exact_response_tiles",
          "exact_response_global", "exact_track")
    for line in cuda.build_log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = next((k for k in lk if k in mangled), mangled[-48:])
            cells = mangled.split("ILi")[1].split("E")[0] \
                if "ILi" in mangled else ""
            name += f"<{cells}>" if cells else ""
            frame = ""
        elif "bytes stack frame" in line:
            frame = line.strip()
        elif "registers" in line and name:
            print(f"[1 build] ptxas: {name}: "
                  f"{line.split(':', 1)[1].strip()}; {frame}")
            name = None


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


def phase_pyramid_cases(errs_a, errs_e) -> None:
    """Kernels A and E on the configurations and sizes of pyramid_cases
    (tall and flat tiles, three levels, wide taps, the global-memory
    decimation, odd and tiny frames, two gradient widths), noise frames:
    the bits of the plain version, and E image by image equal to A."""
    lib = cuda.load_library()
    for name, kw, hw in pyramid_cases():
        cfg = klt.TrackingConfig(**kw)
        n_pyr = len(gaussian_kernels(cfg.pyramid_sigma)[0])
        untiled = bool(lib.klt_pyramid_needs_scratch(
            cfg.n_pyramid_levels, cfg.subsampling, n_pyr))
        imgs = torch.from_numpy(noise_frames(3, hw, 21)).cuda()
        got = build_pyramid_stacks_batched_cuda(imgs, cfg)
        ref = build_pyramid_stacks_batched_plain(imgs, cfg)
        single = [build_pyramid_stacks_cuda(im, cfg) for im in imgs]
        torch.cuda.synchronize()
        err_e = max((a - b).abs().max().item() for a, b in zip(got, ref))
        err_a = max((s[lvl] - r[i]).abs().max().item()
                    for i, s in enumerate(single) for lvl, r in enumerate(ref))
        bits = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, ref))
        same_a = all(torch.equal(g[i], s[lvl]) for i, s in enumerate(single)
                     for lvl, g in enumerate(got))
        errs_a.append(err_a)
        errs_e.append(err_e)
        print(f"[2, 8 kernels A, E] {name}: 3 frames of {hw[1]}x{hw[0]}, "
              f"levels {[tuple(g.shape[2:]) for g in got]}, taps "
              f"{len(gaussian_kernels(cfg.smooth_sigma)[0])} / "
              f"{[len(t) for t in gaussian_kernels(cfg.grad_sigma)]} / "
              f"{n_pyr}, decimation "
              f"{'by the global-memory passes' if untiled else 'tiled'}: max "
              f"|A - plain| {err_a:.3g}, max |E - plain| {err_e:.3g}, the "
              f"plain version's bits: {bits}, E image by image equal to A: "
              f"{same_a}")
        check(err_a == 0 and err_e == 0 and bits and same_a and
              all(torch.isfinite(g).all().item() for g in got),
              f"kernel A or E differs from the plain version ({name})")
        check(untiled == ("no tile" in name),
              f"unexpected choice of decimation path ({name})")


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
    """Level-entry launches per frame pair of the level-by-level path: one
    per level that holds a window plus one.  (The main paths launch one
    pyramid entry per frame pair.)"""
    return sum(1 for c, r in pyramid_shapes(shape[1], shape[0], cfg)
               if r >= cfg.window_height + 1 and c >= cfg.window_width + 1)


def lk_level_bound(out, active, cfg, residue: bool) -> tuple[float, str]:
    """The bound of one level-entry launch from what it returned."""
    return bound(*lk_level_work(int(active.sum()), int(out[3].sum()),
                                active.numel(), cfg, residue))


def phase_times(card, frames_by_size, cfg, n_feats, times, per_step):
    for frames, n in zip(frames_by_size, n_feats):
        size = f"{frames.shape[2]}x{frames.shape[1]}"
        fl = klt.FeatureList.create(n)
        klt.KLTracker(cfg).select_good_features(frames[0], fl)
        n_sel = int((fl.val >= 0).sum())
        dev_frames = torch.from_numpy(frames).cuda()
        feats = [torch.from_numpy(a).cuda() for a in (fl.x, fl.y, fl.val)]
        reps = max(2, 200 // frames.shape[0])
        k_fps = sequence_fps(dev_frames, feats, cfg, False, reps)
        p_fps = sequence_fps(dev_frames, feats, cfg, True, 2)
        runs = lambda v: [round(f, 1) for f in v]
        print(f"[6 times] {card} | track_sequence {size}, {frames.shape[0]} "
              f"frames, {n_sel} features: kernels "
              f"{np.median(k_fps):.1f} frames/s = "
              f"{1e6 / np.median(k_fps):.1f} us of wall per step (runs "
              f"{runs(k_fps)}), plain torch on the card "
              f"{np.median(p_fps):.1f} frames/s (runs {runs(p_fps)})",
              flush=True)
        per_step["track_sequence"] = launches_per_step(
            lambda: track_sequence(dev_frames, *feats, cfg),
            frames.shape[0] - 1)

        img = dev_frames[1]
        a_ms, a_host = kernel_times(
            lambda: build_pyramid_stacks_cuda(img, cfg), 100, launches=3)
        a_plain = cuda_ms(lambda: build_pyramid_stacks_plain(img, cfg), 20)
        a_bound = bound(*pyramid_work(img, cfg))
        st1 = build_pyramid_stacks_cuda(dev_frames[0], cfg)
        st2 = build_pyramid_stacks_cuda(img, cfg)
        args = (st1[0], st2[0], *level_inputs(fl, cfg, 0), cfg, True)
        b_ms, b_host = kernel_times(lambda: lk_level_cuda(*args), 200)
        b_plain = cuda_ms(lambda: lk_level_plain(*args), 10)
        b_bound = lk_level_bound(lk_level_cuda(*args), args[6], cfg, True)
        p_ms, p_host = kernel_times(
            lambda: lk_pyramid_cuda(st1, st2, *feats, cfg), 200)
        p_plain = cuda_ms(lambda: track_features_pyramid_stacks(
            st1, st2, *feats, cfg, plain=True), 5)
        p_bound = bound(*lk_pyramid_work(st1, st2, feats, cfg))
        l_ms = cuda_ms(lambda: track_features_pyramid_levels(
            st1, st2, *feats, cfg), 20)
        us = lambda ms: f"{ms * 1e3:.1f}"
        print(f"[6 times] {card} | {size}, device us per call (bound; host "
              f"enqueue; plain version on the card): kernel A "
              f"{us(a_ms)} ({us(a_bound[0])} by {a_bound[1]}; {us(a_host)}; "
              f"{us(a_plain)}); kernel B level entry, level 0, {n_sel} "
              f"features {us(b_ms)} ({us(b_bound[0])} by {b_bound[1]}; "
              f"{us(b_host)}; {us(b_plain)}); kernel B pyramid entry, the "
              f"frame pair {us(p_ms)} ({us(p_bound[0])} by {p_bound[1]}; "
              f"{us(p_host)}; {us(p_plain)}); the same frame pair through "
              f"the torch level loop over the level entries {us(l_ms)} us "
              f"from the host's side", flush=True)
        for name, ms, plain, bnd in (("pyramid", a_ms, a_plain, a_bound),
                                     ("lk_level", b_ms, b_plain, b_bound),
                                     ("lk_pyramid", p_ms, p_plain, p_bound)):
            times[name] = {"ms": ms, "plain_ms": plain, "bound_ms": bnd[0],
                           "bound_by": bnd[1]}


def phase_corner_response(frames_by_size, cfg, errs) -> None:
    """Kernel D against its plain version on kernel A's level-0 gradients:
    the tiled entry, one launch."""
    for frames in frames_by_size:
        img = torch.from_numpy(frames[1]).cuda()
        _, gx, gy = build_pyramid_stacks_cuda(img, cfg)[0]
        win = (cfg.window_width, cfg.window_height)
        before = cuda.CORNER_RESPONSE.launches
        got = corner_response_cuda(gx, gy, *win)
        check(cuda.CORNER_RESPONSE.launches == before + 1,
              "kernel D did not take its tiled entry on a main path's frame")
        ref = corner_response_plain(gx, gy, *win)
        torch.cuda.synchronize()
        check(torch.isfinite(got).all().item(), "non-finite response")
        err = (got - ref).abs().max().item()
        ints = torch.equal(got.to(torch.int32), ref.to(torch.int32))
        errs.append(err)
        print(f"[7 kernel D] {frames.shape[2]}x{frames.shape[1]}: max "
              f"|kernel - plain| {err:.3g}, truncated int maps equal: {ints}; "
              f"response max {got.max().item():.1f}")
        check(err == 0 and ints, "kernel D differs from its plain version")


def phase_response_cases(errs, errs_global) -> None:
    """Kernel D's two entries on the maps and windows of response_cases
    (flat and tall tiles, unrolled and looped windows, maps smaller than a
    tile, the clamp; a window no tile holds through the global-memory
    entry): the bits of the plain version."""
    for name, gx, gy, win in response_cases():
        gx, gy = torch.from_numpy(gx).cuda(), torch.from_numpy(gy).cuda()
        counts = (cuda.CORNER_RESPONSE.launches,
                  cuda.CORNER_RESPONSE_GLOBAL.launches)
        got = corner_response_cuda(gx, gy, *win)
        took = (cuda.CORNER_RESPONSE.launches - counts[0],
                cuda.CORNER_RESPONSE_GLOBAL.launches - counts[1])
        ref = corner_response_plain(gx, gy, *win)
        torch.cuda.synchronize()
        untiled = library_tile_rows(*win) == 0
        check(response_tile_rows(*win, 1 << 12, 1 << 12) ==
              library_tile_rows(*win), "the tile rule of the plain model "
              "differs from the library's")
        err = (got - ref).abs().max().item()
        bits = torch.equal(got.view(torch.int32), ref.view(torch.int32))
        clamped = int((got == 2147483583.0).sum())
        (errs_global if untiled else errs).append(err)
        print(f"[7 kernel D] {name}: window {win[0]}x{win[1]}, "
              f"{'global-memory' if untiled else 'tiled'} entry: max "
              f"|kernel - plain| {err:.3g}, the plain version's bits: "
              f"{bits}; {clamped} pixels at the clamp")
        check(err == 0 and bits and torch.isfinite(got).all().item(),
              f"kernel D differs from its plain version ({name})")
        check(took == ((0, 1) if untiled else (1, 0)) and
              untiled == ("no tile" in name),
              f"unexpected choice of kernel D's entry ({name})")
        check(("clamp" in name) == (clamped > 0),
              f"unexpected count of clamped pixels ({name})")


def phase_batched_pyramid(batches, cfg, errs) -> None:
    """Kernel E against its plain version and, image by image, kernel A."""
    for frames in batches:
        imgs = torch.from_numpy(frames).cuda()
        got = build_pyramid_stacks_batched_cuda(imgs, cfg)
        ref = build_pyramid_stacks_batched_plain(imgs, cfg)
        single = [build_pyramid_stacks_cuda(im, cfg) for im in imgs]
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        same_a = all(torch.equal(g[i], s[lvl]) for i, s in enumerate(single)
                     for lvl, g in enumerate(got))
        errs.append(err)
        print(f"[8 kernel E] {len(frames)} frames of {frames.shape[2]}x"
              f"{frames.shape[1]}, stacks {[tuple(g.shape) for g in got]}: "
              f"max |kernel - plain| {err:.3g}; every image bit-equal to "
              f"kernel A: {same_a}")
        check(err == 0 and same_a and
              all(torch.isfinite(g).all().item() for g in got),
              "kernel E differs from its plain version or from kernel A")


def lost_state(frames, n_feats, cfg, n_steps):
    """A KLTracker run on the card without replacement for n_steps frames:
    the state with its lost slots, and the last frame's response."""
    tr = klt.KLTracker(cfg, device="cuda")
    fl = klt.FeatureList.create(n_feats)
    tr.select_good_features(frames[0], fl)
    for i in range(1, n_steps + 1):
        tr.track_features(frames[i - 1], frames[i], fl)
    _, gx, gy = tr._pyr_last[0]
    return fl, corner_response_cuda(gx, gy, cfg.window_width,
                                    cfg.window_height)


def phase_replace_kernel(frames_by_size, n_feats, cfg, errs) -> None:
    """Kernel R against its plain version on tracked states with lost
    slots."""
    for frames, n in zip(frames_by_size, n_feats):
        fl, resp = lost_state(frames, n, cfg, 5)
        outs = []
        for fn in (replace_lost_cuda_, replace_lost_plain_):
            x, y, val = (torch.from_numpy(a.copy()).cuda()
                         for a in (fl.x, fl.y, fl.val))
            fn(resp, x, y, val, cfg)
            outs.append((x, y, val))
        torch.cuda.synchronize()
        (x, y, val), ref = outs
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(outs[0], ref))
        same = all(torch.equal(a, b) for a, b in zip(outs[0], ref))
        lost = fl.val < 0
        v = val.cpu().numpy()
        errs.append(err)
        print(f"[9 kernel R] {frames.shape[2]}x{frames.shape[1]}, {n} slots, "
              f"{int(lost.sum())} lost: {int((lost & (v > 0)).sum())} "
              f"refilled, {int((v == klt.NOT_FOUND).sum())} NOT_FOUND; "
              f"x, y, val equal to the plain version: {same}")
        check(same and err == 0, "kernel R differs from its plain version")
        check((lost & (v > 0)).any(), "kernel R refilled no slot")
        check(not ((v < 0) & (v != klt.NOT_FOUND)).any(),
              "a slot left lost is not NOT_FOUND")


@contextmanager
def recording_partitions(parts: list):
    """While open, each partition of the plain model appends (rows of the
    range, rows it moved) to parts."""
    real = select_sort.partition_plain

    def spy(rows, lo, hi):
        before = rows[lo:hi].clone()
        j = real(rows, lo, hi)
        parts.append((hi - lo, int((rows[lo:hi] != before).any(1).sum())))
        return j

    select_sort.partition_plain = spy
    try:
        yield
    finally:
        select_sort.partition_plain = real


def phase_select_sort(card, frames, cfg, errs_list, errs_part,
                      times) -> None:
    """Kernel S's two entries with the tracker's K0, S_MIN and ROUNDS on
    kernel D's maps of traffic frames (the sequential replacement's
    response): the list and its started state, then the whole list and
    the sort's state after the partitions, bit for bit against the plain
    version run on the card; then device times on the last map."""
    rows, cols = frames.shape[1:]
    win = (cfg.window_width, cfg.window_height)
    n = selection_ops.candidate_count(cfg, cols, rows)
    consts = (select_sort.K0, select_sort.S_MIN, select_sort.ROUNDS)
    out, p_out = (torch.empty((n, 3), dtype=torch.int32, device="cuda")
                  for _ in range(2))
    state, p_state = (torch.empty(3 + 2 * native.LAZY_PENDING,
                                  dtype=torch.int64, device="cuda")
                      for _ in range(2))
    scratch = scratch_for(n, out.device)
    made = []
    for k in SELECT_SORT_FRAMES:
        _, gx, gy = build_pyramid_stacks_cuda(
            torch.from_numpy(frames[k]).cuda(), cfg)[0]
        resp = corner_response_cuda(gx, gy, *win)
        candidate_list_cuda(resp, cfg, out, state)
        candidate_list_plain(resp, cfg, p_out, p_state)
        used = 3 + 2 * int(p_state[1])
        err_l = (out - p_out).abs().max().item()
        same_l = torch.equal(out, p_out) and \
            torch.equal(state[:used], p_state[:used])
        head_partitions_cuda(out, state, scratch, *consts)
        parts = []
        with recording_partitions(parts):
            head_partitions_plain(p_out, p_state, *consts)
        used = 3 + 2 * int(p_state[1])
        err_p = max((out - p_out).abs().max().item(),
                    (state[:used] - p_state[:used]).abs().max().item())
        same_p = torch.equal(out, p_out) and \
            torch.equal(state[:used], p_state[:used])
        pend = p_state[3:used].view(-1, 2).cpu()
        held = pend[(pend[:, 0] < consts[0]) & (pend[:, 1] >= consts[0])]
        reach = int(held[0, 1]) if len(held) else consts[0]
        errs_list.append(err_l)
        errs_part.append(err_p)
        made.append(parts)
        print(f"[43 kernel S] frame {k}, {cols}x{rows}, {n} rows: list and "
              f"state equal to the plain version: {same_l}; "
              f"{len(parts)} partitions ({sum(r for r, _ in parts)} rows "
              f"visited, {sum(m for _, m in parts)} moved), list and state "
              f"after them equal: {same_p}; the walk's head reaches row "
              f"{reach} of the {select_sort.prefix_rows(n)} that come back")
        check(same_l and err_l == 0,
              "kernel S's list entry differs from its plain version")
        check(same_p and err_p == 0,
              "kernel S's partition entry differs from its plain version")
        check(len(parts) == consts[2] or
              reach <= select_sort.prefix_rows(n),
              "a range the walk's head meets ends past the rows that come "
              "back")

    def both(list_fn, part_fn, o, st, *extra):
        list_fn(resp, cfg, o, st)
        part_fn(o, st, *extra, *consts)

    l_ms, l_host = kernel_times(
        lambda: candidate_list_cuda(resp, cfg, out, state), 200)
    b_ms, b_host = kernel_times(
        lambda: both(candidate_list_cuda, head_partitions_cuda, out, state,
                     scratch), 100, launches=2)
    l_plain = cuda_ms(lambda: candidate_list_plain(resp, cfg, p_out,
                                                   p_state), 3)
    b_plain = cuda_ms(lambda: both(candidate_list_plain,
                                   head_partitions_plain, p_out, p_state), 2)
    l_bound = bound(*select_list_work(n))
    p_bound = bound(*select_partitions_work(made[-1]))
    us = lambda ms: f"{ms * 1e3:.1f}"
    print(f"[43 kernel S] {card} | frame {SELECT_SORT_FRAMES[-1]}, device us "
          f"per call (bound; host enqueue; plain version on the card): list "
          f"entry {us(l_ms)} ({us(l_bound[0])} by {l_bound[1]}; "
          f"{us(l_host)}; {us(l_plain)}), partition entry {us(b_ms - l_ms)} "
          f"for {len(made[-1])} partitions, one cooperative launch "
          f"({us(p_bound[0])} by {p_bound[1]}; {us(b_host - l_host)}; "
          f"{us(b_plain - l_plain)}); the partition entry's times are those "
          f"of list and partitions less the list's", flush=True)
    times["select_list"] = {"ms": l_ms, "plain_ms": l_plain,
                            "bound_ms": l_bound[0], "bound_by": l_bound[1]}
    times["select_partitions"] = {
        "ms": b_ms - l_ms, "plain_ms": b_plain - l_plain,
        "bound_ms": p_bound[0], "bound_by": p_bound[1]}


def phase_replace_cases(errs) -> None:
    """Kernel R against its plain version on the adversarial states of
    replace_cases."""
    for name, kw, resp, x, y, val in replace_cases():
        cfg = klt.TrackingConfig(**kw)
        respd = torch.from_numpy(resp).cuda()
        outs = []
        for fn in (replace_lost_cuda_, replace_lost_plain_):
            state = [torch.from_numpy(a.copy()).cuda() for a in (x, y, val)]
            fn(respd, *state, cfg)
            outs.append(state)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(*outs)) if len(val) else 0.0
        v = outs[0][2].cpu().numpy()
        lost = val < 0
        errs.append(err)
        print(f"[9 kernel R] {name}: {resp.shape[1]}x{resp.shape[0]} map, "
              f"mindist {cfg.mindist}, {len(val)} slots, {int(lost.sum())} "
              f"lost: {int((lost & (v > 0)).sum())} refilled, "
              f"{int((lost & (v == klt.NOT_FOUND)).sum())} left NOT_FOUND; "
              f"x, y, val equal to the plain version: {same}")
        check(same and err == 0, f"kernel R differs from its plain version "
              f"({name})")
        check(not ((v < 0) & (v != klt.NOT_FOUND)).any(),
              "a slot left lost is not NOT_FOUND")
        check(name.startswith("no slot") == (not (lost & (v > 0)).any()),
              f"unexpected refills ({name})")


def tracker_replace_loop(frames, fl, cfg, table=None):
    """KLTracker on the card, per frame track_features then
    replace_lost_features (example3's REPLACE flow); fl is updated in place.
    Returns (per-frame [T-1, N] val rows, the number of frames on which
    features were lost, seconds)."""
    tracker = klt.KLTracker(cfg, device="cuda")
    rows, with_lost = [], 0
    t0 = time.perf_counter()
    for i in range(1, frames.shape[0]):
        tracker.track_features(frames[i - 1], frames[i], fl)
        with_lost += int((fl.val < 0).any())
        tracker.replace_lost_features(frames[i], fl)
        rows.append(fl.copy())
        if table is not None:
            table.store_list(fl, i)
    return rows, with_lost, time.perf_counter() - t0


def status_agreement(vs, rows) -> np.ndarray:
    """Per-frame share of slots with the same val in a [T-1, N] table and
    a KLTracker run's rows."""
    return np.array([(vs[t] == r.val).mean() for t, r in enumerate(rows)])


def run_replace_flagship(frames, n_feats, cfg, tag) -> int:
    """The example3 REPLACE flow at 320x240 through KLTracker (table and an
    overlay written), then track_sequence_replace on the same frames.
    Returns the frames on which KLTracker replaced."""
    fl = klt.FeatureList.create(n_feats)
    klt.KLTracker(cfg, device="cuda").select_good_features(frames[0], fl)
    start = fl.copy()
    t_len = frames.shape[0]
    table = klt.FeatureTable.create(t_len, n_feats)
    table.store_list(fl, 0)
    rows, with_lost, secs = tracker_replace_loop(frames, fl, cfg, table)

    feats = [torch.from_numpy(a).cuda() for a in
             (start.x, start.y, start.val)]
    xs, ys, vs = (a.cpu().numpy() for a in track_sequence_replace(
        torch.from_numpy(frames).cuda(), *feats, cfg))
    check(xs.shape == (t_len - 1, n_feats) and np.isfinite(xs).all() and
          np.isfinite(ys).all(), "bad track_sequence_replace table")
    agree = status_agreement(vs, rows)
    exact = np.mean([np.array_equal(vs[t], r.val) and
                     np.array_equal(xs[t], r.x) for t, r in enumerate(rows)])
    cpu = [a.numpy() for a in track_sequence_replace(
        torch.from_numpy(frames),
        *[torch.from_numpy(a) for a in (start.x, start.y, start.val)], cfg)]
    card_cpu = all(np.array_equal(a, b) for a, b in zip((xs, ys, vs), cpu))
    refilled = (vs > 0).sum(axis=1)
    print(f"[{tag}] {frames.shape[2]}x{frames.shape[1]}, {t_len} frames, "
          f"{n_feats} features: KLTracker loop {secs:.3f} s; replaced per "
          f"frame {refilled.tolist()}; track_sequence_replace vs KLTracker "
          f"status agreement min {agree.min():.4f} (frames identical: "
          f"{exact:.2f}); card bit-equal to the CPU plain run: {card_cpu}")
    check(agree.min() >= 0.97, "track_sequence_replace and KLTracker disagree")
    check(card_cpu, "card run differs from the plain CPU run")
    check(refilled.sum() > 0, "no feature was replaced")

    with tempfile.TemporaryDirectory() as d:
        klt.write_feature_table(table, os.path.join(d, "features.txt"),
                                "%5.1f")
        klt.write_feature_table(table, os.path.join(d, "features.ft"))
        back = klt.read_feature_table(os.path.join(d, "features.ft"))
        check(np.array_equal(back.val, table.val), "table round trip")
        ppm = os.path.join(d, f"feat{t_len - 1}.ppm")
        klt.write_feature_list_ppm(fl, frames[-1], ppm)
        with open(ppm, "rb") as f:
            data = f.read()
        want = frames.shape[1] * frames.shape[2] * 3
        check(data.startswith(f"P6\n{frames.shape[2]} {frames.shape[1]}\n"
                              "255\n".encode()) and
              len(data) - data.index(b"255\n") - 4 == want, "bad overlay")
        print(f"[{tag}] wrote the feature table and feat{t_len - 1}.ppm "
              f"({len(data)} bytes, {fl.count_remaining()} features drawn)")
    return with_lost


def known_motion_errors(xs, ys, vs, start, max_age=100):
    """Per frame k, the error of every TRACKED feature younger than
    max_age frames against shift(k) - shift(birth), birth being frame 0
    for the selected features and the frame a slot was refilled on for
    replaced ones.  Returns (per-frame error arrays, older errors)."""
    n_rows, n = vs.shape
    bx, by = start.x.astype(np.float64), start.y.astype(np.float64)
    born = np.zeros(n, np.int64)
    per_frame, older = [], []
    for t in range(n_rows):
        k = t + 1
        tx, ty = shift(k)
        ok = vs[t] == klt.TRACKED
        sx = np.array([shift(b)[0] for b in born])
        sy = np.array([shift(b)[1] for b in born])
        err = np.maximum(np.abs(xs[t] - (bx + tx - sx)),
                         np.abs(ys[t] - (by + ty - sy)))
        young = ok & (k - born < max_age)
        per_frame.append(err[young])
        older.append(err[ok & ~young])
        new = vs[t] > 0
        born[new] = k
        bx[new], by[new] = xs[t][new], ys[t][new]
    return per_frame, np.concatenate(older) if older else np.zeros(0)


def check_known_motion(tag, xs, ys, vs, start) -> None:
    """The known motion of a replace run's table: bounds per frame and
    pooled (see below), printed; raises when they fail."""
    # Bounds per frame where at least MIN_YOUNG features are young: after
    # frame 100 only the few replaced features are, and they sit on the
    # border band's last rows (the interior's corners are all held), so a
    # frame's median is then one or two correlated features.  Every young
    # observation of the run is also bounded, pooled.
    per_frame, older = known_motion_errors(xs, ys, vs, start)
    sizes = np.array([e.size for e in per_frame])
    meds = np.array([np.median(e) if e.size else 0.0 for e in per_frame])
    fracs = np.array([(e <= 1.0).mean() if e.size else 1.0
                      for e in per_frame])
    big = sizes >= MIN_YOUNG
    pooled = np.concatenate(per_frame)
    print(f"[{tag}] known motion, features younger than 100 frames: "
          f"{pooled.size} observations, median {np.median(pooled):.4f} px, "
          f"within 1 px {(pooled <= 1.0).mean():.4f}; over the {big.sum()} "
          f"frames with >= {MIN_YOUNG} young features: worst median "
          f"{meds[big].max():.4f} px, worst share within 1 px "
          f"{fracs[big].min():.4f}; over all frames (down to "
          f"{sizes.min()} young features): worst median {meds.max():.4f} px "
          f"(frame {int(meds.argmax()) + 1}, {sizes[meds.argmax()]} "
          f"features), worst share within 1 px {fracs.min():.4f}")
    print(f"[{tag}] older features (reported, not bounded): {older.size} "
          f"observations, median "
          f"{np.median(older) if older.size else 0.0:.4f} px, within 1 px "
          f"{(older <= 1.0).mean() if older.size else 1.0:.4f}")
    check(np.median(pooled) <= 0.5 and (pooled <= 1.0).mean() >= 0.90,
          "young features' errors above the bounds")
    check(meds[big].max() <= 0.5, "a frame's median error is above 0.5 px")
    check(fracs[big].min() >= 0.90,
          "under 90% of a frame's tracks within 1 px")


def run_replace_traffic(frames, n_feats, cfg, tag, n_cpu) -> int:
    """The traffic configuration's replace run: track_sequence_replace
    with kernels and with precomp, KLTracker, the CPU plain run over the
    first n_cpu frames, replacement counts and the known motion.  Returns
    the frames on which KLTracker replaced."""
    t_len = frames.shape[0]
    n_cpu = min(n_cpu, t_len - 1)
    fl = klt.FeatureList.create(n_feats)
    klt.KLTracker(cfg, device="cuda").select_good_features(frames[0], fl)
    start = fl.copy()
    n_sel = start.count_remaining()
    dev_frames = torch.from_numpy(frames).cuda()
    feats = [torch.from_numpy(a).cuda() for a in
             (start.x, start.y, start.val)]
    t0 = time.perf_counter()
    out = track_sequence_replace(dev_frames, *feats, cfg)
    torch.cuda.synchronize()
    t_kern = time.perf_counter() - t0
    t0 = time.perf_counter()
    pre = track_sequence_replace(dev_frames, *feats, cfg, precomp=True)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    same_pre = all(torch.equal(a, b) for a, b in zip(out, pre))
    xs, ys, vs = (a.cpu().numpy() for a in out)
    check(np.isfinite(xs).all() and np.isfinite(ys).all() and
          xs.shape == (t_len - 1, n_feats), "bad track_sequence_replace table")

    rows, with_lost, t_tr = tracker_replace_loop(frames, start.copy(), cfg)
    agree = status_agreement(vs, rows)

    cpu = [a.numpy() for a in track_sequence_replace(
        torch.from_numpy(frames[:n_cpu + 1]),
        *[torch.from_numpy(a) for a in (start.x, start.y, start.val)], cfg)]
    card_cpu = all(np.array_equal(a[:n_cpu], b)
                   for a, b in zip((xs, ys, vs), cpu))

    refilled = (vs > 0).sum(axis=1)
    alive = (vs >= 0).sum(axis=1)
    print(f"[{tag}] {frames.shape[2]}x{frames.shape[1]}, {t_len} frames, "
          f"{n_sel} of {n_feats} requested features selected: "
          f"track_sequence_replace {t_kern:.3f} s, with precomp {t_pre:.3f} s "
          f"(bit-equal: {same_pre}), KLTracker loop {t_tr:.3f} s")
    print(f"[{tag}] replaced per frame: {refilled.tolist()}")
    print(f"[{tag}] frames with replacements {int((refilled > 0).sum())} of "
          f"{t_len - 1}; features alive per frame min {alive.min()}, "
          f"median {np.median(alive):.0f}; track_sequence_replace vs "
          f"KLTracker status agreement min {agree.min():.4f}, median "
          f"{np.median(agree):.4f}; card bit-equal to the CPU plain run "
          f"over {n_cpu} frames: {card_cpu}")
    check(same_pre, "precomp=True differs from precomp=False")
    check(card_cpu, "card run differs from the plain CPU run")
    check(agree.min() >= 0.97,
          "track_sequence_replace and KLTracker disagree on a frame")
    check((refilled > 0).sum() >= (t_len - 1) / 2,
          "replacement filled slots on under half of the frames")

    check_known_motion(tag, xs, ys, vs, start)
    return with_lost


def phase_no_sync(frames, n_feats, cfg) -> None:
    """track_sequence_replace's frame loop with kernels, frames and
    features on the card, under torch's sync debug mode "error": any
    host synchronisation inside raises.  Runs before it capture the
    graphs (a capture synchronises once)."""
    fl = klt.FeatureList.create(n_feats)
    klt.KLTracker(cfg).select_good_features(frames[0], fl)
    dev_frames = torch.from_numpy(frames).cuda()
    feats = [torch.from_numpy(a).cuda() for a in (fl.x, fl.y, fl.val)]
    for pre in (False, True):
        track_sequence_replace(dev_frames, *feats, cfg, precomp=pre)
        track_sequence_replace(dev_frames, *feats, cfg, precomp=pre)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for pre in (False, True):
            track_sequence_replace(dev_frames, *feats, cfg, precomp=pre)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"[12 no sync] track_sequence_replace over {len(frames)} frames "
          f"of {frames.shape[2]}x{frames.shape[1]}, with and without "
          f"precomp, ran under sync debug mode \"error\": no host sync")


def phase_replace_times(card, frames, n_feats, cfg, times,
                        per_step) -> None:
    size = f"{frames.shape[2]}x{frames.shape[1]}"
    fl = klt.FeatureList.create(n_feats)
    klt.KLTracker(cfg).select_good_features(frames[0], fl)
    dev_frames = torch.from_numpy(frames).cuda()
    feats = [torch.from_numpy(a).cuda() for a in (fl.x, fl.y, fl.val)]
    n_plain = min(101, len(frames))
    runs = lambda v: [round(f, 1) for f in v]
    k_fps = sequence_fps(dev_frames, feats, cfg, False, 3,
                         seq=track_sequence_replace)
    p_fps = sequence_fps(dev_frames, feats, cfg, False, 3,
                         seq=track_sequence_replace, precomp=True)
    c_fps = sequence_fps(dev_frames[:n_plain], feats, cfg, True, 1,
                         seq=track_sequence_replace)
    print(f"[13 times] {card} | track_sequence_replace {size}, "
          f"{len(frames)} frames, {int((fl.val >= 0).sum())} features: "
          f"kernels {np.median(k_fps):.1f} frames/s = "
          f"{1e6 / np.median(k_fps):.1f} us of wall per step (runs "
          f"{runs(k_fps)}), "
          f"precomp {np.median(p_fps):.1f} frames/s (runs {runs(p_fps)}), "
          f"plain torch on the card {np.median(c_fps):.1f} frames/s over "
          f"{n_plain} frames (runs {runs(c_fps)})", flush=True)

    per_step["track_sequence_replace"] = launches_per_step(
        lambda: track_sequence_replace(dev_frames, *feats, cfg),
        len(frames) - 1)
    per_step["track_sequence_replace, precomp"] = launches_per_step(
        lambda: track_sequence_replace(dev_frames, *feats, cfg,
                                       precomp=True), len(frames) - 1)

    win = (cfg.window_width, cfg.window_height)
    rows, cols = frames.shape[1:]
    _, gx, gy = build_pyramid_stacks_cuda(dev_frames[1], cfg)[0]
    d_ms, d_host = kernel_times(lambda: corner_response_cuda(gx, gy, *win),
                                200)
    d_plain = cuda_ms(lambda: corner_response_plain(gx, gy, *win), 20)
    d_bound = bound(*response_work(rows, cols, cfg))
    batch = dev_frames[1:1 + PRECOMP_FRAMES]
    e_ms, e_host = kernel_times(
        lambda: build_pyramid_stacks_batched_cuda(batch, cfg), 20, launches=3)
    e_plain = cuda_ms(lambda: build_pyramid_stacks_batched_plain(batch, cfg),
                      2)
    e_bound = bound(*pyramid_work(batch, cfg, len(batch)))
    a_ms, _ = kernel_times(lambda: build_pyramid_stacks_cuda(batch[0], cfg),
                           100, launches=3)
    lost, resp = lost_state(frames, n_feats, cfg, 5)
    state = [torch.from_numpy(a).cuda() for a in (lost.x, lost.y, lost.val)]
    fresh = lambda: [a.clone() for a in state]
    clone_ms, _ = kernel_times(fresh, 100, launches=3)
    r_ms, r_host = kernel_times(
        lambda: replace_lost_cuda_(resp, *fresh(), cfg), 100, launches=4)
    r_plain = cuda_ms(lambda: replace_lost_plain_(resp, *fresh(), cfg), 5)
    r0_ms, _ = kernel_times(lambda: replace_lost_cuda_(resp, *feats, cfg),
                            100)
    n_lost = int((lost.val < 0).sum())
    r_bound = bound(*replace_work(rows, cols, n_feats, n_lost))
    us = lambda ms: f"{ms * 1e3:.1f}"
    print(f"[13 times] {card} | {size}, device us per call (bound; host "
          f"enqueue; plain version on the card): kernel D {us(d_ms)} = "
          f"{d_bound[0] / d_ms:.3f} of its bound "
          f"({us(d_bound[0])} by {d_bound[1]}; {us(d_host)}; {us(d_plain)}); "
          f"kernel E {us(e_ms)} per launch of {len(batch)} frames = "
          f"{e_ms * 1e3 / len(batch):.2f} per frame ({us(e_bound[0])} by "
          f"{e_bound[1]}; {us(e_host)}; {us(e_plain)}; kernel A "
          f"{us(a_ms)} per frame); kernel R with {n_lost} of {n_feats} "
          f"slots lost {us(r_ms)} ({us(r_bound[0])} by {r_bound[1]}; "
          f"{us(r_host)}; {us(r_plain)}), with {us(clone_ms)} of input "
          f"copies in the kernel's and the plain version's time; with no "
          f"slot lost {us(r0_ms)}", flush=True)
    for name, ms, plain, bnd in (
            ("corner_response", d_ms, d_plain, d_bound),
            ("pyramid_batched", e_ms, e_plain, e_bound),
            ("replace_lost", r_ms, r_plain, r_bound)):
        times[name] = {"ms": ms, "plain_ms": plain, "bound_ms": bnd[0],
                       "bound_by": bnd[1]}


PYRAMID_KERNELS = ("pyramid_tiles", "hpass_global", "vpass_global")


def profile_device(run, steps: int, tag: str, label: str, groups,
                   expect=None, per_step=None, host: bool = True):
    """torch.profiler over run() (after one warm-up run): device busy
    share of the wall time, and each group of kernels' share of device
    time; groups maps a name to the kernel-name substrings it covers,
    expect a group's name to the device launches the run must make of
    it, per_step is the number of all device launches a step that the run
    must make, to a tenth.

    The profiler now and then drops the first device events of its
    window (none in a process's first seconds, a handful in one that has
    tracked for a minute or two, a marker kernel at the head of the window
    among them), and the last ones (the closing marker among them after
    some 18,000 launches in the window).  So the window opens with a run
    that is not read, and the run that is read lies between two marker
    kernels, the second followed by a pause and launches that are not
    read (profiling.close_window): only the device events between the
    markers are counted, the events before the first marker are counted
    to show the loss, and a profile without both markers is not read at
    all.
    A profile that differs from the expected counts is taken once more,
    and the second one must match.  Returns the read profile's device us
    and device launches per step ({"device_us", "launches"}), None when
    the profiler recorded no device event.  host=False traces the device
    alone (no CPU activity: a cheaper profile of tens of thousands of
    launches)."""
    run()
    torch.cuda.synchronize()
    for attempt in (1, 2):
        wrong, read = _profile_once(run, steps, tag, label, groups, expect,
                                    per_step, host)
        if not wrong:
            return read
        print(f"[{tag}] {'; '.join(wrong)}"
              f"{': profiling once more' if attempt == 1 else ''}")
    check(False, "; ".join(wrong))


def _profile_once(run, steps, tag, label, groups, expect, per_step,
                  host=True):
    """One profiled run of profile_device, printed; returns what differs
    from the expected launch counts, a list of messages, and the device
    us and launches per step read."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU] * host +
                 [ProfilerActivity.CUDA]) as prof:
        run()   # not read: the window's first device events may be lost
        profiling.marker()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        profiling.close_window()
    events = sorted((ev for ev in prof.events()
                     if "CUDA" in str(ev.device_type)),
                    key=lambda ev: ev.time_range.start)
    if not events:
        print(f"[{tag}] the profiler recorded no device event: device "
              "busy share not measured")
        return [], None
    marks = [i for i, ev in enumerate(events) if "spin_kernel" in ev.name]
    if len(marks) != 2:
        return [f"{len(marks)} of the 2 marker kernels in the profile"], None
    dev_us, dev_n = {}, {}
    for ev in events[marks[0] + 1:marks[1]]:
        dev_us[ev.name] = dev_us.get(ev.name, 0.0) + \
            ev.time_range.elapsed_us()
        dev_n[ev.name] = dev_n.get(ev.name, 0) + 1
    total = sum(dev_us.values())
    shares, covered, ours, wrong = [], 0.0, 0, []
    for name, keys in groups.items():
        keys = keys if isinstance(keys, tuple) else (keys,)
        mine = [k for k in dev_us if any(s in k for s in keys)]
        us = sum(dev_us[k] for k in mine)
        n_mine = sum(dev_n[k] for k in mine)
        ours += n_mine
        covered += us
        shares.append(f"{name} {us / total:.3f} ({us / steps:.1f} us/step, "
                      f"{n_mine} device launches)")
        want = (expect or {}).get(name)
        if want is not None and n_mine != want:
            wrong.append(f"{name}: {n_mine} device launches, expected "
                         f"{want}")
    print(f"[{tag}] the same run at the head of the profiler's window, not "
          f"read: {marks[0]} of {marks[1] - marks[0] - 1} device events "
          f"recorded; after the closing marker {len(events) - marks[1] - 1} "
          f"of {profiling.TAIL_LAUNCHES} launches, not read; "
          f"{time.perf_counter() - PROCESS_START:.0f} s into the process")
    print(f"[{tag}] {label}, {steps} steps (profiler on): wall "
          f"{wall * 1e6 / steps:.1f} us per step, device busy "
          f"{total / (wall * 1e6):.3f} of the wall time "
          f"({total / steps:.1f} us of device time per step); device "
          f"launches per step {sum(dev_n.values()) / steps:.1f}, of which "
          f"torch's own (copies, fills, glue) "
          f"{(sum(dev_n.values()) - ours) / steps:.1f}; share of device "
          f"time: " + "; ".join(shares) + f"; other (torch glue) "
          f"{1 - covered / total:.3f}")
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    for k, v in top:
        print(f"[{tag}]   {v / steps:9.1f} us/step  {k[:90]}")
    if per_step is not None and \
            abs(sum(dev_n.values()) / steps - per_step) > 0.1:
        wrong.append(f"{sum(dev_n.values()) / steps:.2f} device launches "
                     f"per step, expected {per_step}")
    return wrong, {"device_us": total / steps,
                   "launches": sum(dev_n.values()) / steps}


def phase_profile(frames, n_feats, cfg) -> None:
    """torch.profiler over track_sequence_replace with kernels."""
    fl = klt.FeatureList.create(n_feats)
    klt.KLTracker(cfg).select_good_features(frames[0], fl)
    dev_frames = torch.from_numpy(frames).cuda()
    feats = [torch.from_numpy(a).cuda() for a in (fl.x, fl.y, fl.val)]
    profile_device(
        lambda: track_sequence_replace(dev_frames, *feats, cfg),
        len(frames) - 1, "14 profile",
        f"track_sequence_replace of {frames.shape[2]}x{frames.shape[1]}",
        {"kernel R (replace_lost)": "replace_lost",
         "kernel D (response_tiles)": ("response_tiles", "hsum_products",
                                       "vsum_eigen"),
         "kernel B (lk_pyramid_kernel)": "lk_pyramid_kernel",
         "kernel A (pyramid_tiles)": PYRAMID_KERNELS},
        # one launch of R and one of D a step; the pre-smoothing and one
        # launch per level for each frame's pyramid; with B and torch's
        # three copies of the table's rows 9.0 launches a step (the first
        # frame's pyramid adds 3 / steps, the graphed loop its copies)
        expect={"kernel R (replace_lost)": len(frames) - 1,
                "kernel D (response_tiles)": len(frames) - 1,
                "kernel A (pyramid_tiles)":
                    len(frames) * (1 + cfg.n_pyramid_levels)},
        per_step=9.0 + (1 + cfg.n_pyramid_levels) / (len(frames) - 1) +
        graph_overhead(len(frames) - 1, cfg.n_pyramid_levels))


def phase_profile_tracking(frames, n_feats, cfg) -> None:
    """torch.profiler over track_sequence with kernels."""
    fl = klt.FeatureList.create(n_feats)
    klt.KLTracker(cfg).select_good_features(frames[0], fl)
    dev_frames = torch.from_numpy(frames).cuda()
    feats = [torch.from_numpy(a).cuda() for a in (fl.x, fl.y, fl.val)]
    profile_device(
        lambda: track_sequence(dev_frames, *feats, cfg),
        len(frames) - 1, "14 profile",
        f"track_sequence of {frames.shape[2]}x{frames.shape[1]}, "
        f"{int((fl.val >= 0).sum())} features",
        {"kernel B (lk_pyramid_kernel)": "lk_pyramid_kernel",
         "kernel A (pyramid_tiles)": PYRAMID_KERNELS},
        expect={"kernel A (pyramid_tiles)":
                len(frames) * (1 + cfg.n_pyramid_levels)})


# ------------------------------------------------------------------ #
# batched multi-sequence phases                                        #
# ------------------------------------------------------------------ #

def batched_features(frames, n_feats: int, cfg):
    """Features selected on each sequence's frame 0: numpy x, y f32 and
    val i32 [B, n_feats]; slots selection leaves empty hold val -1."""
    b = frames.shape[0]
    x = np.zeros((b, n_feats), np.float32)
    y = np.zeros((b, n_feats), np.float32)
    val = np.full((b, n_feats), -1, np.int32)
    for i in range(b):
        fl = klt.FeatureList.create(n_feats)
        klt.KLTracker(cfg).select_good_features(frames[i, 0], fl)
        x[i], y[i], val[i] = fl.x, fl.y, fl.val
    return x, y, val


def batched_level_inputs(feats, cfg, r):
    """Kernel C inputs at level r, [B, N] on the card: positions scaled
    down by repeated division, guess = start."""
    x, y = (torch.from_numpy(a).cuda() for a in feats[:2])
    s = float(np.float32(cfg.subsampling))
    for _ in range(r):
        x, y = x / s, y / s
    return x, y, x.clone(), y.clone(), torch.from_numpy(feats[2] >= 0).cuda()


def frame_pair_stacks(frames, cfg):
    """Kernel E stacks [B, 3, H_l, W_l] of every sequence's frames 0 and
    1."""
    return [build_pyramid_stacks_batched_cuda(
        torch.from_numpy(np.ascontiguousarray(frames[:, k])).cuda(), cfg)
        for k in (0, 1)]


def phase_batched_lk(cases, cfgs, errs) -> None:
    """Kernel C against its plain version on the card, and lane by lane
    against kernel B on its own sequence, at both levels."""
    for frames, feats in cases:
        size = (f"{frames.shape[0]} x {frames.shape[3]}x{frames.shape[2]} x "
                f"{feats[0].shape[1]}")
        for cfg in cfgs:
            st1, st2 = frame_pair_stacks(frames, cfg)
            for r in range(cfg.n_pyramid_levels):
                inputs = batched_level_inputs(feats, cfg, r)
                got = lk_level_batched_cuda(st1[r], st2[r], *inputs, cfg,
                                            r == 0)
                ref = lk_level_batched_plain(st1[r], st2[r], *inputs, cfg,
                                             r == 0)
                lanes = [lk_level_cuda(st1[r][b], st2[r][b],
                                       *[a[b] for a in inputs], cfg, r == 0)
                         for b in range(frames.shape[0])]
                torch.cuda.synchronize()
                err = max((a.double() - b.double()).abs().max().item()
                          for a, b in zip(got, ref))
                same = all(torch.equal(a, b) for a, b in zip(got, ref))
                same_b = all(torch.equal(g[b], lane[i])
                             for b, lane in enumerate(lanes)
                             for i, g in enumerate(got))
                act = inputs[4]
                errs.append(err)
                tag = "lighting" if cfg.lighting_insensitive else "default"
                print(f"[15 kernel C] {size} {tag} level {r}: "
                      f"{int(act.sum())} live lanes, max |kernel - plain| "
                      f"{err:.3g} (bit-equal: {same}); every lane equal to "
                      f"kernel B on its sequence: {same_b}; statuses "
                      f"{sorted(set(got[2][act].tolist()))}")
                check(err == 0 and same, "kernel C differs from its plain "
                      "version")
                check(same_b, "kernel C differs from kernel B on a lane")


def batched_launches_expected(shape, cfg) -> dict:
    """Kernel launches of one track_sequences_batched run and one with
    precomp on [B, T, H, W] frames: kernel E once per frame index (with
    precomp once for the first and then per chunk, precomp_launches),
    kernel C's pyramid entry once per step."""
    b, t_len = shape[:2]
    want = {k.symbol: 0 for k in cuda.KERNELS}
    want[cuda.PYRAMID_BATCHED.symbol] = t_len + 1 + precomp_launches(
        t_len - 1, b)
    want[cuda.LK_PYRAMID_BATCHED.symbol] = 2 * (t_len - 1)
    return want


def run_batched(frames, feats, cfg, tag, n_cpu: int) -> dict:
    """The batched main path: track_sequences_batched with kernels and
    with precomp (launches counted), then checks: every lane bit-equal to
    track_sequence on the card, the first n_cpu lanes bit-equal to the
    plain run on the CPU, padded lanes untouched, the known motion per
    lane, the TRACKED share.  Returns the main path's launch counts."""
    b, t_len = frames.shape[:2]
    dev_frames = torch.from_numpy(frames).cuda()
    featd = [torch.from_numpy(a).cuda() for a in feats]
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    out = track_sequences_batched(dev_frames, *featd, cfg)
    torch.cuda.synchronize()
    t_kern = time.perf_counter() - t0
    t0 = time.perf_counter()
    pre = track_sequences_batched(dev_frames, *featd, cfg, precomp=True)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in cuda.KERNELS}
    want = batched_launches_expected(frames.shape, cfg)
    print(f"[{tag}] launches {launches} (expected {want})")
    check(launches == want, "batched path launch counts differ from the "
          "expected")

    same_pre = all(torch.equal(a, c) for a, c in zip(out, pre))
    xs, ys, vs = (a.cpu().numpy() for a in out)
    check(xs.shape == (t_len - 1,) + feats[0].shape and
          np.isfinite(xs).all() and np.isfinite(ys).all(),
          "bad track_sequences_batched table")
    lanes_equal = all(
        all(torch.equal(o[:, i], one)
            for o, one in zip(out, track_sequence(
                dev_frames[i], *[a[i] for a in featd], cfg)))
        for i in range(b))
    cpu = track_sequences_batched(
        torch.from_numpy(frames[:n_cpu]),
        *[torch.from_numpy(a[:n_cpu]) for a in feats], cfg)
    card_cpu = all(np.array_equal(a[:, :n_cpu], c.numpy())
                   for a, c in zip((xs, ys, vs), cpu))
    sel = feats[2] >= 0
    untouched = bool((vs[:, ~sel] == -1).all())
    n_sel = sel.sum(axis=1)
    print(f"[{tag}] {b} sequences of {frames.shape[3]}x{frames.shape[2]}, "
          f"{t_len} frames, {feats[0].shape[1]} features requested, "
          f"selected per sequence min {n_sel.min()} max {n_sel.max()} "
          f"(total {n_sel.sum()}): track_sequences_batched {t_kern:.3f} s, "
          f"with precomp {t_pre:.3f} s (bit-equal: {same_pre}); every lane "
          f"bit-equal to track_sequence on the card: {lanes_equal}; the "
          f"first {n_cpu} lanes bit-equal to the plain CPU run: {card_cpu}; "
          f"padded slots untouched: {untouched}")
    check(same_pre, "precomp=True differs from precomp=False")
    check(lanes_equal, "a batched lane differs from track_sequence")
    check(card_cpu, "card run differs from the plain CPU run")
    check(untouched, "a padded slot changed")

    final = (vs[-1] == klt.TRACKED)[sel].mean()
    lane_final = [(vs[-1, i] == klt.TRACKED)[sel[i]].mean()
                  for i in range(b)]
    print(f"[{tag}] still TRACKED at frame {t_len - 1}: {final:.4f} "
          f"(per sequence min {min(lane_final):.4f})")
    check(final >= 0.90, f"only {final} still tracked")

    worst_1, worst_med, worst_frac = 0.0, 0.0, 1.0
    for i in range(b):
        x0, y0 = feats[0][i], feats[1][i]
        for k in range(1, t_len):
            tx, ty = lane_shift(i, k)
            ok = sel[i] & (vs[k - 1, i] == klt.TRACKED)
            err = np.maximum(np.abs(xs[k - 1, i][ok] - x0[ok] - tx),
                             np.abs(ys[k - 1, i][ok] - y0[ok] - ty))
            med = float(np.median(err))
            if k == 1:
                worst_1 = max(worst_1, med)
            worst_med = max(worst_med, med)
            worst_frac = min(worst_frac, float((err <= 1.0).mean()))
    print(f"[{tag}] error against each sequence's known motion: worst "
          f"frame-1 median {worst_1:.4f} px, worst frame median "
          f"{worst_med:.4f} px, worst share within 1 px {worst_frac:.4f}")
    check(worst_1 <= 0.15, "a frame-1 median error above 0.15 px")
    check(worst_med <= 0.5, "a frame's median error is above 0.5 px")
    check(worst_frac >= 0.90, "under 90% of a frame's tracks within 1 px")

    torch.cuda.set_sync_debug_mode("error")
    try:
        track_sequences_batched(dev_frames, *featd, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"[{tag}] track_sequences_batched ran under sync debug mode "
          f"\"error\": no host sync")
    return launches


def batched_fps(run, n_frames: int, reps: int) -> list[float]:
    """Aggregate frames/s (frames tracked into, all sequences) of run(),
    host clock around synchronised runs, after one warm-up run."""
    run()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append(n_frames / (time.perf_counter() - t0))
    return out


def phase_batched_times(card, cases, cfg, times, per_step) -> None:
    for frames, feats, reps in cases:
        b, t_len = frames.shape[:2]
        size = f"{b} x {frames.shape[3]}x{frames.shape[2]}"
        dev_frames = torch.from_numpy(frames).cuda()
        featd = [torch.from_numpy(a).cuda() for a in feats]
        n = b * (t_len - 1)
        runs = lambda v: [round(f, 1) for f in v]
        k_fps = batched_fps(lambda: track_sequences_batched(
            dev_frames, *featd, cfg), n, reps)
        p_fps = batched_fps(lambda: track_sequences_batched(
            dev_frames, *featd, cfg, precomp=True), n, reps)
        c_fps = batched_fps(lambda: track_sequences_batched(
            dev_frames, *featd, cfg, plain=True), n, 2)
        one_fps = batched_fps(lambda: [track_sequence(
            dev_frames[i], *[a[i] for a in featd], cfg) for i in range(b)],
            n, max(2, reps // 2))
        print(f"[18 times] {card} | track_sequences_batched {size}, "
              f"{t_len} frames, {feats[0].shape[1]} features requested, "
              f"aggregate frames/s over all sequences: kernels "
              f"{np.median(k_fps):.1f} = "
              f"{1e6 * b / np.median(k_fps):.1f} us of wall per step (runs "
              f"{runs(k_fps)}), precomp "
              f"{np.median(p_fps):.1f} (runs {runs(p_fps)}), plain torch on "
              f"the card {np.median(c_fps):.1f} (runs {runs(c_fps)}); the "
              f"same {b} sequences one at a time through track_sequence "
              f"{np.median(one_fps):.1f} (runs {runs(one_fps)})", flush=True)

        per_step.setdefault("track_sequences_batched", launches_per_step(
            lambda: track_sequences_batched(dev_frames, *featd, cfg),
            t_len - 1))

        st1, st2 = frame_pair_stacks(frames, cfg)
        args = (st1[0], st2[0], *batched_level_inputs(feats, cfg, 0), cfg,
                True)
        c_ms, c_host = kernel_times(lambda: lk_level_batched_cuda(*args), 200)
        c_plain = cuda_ms(lambda: lk_level_batched_plain(*args), 5)
        c_bound = lk_level_bound(lk_level_batched_cuda(*args), args[6], cfg,
                                 True)
        p_ms, p_host = kernel_times(
            lambda: lk_pyramid_batched_cuda(st1, st2, *featd, cfg), 200)
        p_plain = cuda_ms(lambda: track_features_pyramid_stacks(
            st1, st2, *featd, cfg, plain=True), 3)
        p_bound = bound(*lk_pyramid_work(st1, st2, featd, cfg))
        l_ms = cuda_ms(lambda: track_features_pyramid_levels(
            st1, st2, *featd, cfg), 20)
        pairs = [([s[i] for s in st1], [s[i] for s in st2],
                  *[a[i] for a in featd], cfg) for i in range(b)]
        b_ms, _ = kernel_times(
            lambda: [lk_pyramid_cuda(*a) for a in pairs], 10, launches=b)
        e_batch = dev_frames[:, 1].contiguous()
        e_ms, e_host = kernel_times(
            lambda: build_pyramid_stacks_batched_cuda(e_batch, cfg), 50,
            launches=3)
        e_bound = bound(*pyramid_work(e_batch, cfg, b))
        us = lambda ms: f"{ms * 1e3:.1f}"
        print(f"[18 times] {card} | {size}, kernel E on one frame index of "
              f"all {b} sequences, device us per call (bound; host enqueue): "
              f"{us(e_ms)} ({us(e_bound[0])} by {e_bound[1]}; {us(e_host)})",
              flush=True)
        print(f"[18 times] {card} | {size}, {int(args[6].sum())} live of "
              f"{args[2].numel()} lanes, device us per call (bound; host "
              f"enqueue; plain version on the card): kernel C level entry, "
              f"level 0 {us(c_ms)} ({us(c_bound[0])} by {c_bound[1]}; "
              f"{us(c_host)}; {us(c_plain)}); kernel C pyramid entry, the "
              f"frame pair {us(p_ms)} ({us(p_bound[0])} by {p_bound[1]}; "
              f"{us(p_host)}; {us(p_plain)}); the same frame pair through "
              f"the torch level loop over the level entries {us(l_ms)} us "
              f"from the host's side; kernel B's pyramid entry on the {b} "
              f"sequences one at a time {us(b_ms)}", flush=True)
        for name, ms, plain, bnd in (
                ("lk_level_batched", c_ms, c_plain, c_bound),
                ("lk_pyramid_batched", p_ms, p_plain, p_bound)):
            times.setdefault(name, {"ms": ms, "plain_ms": plain,
                                    "bound_ms": bnd[0], "bound_by": bnd[1]})


def phase_batched_profile(frames, feats, cfg) -> None:
    dev_frames = torch.from_numpy(frames).cuda()
    featd = [torch.from_numpy(a).cuda() for a in feats]
    b, t_len = frames.shape[:2]
    profile_device(
        lambda: track_sequences_batched(dev_frames, *featd, cfg),
        t_len - 1, "19 profile",
        f"track_sequences_batched, {b} sequences of "
        f"{frames.shape[3]}x{frames.shape[2]}",
        {"kernel C (lk_pyramid_batched_kernel)": "lk_pyramid_batched_kernel",
         "kernel E (pyramid_tiles)": PYRAMID_KERNELS},
        expect={"kernel E (pyramid_tiles)":
                t_len * (1 + cfg.n_pyramid_levels)})


# ------------------------------------------------------------------ #
# the LK pyramid entries, and the level-by-level path                  #
# ------------------------------------------------------------------ #

def edge_state(feats, shape, cfg, seed: int):
    """A copy of numpy features (x, y, val) of any shape in which, of
    every ten live lanes, about one is lost (val -1 .. -5), one sits on or
    just past the border margin in x and one in y."""
    x, y, val = (a.copy() for a in feats)
    rng = np.random.RandomState(seed)
    live = np.flatnonzero(val >= 0)
    pick = rng.choice(live, max(6, 3 * (live.size // 10)), replace=False)
    lost, at_x, at_y = np.array_split(pick, 3)
    val.flat[lost] = -1 - rng.randint(0, 5, lost.size)
    for arr, idx, size, border in ((x, at_x, shape[1], cfg.borderx),
                                   (y, at_y, shape[0], cfg.bordery)):
        arr.flat[idx] = rng.choice(
            [border - 0.5, border + 0.25, size - 1 - border - 0.25,
             size - 1 - border + 0.5, 2.0, size - 1.5],
            idx.size).astype(np.float32)
    return x, y, val


def phase_lk_pyramid(single, batched, cfgs, errs_b, errs_c) -> None:
    """The pyramid entries of kernels B and C (a whole frame pair in one
    launch) against the torch level loop with the plain levels, on the
    card: on the selected features and on a state with lost lanes and
    lanes at the border; kernel C also lane by lane against kernel B."""
    for frames, feats, is_batched in (
            [(f, x, False) for f, x in single] +
            [(f, x, True) for f, x in batched]):
        hw = frames.shape[-2:]
        size = (f"{frames.shape[0]} x " if is_batched else "") + \
            f"{hw[1]}x{hw[0]} x {feats[0].shape[-1]}"
        for tag, cfg in cfgs:
            if is_batched:
                st1, st2 = frame_pair_stacks(frames, cfg)
            else:
                st1, st2 = (build_pyramid_stacks_cuda(
                    torch.from_numpy(f).cuda(), cfg) for f in frames[:2])
            for state_tag, state in (("selected", feats),
                                     ("lost and border lanes",
                                      edge_state(feats, hw, cfg, 3))):
                featd = [torch.from_numpy(a).cuda() for a in state]
                fn = lk_pyramid_batched_cuda if is_batched else \
                    lk_pyramid_cuda
                got = fn(st1, st2, *featd, cfg)
                ref = track_features_pyramid_stacks(st1, st2, *featd, cfg,
                                                    plain=True)
                same_b = True
                if is_batched:
                    same_b = all(torch.equal(g[i], one)
                                 for i in range(frames.shape[0])
                                 for g, one in zip(got, lk_pyramid_cuda(
                                     [s[i] for s in st1], [s[i] for s in st2],
                                     *[a[i] for a in featd], cfg)))
                torch.cuda.synchronize()
                err = max((a.double() - b.double()).abs().max().item()
                          for a, b in zip(got[:2], ref[:2]))
                same = all(torch.equal(a, b) for a, b in zip(got, ref))
                (errs_c if is_batched else errs_b).append(err)
                live = featd[2] >= 0
                codes, counts = np.unique(got[2][live].cpu().numpy(),
                                          return_counts=True)
                name = "C" if is_batched else "B"
                print(f"[20 kernel {name} pyramid entry] {size} {tag}, "
                      f"{state_tag}: {int(live.sum())} live lanes, max "
                      f"|kernel - plain| {err:.3g} px, x, y, val bit-equal: "
                      f"{same}" + (f"; every lane equal to kernel B on its "
                                   f"sequence: {same_b}" if is_batched else
                                   "") + f"; statuses "
                      f"{dict(zip(codes.tolist(), counts.tolist()))}")
                check(err == 0 and same, f"kernel {name}'s pyramid entry "
                      "differs from the level loop with the plain levels")
                check(same_b, "kernel C's pyramid entry differs from kernel "
                      "B's on a lane")
                check(torch.equal(got[2][~live], featd[2][~live]) and
                      torch.equal(got[0][~live], featd[0][~live]),
                      "a lost lane did not pass through")


def run_level_path(frames, n_feats, frames_b, feats_b, cfg, tag,
                   per_step) -> dict:
    """Level-by-level tracking: per frame pair the torch level loop
    (track_features_pyramid_levels) over the level entries of kernel B,
    and of kernel C for the batched frames, one launch per level.  Every
    step must equal the one-launch paths (track_sequence,
    track_sequences_batched) bit for bit.  Returns the launch counts."""
    fl = klt.FeatureList.create(n_feats)
    klt.KLTracker(cfg).select_good_features(frames[0], fl)
    dev_frames = torch.from_numpy(frames).cuda()
    state = [torch.from_numpy(a).cuda() for a in (fl.x, fl.y, fl.val)]
    want = track_sequence(dev_frames, *state, cfg)
    dev_b = torch.from_numpy(frames_b).cuda()
    state_b = [torch.from_numpy(a).cuda() for a in feats_b]
    want_b = track_sequences_batched(dev_b, *state_b, cfg)
    torch.cuda.synchronize()

    cuda.reset_launch_counts()
    same = True
    st1 = build_pyramid_stacks_cuda(dev_frames[0], cfg)
    for t in range(1, len(frames)):
        st2 = build_pyramid_stacks_cuda(dev_frames[t], cfg)
        state = track_features_pyramid_levels(st1, st2, *state, cfg)
        same &= all(torch.equal(a, w[t - 1]) for a, w in zip(state, want))
        st1 = st2
    per_step["level by level, one sequence"] = {
        k.symbol: round(k.launches / (len(frames) - 1), 3)
        for k in cuda.KERNELS}
    same_b = True
    build = lambda t: build_pyramid_stacks_batched_cuda(
        dev_b[:, t].contiguous(), cfg)
    st1 = build(0)
    for t in range(1, frames_b.shape[1]):
        st2 = build(t)
        state_b = track_features_pyramid_levels(st1, st2, *state_b, cfg)
        same_b &= all(torch.equal(a, w[t - 1])
                      for a, w in zip(state_b, want_b))
        st1 = st2
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in cuda.KERNELS}
    per_step["level by level, batched"] = {
        k: round(n / (frames_b.shape[1] - 1), 3) if "batched" in k else 0.0
        for k, n in launches.items()}
    want_n = {k.symbol: 0 for k in cuda.KERNELS}
    want_n[cuda.PYRAMID.symbol] = len(frames)
    want_n[cuda.LK_LEVEL.symbol] = (len(frames) - 1) * \
        expected_lk_launches(frames.shape[1:], cfg)
    want_n[cuda.PYRAMID_BATCHED.symbol] = frames_b.shape[1]
    want_n[cuda.LK_LEVEL_BATCHED.symbol] = (frames_b.shape[1] - 1) * \
        expected_lk_launches(frames_b.shape[2:], cfg)
    print(f"[{tag}] {len(frames)} frames of {frames.shape[2]}x"
          f"{frames.shape[1]}, {int((fl.val >= 0).sum())} features, level "
          f"by level: every step bit-equal to track_sequence: {same}; "
          f"{frames_b.shape[0]} sequences of {frames_b.shape[1]} frames of "
          f"{frames_b.shape[3]}x{frames_b.shape[2]}: every step bit-equal "
          f"to track_sequences_batched: {same_b}; launches {launches} "
          f"(expected {want_n})")
    check(same and same_b, "the level entries under the torch level loop "
          "differ from the pyramid entries")
    check(launches == want_n, "level path launch counts differ from the "
          "expected")
    return launches


# ------------------------------------------------------------------ #
# the affine consistency check, and selection from the card's response #
# ------------------------------------------------------------------ #

def affine_config(mode: int = 2, **kw):
    """klt_tpu's bench configuration laptops_2000feat_affine_4level."""
    return klt.TrackingConfig(sequential_mode=True,
                              affine_consistency_check=mode,
                              n_pyramid_levels=4, subsampling=2, **kw)


def select_on(frame, n_feats: int, cfg):
    fl = klt.FeatureList.create(n_feats)
    klt.KLTracker(cfg).select_good_features(frame, fl)
    return fl


def affine_state_tensors(state) -> list:
    return [state.valid, state.patches, state.x, state.y, state.axx,
            state.ayx, state.axy, state.ayy]


def run_affine_steps(frames, fl, cfg, steps, tag=None, errs=None):
    """The affine run step by step on the card, launches counted: per
    frame pair kernels A and B, then kernel F's step entry; at the step
    indices in `steps` the verification alone is first taken by kernel F's
    track entry, on the step's verification inputs.  Returns (for each of
    those steps the verification's inputs (patches, stack2, x1, y1, x2, y2,
    maps, active), the iterations each lane ran, the state's tensors before
    the step and the step's inputs (stack1, stack2, x_old, y_old, xn, yn,
    vn); the launch counts).

    With a tag the same steps are then taken (not counted) by the step
    entry's plain version on the card: after every step the features and
    the per-feature state of both must be bit-equal."""
    n_steps = max(steps) + 1
    dev_frames = torch.from_numpy(frames[:n_steps + 1]).cuda()
    start = [torch.from_numpy(a).cuda() for a in (fl.x, fl.y, fl.val)]
    stacks = lambda t: build_pyramid_stacks_cuda(dev_frames[t], cfg)
    torch.cuda.synchronize()

    cuda.reset_launch_counts()
    state = AffineState.create(len(fl.x), cfg, "cuda")
    x, y, val = start
    st1 = stacks(0)
    captured, rows = {}, []
    for t in range(n_steps):
        st2 = stacks(t + 1)
        xn, yn, vn = lk_pyramid_cuda(st1, st2, x, y, val, cfg)
        if t in steps:
            before = [a.clone() for a in affine_state_tensors(state)]
            args = verification_inputs(state, st1[0], x, y, xn, yn, vn, cfg)
            args = (args[0], st2[0]) + args[1:]
            iters = track_affine_cuda(*args, cfg)[4]
            captured[t] = args + (iters, before,
                                  (st1[0], st2[0], x, y, xn, yn, vn))
        x, y, val = affine_step_cuda_(state, st1[0], st2[0], x, y, xn, yn,
                                      vn, cfg)[:3]
        rows.append([x, y, val] + [a.clone() for a in
                                   affine_state_tensors(state)[2:]] +
                    [state.valid.clone()])
        st1 = st2
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in cuda.KERNELS}
    want = {k.symbol: 0 for k in cuda.KERNELS} | {
        cuda.PYRAMID.symbol: n_steps + 1, cuda.LK_PYRAMID.symbol: n_steps,
        cuda.AFFINE_STEP.symbol: n_steps,
        cuda.AFFINE_TRACK.symbol: len(steps)}
    check(launches == want, f"step-by-step launch counts {launches} differ "
          f"from the expected {want}")
    if tag is None:
        return captured, launches

    by_plain = AffineState.create(len(fl.x), cfg, "cuda")
    x, y, val = start
    st1 = stacks(0)
    same, err = True, 0.0
    for t in range(n_steps):
        st2 = stacks(t + 1)
        xn, yn, vn = lk_pyramid_cuda(st1, st2, x, y, val, cfg)
        out = affine_consistency_step_plain(by_plain, st1[0], st2[0], x, y,
                                            val, xn, yn, vn, cfg)
        got = list(out) + affine_state_tensors(by_plain)[2:] + \
            [by_plain.valid]
        same &= all(torch.equal(a, b) for a, b in zip(got, rows[t]))
        err = max(err, max((a.double() - b.double()).abs().max().item()
                           for a, b in zip(got, rows[t])))
        x, y, val = rows[t][:3]
        st1 = st2
    same_patches = torch.equal(by_plain.patches, state.patches)
    torch.cuda.synchronize()
    if errs is not None:
        errs.append(err)
    print(f"[{tag}] {n_steps} steps of {frames.shape[2]}x{frames.shape[1]}, "
          f"{int((fl.val >= 0).sum())} features, mode "
          f"{cfg.affine_consistency_check}, step by step: launches "
          f"{launches}; the step entry bit-equal to its plain version on "
          f"the card after every step (features, valid, centres, maps): "
          f"{same}, max |step entry - plain step| {err:.3g}; all patches "
          f"equal at the end: {same_patches}; features alive at the end "
          f"{int((val >= 0).sum())}, with a patch "
          f"{int(state.valid.sum())}")
    check(same and same_patches and err == 0,
          "kernel F's step entry and its plain version differ")
    return captured, launches


def flat_affine(out) -> list:
    return [out[0], out[1], *out[2], out[3], out[4]]


def phase_affine_kernel(states, errs, extra=()) -> None:
    """Kernel F against its plain version on the card, modes 0, 1 and 2:
    on states of the affine run (no active lane, the first verification, a
    later one with killed lanes), on `extra` (name, inputs) states (the
    batched run's) and on the made states of affine_cases (zero pivots,
    corners that leave the image, foreign patches, small windows).
    Positions, maps, statuses and iteration counts bit-equal."""
    cases = [(f"640x480 x {len(s[2])}, step {t} of the affine run", {},
              s[:8]) for t, s in sorted(states.items())]
    cases += [(name, {}, args) for name, args in extra]
    for name, kw, *arrs in affine_cases():
        dev = [tuple(torch.from_numpy(m).cuda() for m in a)
               if isinstance(a, tuple) else torch.from_numpy(a).cuda()
               for a in arrs]
        cases.append((name, kw, dev))
    for name, kw, args in cases:
        for mode in (0, 1, 2):
            cfg = affine_config(mode, **kw)
            before = cuda.AFFINE_TRACK.launches
            got = flat_affine(track_affine_cuda(*args, cfg))
            check(cuda.AFFINE_TRACK.launches == before + 1,
                  "kernel F was not launched once")
            ref = flat_affine(track_affine_plain(*args, cfg))
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            err = max((a.double() - b.double()).abs().max().item()
                      for a, b in zip(got[:6], ref[:6]))
            errs.append(err)
            act = args[7]
            codes, counts = np.unique(got[6][act].cpu().numpy(),
                                      return_counts=True)
            print(f"[22 kernel F] {name}, mode {mode}: {int(act.sum())} "
                  f"active of {act.numel()} lanes, "
                  f"{int(got[7].sum())} iterations; max |kernel - plain| "
                  f"{err:.3g}, positions, maps, statuses and iterations "
                  f"bit-equal: {same}; statuses "
                  f"{dict(zip(codes.tolist(), counts.tolist()))}")
            check(same and err == 0 and
                  all(torch.isfinite(t).all().item() for t in got[:6]),
                  f"kernel F differs from its plain version ({name}, mode "
                  f"{mode})")
            check(torch.equal(got[6][~act], torch.zeros_like(got[6][~act])),
                  "an inactive lane is not TRACKED")


def run_affine(frames, n_feats, cfg, tag, n_cpu) -> dict:
    """The affine main path: the KLTracker loop and track_sequence_affine
    (also with precomp) on the card, launches counted; then the plain CPU
    run over the first n_cpu frames, the features the check killed, the
    share still TRACKED and the known motion outside the deforming region,
    and a run under sync debug mode.  Returns the launch counts."""
    t_len = frames.shape[0]
    scale = frames.shape[1] // 240
    fl = select_on(frames[0], n_feats, cfg)
    start = fl.copy()
    sel = start.val >= 0
    dev_frames = torch.from_numpy(frames).cuda()
    feats = [torch.from_numpy(a).cuda() for a in
             (start.x, start.y, start.val)]
    torch.cuda.synchronize()

    cuda.reset_launch_counts()
    tracker = klt.KLTracker(cfg)
    check(tracker.device.type == "cuda", "KLTracker did not take the card")
    table = klt.FeatureTable.create(t_len, n_feats)
    table.store_list(fl, 0)
    t0 = time.perf_counter()
    for i in range(1, t_len):
        tracker.track_features(frames[i - 1], frames[i], fl)
        table.store_list(fl, i)
    t_tracker = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = track_sequence_affine(dev_frames, *feats, cfg)
    torch.cuda.synchronize()
    t_kern = time.perf_counter() - t0
    pre = track_sequence_affine(dev_frames, *feats, cfg, precomp=True)
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in cuda.KERNELS}
    steps = t_len - 1
    want = {k.symbol: 0 for k in cuda.KERNELS} | {
        cuda.PYRAMID.symbol: 2 * t_len + 1,
        cuda.PYRAMID_BATCHED.symbol: precomp_launches(steps),
        cuda.LK_PYRAMID.symbol: 3 * steps,
        cuda.AFFINE_STEP.symbol: 3 * steps}
    print(f"[{tag}] launches {launches} (expected {want})")
    check(launches == want, "affine path launch counts differ from the "
          "expected")

    xs, ys, vs = (a.cpu().numpy() for a in out)
    check(xs.shape == (steps, n_feats) and np.isfinite(xs).all() and
          np.isfinite(ys).all(), "bad track_sequence_affine table")
    same_pre = all(torch.equal(a, b) for a, b in zip(out, pre))
    agree = float(np.mean(vs == table.val[:, 1:].T))
    same_tracker = (np.array_equal(xs, table.x[:, 1:].T) and
                    np.array_equal(ys, table.y[:, 1:].T) and
                    np.array_equal(vs, table.val[:, 1:].T))
    n_cpu = min(n_cpu, steps)
    cpu = [a.numpy() for a in track_sequence_affine(
        torch.from_numpy(frames[:n_cpu + 1]),
        *[torch.from_numpy(a) for a in (start.x, start.y, start.val)], cfg)]
    card_cpu = all(np.array_equal(a[:n_cpu], b)
                   for a, b in zip((xs, ys, vs), cpu))
    print(f"[{tag}] {frames.shape[2]}x{frames.shape[1]}, {t_len} frames, "
          f"mode {cfg.affine_consistency_check}, {cfg.n_pyramid_levels} "
          f"levels of subsampling {cfg.subsampling}: {int(sel.sum())} of "
          f"{n_feats} requested features selected; track_sequence_affine "
          f"{t_kern:.3f} s, precomp bit-equal: {same_pre}; KLTracker loop "
          f"{t_tracker:.3f} s, status agreement {agree:.4f}, tables "
          f"identical: {same_tracker}; card bit-equal to the CPU plain run "
          f"over {n_cpu} frames: {card_cpu}")
    check(same_pre, "precomp=True differs from precomp=False")
    check(agree >= 0.97 and same_tracker,
          "track_sequence_affine and KLTracker disagree")
    check(card_cpu, "card run differs from the plain CPU run")

    # what the check killed: TRACKED to the end without it, lost with it
    free = track_sequence(dev_frames, *feats, dataclasses.replace(
        cfg, affine_consistency_check=-1))[2].cpu().numpy()
    killed = sel & (free[-1] == klt.TRACKED) & (vs[-1] < 0)
    inside = in_affine_region(start.x, start.y, scale,
                              margin=cfg.affine_window_width)
    outside = sel & ~inside
    codes, counts = np.unique(vs[-1][killed], return_counts=True)
    first = (vs < 0).argmax(axis=0)[killed] + 1
    tracked_out = float((vs[-1][outside] == klt.TRACKED).mean())
    tracked_in = float((vs[-1][sel & inside] == klt.TRACKED).mean())
    free_out = float((free[-1][outside] == klt.TRACKED).mean())
    print(f"[{tag}] killed by the check (TRACKED to frame {steps} without "
          f"it): {int(killed.sum())} features, "
          f"{int((killed & inside).sum())} of them in the deforming region "
          f"(which holds {int((sel & inside).sum())}), as "
          f"{dict(zip(codes.tolist(), counts.tolist()))}, at frames "
          f"{int(first.min()) if first.size else 0}-"
          f"{int(first.max()) if first.size else 0}; still TRACKED at frame "
          f"{steps}: {tracked_out:.4f} of the {int(outside.sum())} outside "
          f"the region ({free_out:.4f} without the check: the translation "
          f"tracker loses the features that the scene's motion carries "
          f"over the {cfg.borderx} px border), {tracked_in:.4f} inside")
    check(killed.sum() >= 5 and (killed & inside).sum() >= 5,
          "the check killed too few features")
    check(tracked_out >= 0.90, f"only {tracked_out} of the features "
          "outside the deforming region still tracked")

    worst_med, worst_frac, errs_1 = 0.0, 1.0, None
    for k in range(1, t_len):
        tx, ty = shift(k)
        ok = outside & (vs[k - 1] == klt.TRACKED)
        err = np.maximum(np.abs(xs[k - 1][ok] - start.x[ok] - tx),
                         np.abs(ys[k - 1][ok] - start.y[ok] - ty))
        errs_1 = err if errs_1 is None else errs_1
        worst_med = max(worst_med, float(np.median(err)))
        worst_frac = min(worst_frac, float((err <= 1.0).mean()))
    print(f"[{tag}] error against the known motion outside the region: "
          f"frame 1 median {np.median(errs_1):.4f} px; worst frame median "
          f"{worst_med:.4f} px, worst share within 1 px {worst_frac:.4f}")
    check(np.median(errs_1) <= 0.15, "frame 1 median error above 0.15 px")
    check(worst_med <= 0.5, "a frame's median error is above 0.5 px")
    check(worst_frac >= 0.90, "under 90% of a frame's tracks within 1 px")

    # a first run captures its graphs, which synchronises once
    track_sequence_affine(dev_frames[:12], *feats, cfg)
    torch.cuda.set_sync_debug_mode("error")
    try:
        track_sequence_affine(dev_frames[:12], *feats, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"[{tag}] track_sequence_affine ran under sync debug mode "
          f"\"error\": no host sync")
    return launches


def phase_affine_times(card, frames, n_feats, cfg, states, small, times,
                       per_step) -> None:
    """Frames/s of the affine run, its launches per step, and kernel F
    alone on states of the run at 640x480 and (`small`) at 320x240 with
    150 features."""
    size = f"{frames.shape[2]}x{frames.shape[1]}"
    fl = select_on(frames[0], n_feats, cfg)
    dev_frames = torch.from_numpy(frames).cuda()
    feats = [torch.from_numpy(a).cuda() for a in (fl.x, fl.y, fl.val)]
    n_plain = min(11, len(frames))
    runs = lambda v: [round(f, 1) for f in v]
    k_fps = sequence_fps(dev_frames, feats, cfg, False, 5,
                         seq=track_sequence_affine)
    p_fps = sequence_fps(dev_frames, feats, cfg, False, 5,
                         seq=track_sequence_affine, precomp=True)
    c_fps = sequence_fps(dev_frames[:n_plain], feats, cfg, True, 1,
                         seq=track_sequence_affine)
    spread = max(k_fps) / min(k_fps)
    print(f"[24 times] {card} | track_sequence_affine {size}, "
          f"{len(frames)} frames, {int((fl.val >= 0).sum())} features, mode "
          f"{cfg.affine_consistency_check}: kernels "
          f"{np.median(k_fps):.1f} frames/s = "
          f"{1e6 / np.median(k_fps):.1f} us of wall per step (runs "
          f"{runs(k_fps)}, max / min {spread:.2f}"
          f"{': unresolved' if spread > 1.2 else ''}), precomp "
          f"{np.median(p_fps):.1f} frames/s (runs {runs(p_fps)}), plain "
          f"torch on the card {np.median(c_fps):.1f} frames/s over "
          f"{n_plain} frames (runs {runs(c_fps)})", flush=True)
    per_step["track_sequence_affine"] = launches_per_step(
        lambda: track_sequence_affine(dev_frames, *feats, cfg),
        len(frames) - 1)

    us = lambda ms: f"{ms * 1e3:.1f}"
    for label, state, key in (
            (f"{size}, step {AFFINE_STEPS[2]} of the run", states,
             "affine_track"),
            ("320x240 x 150 requested, step 5 of its run", small, None)):
        args, iters = state[:8], state[8]
        f_ms, f_host = kernel_times(lambda: track_affine_cuda(*args, cfg),
                                    200)
        f_plain = cuda_ms(lambda: track_affine_plain(*args, cfg), 3)
        act = int(args[7].sum())
        f_bound = bound(*affine_work(act, int(iters.sum()), args[7].numel(),
                                     cfg, frame_px(args[1])))
        print(f"[24 times] {card} | kernel F, {label}: {act} active of "
              f"{args[7].numel()} lanes, {int(iters.sum())} iterations "
              f"({int(iters.sum()) / max(act, 1):.2f} a lane), device us per "
              f"call {us(f_ms)} = {f_bound[0] / f_ms:.4f} of its bound "
              f"({us(f_bound[0])} by {f_bound[1]}; host enqueue "
              f"{us(f_host)}; plain version on the card {us(f_plain)}); 1 "
              f"launch a call", flush=True)
        if key:
            times[key] = {"ms": f_ms, "plain_ms": f_plain,
                          "bound_ms": f_bound[0], "bound_by": f_bound[1]}

    # the step entry on the same step: it updates the state in place, so
    # every call gets its own copy of the state before the step, made
    # before the timed window
    before, inputs = states[9], states[10]
    x_old, y_old = inputs[2], inputs[3]
    reps = 100

    def copies(n):
        return iter([AffineState(*(a.clone() for a in before))
                     for _ in range(n)])

    run = inputs[6] == klt.TRACKED
    n_init = int((run & ~before[0]).sum())
    act, iters = int((run & before[0]).sum()), int(states[8].sum())
    by, fl_ = affine_work(act, iters, run.numel(), cfg, frame_px(inputs[0]))
    ph, pw = before[1].shape[-2:]
    s_bound = bound(by + n_init * 2 * 3 * ph * pw * 4 + run.numel() * 8 * 4,
                    fl_)
    ring = copies(2 * reps + 1)
    s_ms, s_host = kernel_times(
        lambda: affine_step_cuda_(next(ring), inputs[0], inputs[1], x_old,
                                  y_old, *inputs[4:], cfg), reps)
    ring = copies(4)
    s_plain = cuda_ms(lambda: affine_consistency_step_plain(
        next(ring), inputs[0], inputs[1], x_old, y_old, None, *inputs[4:],
        cfg), 3)
    print(f"[24 times] {card} | kernel F's step entry, {size}, step "
          f"{AFFINE_STEPS[2]} of the run: {act} lanes verified, {n_init} "
          f"save a patch, device us per call {us(s_ms)} = "
          f"{s_bound[0] / s_ms:.4f} of its bound ({us(s_bound[0])} by "
          f"{s_bound[1]}; host enqueue {us(s_host)}; plain version on the "
          f"card {us(s_plain)}), each call on its own copy of the state "
          f"made beforehand; 1 launch a step and no torch operation",
          flush=True)
    times["affine_step"] = {"ms": s_ms, "plain_ms": s_plain,
                            "bound_ms": s_bound[0], "bound_by": s_bound[1]}


def phase_affine_profile(frames, n_feats, cfg) -> None:
    """torch.profiler over track_sequence_affine with kernels."""
    fl = select_on(frames[0], n_feats, cfg)
    dev_frames = torch.from_numpy(frames).cuda()
    feats = [torch.from_numpy(a).cuda() for a in (fl.x, fl.y, fl.val)]
    profile_device(
        lambda: track_sequence_affine(dev_frames, *feats, cfg),
        len(frames) - 1, "25 profile",
        f"track_sequence_affine of {frames.shape[2]}x{frames.shape[1]}, "
        f"{int((fl.val >= 0).sum())} features, mode "
        f"{cfg.affine_consistency_check}",
        {"kernel F (affine_step_kernel)": "affine_step_kernel",
         "kernel B (lk_pyramid_kernel)": "lk_pyramid_kernel",
         "kernel A (pyramid_tiles)": PYRAMID_KERNELS},
        expect={"kernel F (affine_step_kernel)": len(frames) - 1,
                "kernel A (pyramid_tiles)":
                    len(frames) * (1 + cfg.n_pyramid_levels)})


# ------------------------------------------------------------------ #
# the batched affine consistency check                                 #
# ------------------------------------------------------------------ #

def batched_affine_launches(shape, cfg) -> dict:
    """Kernel launches of one track_sequences_affine_batched run and one
    with precomp on [B, T, H, W] frames: kernel E once per frame index
    (with precomp once for the first and then per chunk,
    precomp_launches), kernel C's pyramid entry and kernel F's step entry
    once per step."""
    want = batched_launches_expected(shape, cfg)
    want[cuda.AFFINE_STEP.symbol] = 2 * (shape[1] - 1)
    return want


def run_batched_affine_steps(frames, feats, cfg, step: int, tag: str,
                             errs) -> tuple:
    """The batched affine run step by step on the card up to `step`: per
    step kernel E on the B new frames, kernel C's pyramid entry, kernel
    F's step entry over all B * N lanes, launches counted; at `step` the
    verification alone is first taken by kernel F's track entry on the
    step's inputs.  The same steps by the step entry's plain version on
    the card must give the same features and state after every step.
    Returns (the verification's inputs (patches, stack2 [B, 3, H, W], x1,
    y1, x2, y2, maps, active), the iterations of its lanes, the state
    before the step, the step's inputs (stack1, stack2, x_old, y_old, xn,
    yn, vn)), the launch counts."""
    b = frames.shape[0]
    dev_frames = torch.from_numpy(frames[:, :step + 2]).cuda()
    start = [torch.from_numpy(a).cuda() for a in feats]
    stacks = lambda t: build_pyramid_stacks_batched_cuda(
        dev_frames[:, t].contiguous(), cfg)
    flat = lambda a: a.reshape(-1)
    torch.cuda.synchronize()

    cuda.reset_launch_counts()
    state = AffineState.create(start[0].numel(), cfg, "cuda")
    by_plain = AffineState.create(start[0].numel(), cfg, "cuda")
    x, y, val = start
    st1 = stacks(0)
    same, err = True, 0.0
    for t in range(step + 1):
        st2 = stacks(t + 1)
        xn, yn, vn = lk_pyramid_batched_cuda(st1, st2, x, y, val, cfg)
        inputs = (st1[0], st2[0], flat(x), flat(y), flat(xn), flat(yn),
                  flat(vn))
        if t == step:
            before = [a.clone() for a in affine_state_tensors(state)]
            args = verification_inputs(state, *inputs[:1], *inputs[2:], cfg)
            args = (args[0], st2[0]) + args[1:]
            iters = track_affine_cuda(*args, cfg)[4]
            captured = args + (iters, before, inputs)
        out = affine_step_cuda_(state, *inputs, cfg)[:3]
        ref = affine_consistency_step_plain(by_plain, *inputs[:4], None,
                                            *inputs[4:], cfg)
        got = list(out) + affine_state_tensors(state)
        want = list(ref) + affine_state_tensors(by_plain)
        same &= all(torch.equal(a, c) for a, c in zip(got, want))
        err = max(err, max((a.double() - c.double()).abs().max().item()
                           for a, c in zip(got, want)))
        x, y, val = (a.reshape(b, -1) for a in out)
        st1 = st2
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in cuda.KERNELS}
    want_n = {k.symbol: 0 for k in cuda.KERNELS} | {
        cuda.PYRAMID_BATCHED.symbol: step + 2,
        cuda.LK_PYRAMID_BATCHED.symbol: step + 1,
        cuda.AFFINE_STEP.symbol: step + 1, cuda.AFFINE_TRACK.symbol: 1}
    errs.append(err)
    print(f"[{tag}] {b} x {frames.shape[3]}x{frames.shape[2]}, "
          f"{start[0].numel()} lanes, mode {cfg.affine_consistency_check}, "
          f"{step + 1} steps by kernels E, C and F's step entry: launches "
          f"{launches}; the step entry bit-equal to its plain version on "
          f"the card after every step (features and the whole state): "
          f"{same}, max |step entry - plain step| {err:.3g}")
    check(launches == want_n, f"batched step-by-step launch counts "
          f"{launches} differ from the expected {want_n}")
    check(same and err == 0,
          "kernel F's step entry on the batch differs from its plain version")
    return captured, launches


def run_batched_affine(frames, feats, cfg, tag, n_cpu) -> dict:
    """The batched affine main path: track_sequences_affine_batched with
    kernels and with precomp (launches counted); then every sequence
    bit-equal to track_sequence_affine on the card, the first n_cpu =
    (sequences, frames) bit-equal to the plain batched run on the CPU, and
    per sequence the features the check killed, the share still TRACKED
    and the known motion outside the deforming region; a run under sync
    debug mode.  Returns the main path's launch counts."""
    b, t_len = frames.shape[:2]
    scale = frames.shape[2] // 240
    sel = feats[2] >= 0
    dev_frames = torch.from_numpy(frames).cuda()
    featd = [torch.from_numpy(a).cuda() for a in feats]
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    out = track_sequences_affine_batched(dev_frames, *featd, cfg)
    torch.cuda.synchronize()
    t_kern = time.perf_counter() - t0
    pre = track_sequences_affine_batched(dev_frames, *featd, cfg,
                                         precomp=True)
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in cuda.KERNELS}
    want = batched_affine_launches(frames.shape, cfg)
    print(f"[{tag}] launches {launches} (expected {want})")
    check(launches == want, "batched affine path launch counts differ from "
          "the expected")

    xs, ys, vs = (a.cpu().numpy() for a in out)
    check(xs.shape == (t_len - 1,) + feats[0].shape and
          np.isfinite(xs).all() and np.isfinite(ys).all(),
          "bad track_sequences_affine_batched table")
    same_pre = all(torch.equal(a, c) for a, c in zip(out, pre))
    lanes_equal = all(
        all(torch.equal(o[:, i], one)
            for o, one in zip(out, track_sequence_affine(
                dev_frames[i], *[a[i] for a in featd], cfg)))
        for i in range(b))
    n_seq, n_frames = n_cpu
    cpu = track_sequences_affine_batched(
        torch.from_numpy(np.ascontiguousarray(frames[:n_seq, :n_frames])),
        *[torch.from_numpy(a[:n_seq]) for a in feats], cfg)
    card_cpu = all(np.array_equal(a[:n_frames - 1, :n_seq], c.numpy())
                   for a, c in zip((xs, ys, vs), cpu))
    n_sel = sel.sum(axis=1)
    print(f"[{tag}] {b} sequences of {frames.shape[3]}x{frames.shape[2]}, "
          f"{t_len} frames, mode {cfg.affine_consistency_check}, "
          f"{feats[0].shape[1]} features requested, selected per sequence "
          f"min {n_sel.min()} max {n_sel.max()} (total {n_sel.sum()}): "
          f"track_sequences_affine_batched {t_kern:.3f} s, precomp "
          f"bit-equal: {same_pre}; every sequence bit-equal to "
          f"track_sequence_affine on the card: {lanes_equal}; the first "
          f"{n_seq} sequences bit-equal to the plain CPU run over "
          f"{n_frames} frames: {card_cpu}")
    check(same_pre, "precomp=True differs from precomp=False")
    check(lanes_equal, "a batched affine sequence differs from "
          "track_sequence_affine")
    check(card_cpu, "card run differs from the plain CPU run")

    free = track_sequences_batched(dev_frames, *featd, dataclasses.replace(
        cfg, affine_consistency_check=-1))[2].cpu().numpy()
    worst = {"killed": 1 << 30, "killed_in": 1 << 30, "tracked_out": 1.0,
             "med_1": 0.0, "med": 0.0, "frac": 1.0}
    for i in range(b):
        x0, y0 = feats[0][i], feats[1][i]
        killed = sel[i] & (free[-1, i] == klt.TRACKED) & (vs[-1, i] < 0)
        inside = in_affine_region(x0, y0, scale,
                                  margin=cfg.affine_window_width)
        outside = sel[i] & ~inside
        worst["killed"] = min(worst["killed"], int(killed.sum()))
        worst["killed_in"] = min(worst["killed_in"],
                                 int((killed & inside).sum()))
        worst["tracked_out"] = min(worst["tracked_out"], float(
            (vs[-1, i][outside] == klt.TRACKED).mean()))
        for k in range(1, t_len):
            tx, ty = lane_shift(i, k)
            ok = outside & (vs[k - 1, i] == klt.TRACKED)
            err = np.maximum(np.abs(xs[k - 1, i][ok] - x0[ok] - tx),
                             np.abs(ys[k - 1, i][ok] - y0[ok] - ty))
            med = float(np.median(err))
            if k == 1:
                worst["med_1"] = max(worst["med_1"], med)
            worst["med"] = max(worst["med"], med)
            worst["frac"] = min(worst["frac"], float((err <= 1.0).mean()))
    codes, counts = np.unique(vs[-1][sel & (vs[-1] < 0)],
                              return_counts=True)
    print(f"[{tag}] per sequence, the worst of {b}: killed by the check "
          f"(TRACKED to frame {t_len - 1} without it) {worst['killed']}, "
          f"{worst['killed_in']} of them in the deforming region; still "
          f"TRACKED outside the region {worst['tracked_out']:.4f}; error "
          f"against the sequence's known motion outside the region: frame 1 "
          f"median {worst['med_1']:.4f} px, worst frame median "
          f"{worst['med']:.4f} px, worst share within 1 px "
          f"{worst['frac']:.4f}; lost at the end, all sequences: "
          f"{dict(zip(codes.tolist(), counts.tolist()))}")
    check(worst["killed"] >= 5 and worst["killed_in"] >= 5,
          "the check killed too few features in a sequence")
    check(worst["tracked_out"] >= 0.90, "under 90% of a sequence's features "
          "outside the deforming region still tracked")
    check(worst["med_1"] <= 0.15, "a frame-1 median error above 0.15 px")
    check(worst["med"] <= 0.5, "a frame's median error is above 0.5 px")
    check(worst["frac"] >= 0.90, "under 90% of a frame's tracks within 1 px")

    # a first run captures its graphs, which synchronises once
    track_sequences_affine_batched(dev_frames[:, :12], *featd, cfg)
    torch.cuda.set_sync_debug_mode("error")
    try:
        track_sequences_affine_batched(dev_frames[:, :12], *featd, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"[{tag}] track_sequences_affine_batched ran under sync debug "
          f"mode \"error\": no host sync")
    return launches


def phase_batched_affine_times(card, frames, feats, cfg, state, times,
                               per_step) -> None:
    """Aggregate frames/s of the batched affine run, its launches per
    step, and kernel F alone (both entries) on the state at step
    BATCHED_AFFINE_STEP."""
    b, t_len = frames.shape[:2]
    size = f"{b} x {frames.shape[3]}x{frames.shape[2]}"
    dev_frames = torch.from_numpy(frames).cuda()
    featd = [torch.from_numpy(a).cuda() for a in feats]
    n = b * (t_len - 1)
    runs = lambda v: [round(f, 1) for f in v]
    k_fps = batched_fps(lambda: track_sequences_affine_batched(
        dev_frames, *featd, cfg), n, 5)
    p_fps = batched_fps(lambda: track_sequences_affine_batched(
        dev_frames, *featd, cfg, precomp=True), n, 5)
    n_plain = 6
    c_fps = batched_fps(lambda: track_sequences_affine_batched(
        dev_frames[:, :n_plain], *featd, cfg, plain=True),
        b * (n_plain - 1), 1)
    one_fps = batched_fps(lambda: [track_sequence_affine(
        dev_frames[i], *[a[i] for a in featd], cfg) for i in range(b)],
        n, 3)
    spread = max(k_fps) / min(k_fps)
    print(f"[28 times] {card} | track_sequences_affine_batched {size}, "
          f"{t_len} frames, {feats[0].shape[1]} features requested, mode "
          f"{cfg.affine_consistency_check}, aggregate frames/s over all "
          f"sequences: kernels {np.median(k_fps):.1f} = "
          f"{1e6 * b / np.median(k_fps):.1f} us of wall per step (runs "
          f"{runs(k_fps)}, max / min {spread:.2f}), precomp "
          f"{np.median(p_fps):.1f} (runs {runs(p_fps)}), plain torch on the "
          f"card {np.median(c_fps):.1f} over {n_plain} frames (runs "
          f"{runs(c_fps)}); the same {b} sequences one at a time through "
          f"track_sequence_affine {np.median(one_fps):.1f} (runs "
          f"{runs(one_fps)})", flush=True)
    per_step["track_sequences_affine_batched"] = launches_per_step(
        lambda: track_sequences_affine_batched(dev_frames, *featd, cfg),
        t_len - 1)
    del dev_frames

    us = lambda ms: f"{ms * 1e3:.1f}"
    args, iters, before, inputs = state[:8], state[8], state[9], state[10]
    act = int(args[7].sum())
    f_ms, f_host = kernel_times(lambda: track_affine_cuda(*args, cfg), 50)
    f_plain = cuda_ms(lambda: track_affine_plain(*args, cfg), 2)
    f_bound = bound(*affine_work(act, int(iters.sum()), args[7].numel(), cfg,
                                 frame_px(args[1])))
    print(f"[28 times] {card} | kernel F, {size}, step "
          f"{BATCHED_AFFINE_STEP} of the batched run: {act} active of "
          f"{args[7].numel()} lanes, {int(iters.sum())} iterations "
          f"({int(iters.sum()) / max(act, 1):.2f} a lane), device us per "
          f"call {us(f_ms)} = {f_bound[0] / f_ms:.4f} of its bound "
          f"({us(f_bound[0])} by {f_bound[1]}; host enqueue {us(f_host)}; "
          f"plain version on the card {us(f_plain)}); 1 launch a call",
          flush=True)
    reps = 25
    ring = iter([AffineState(*(a.clone() for a in before))
                 for _ in range(2 * reps + 1)])
    run = inputs[6] == klt.TRACKED
    n_init = int((run & ~before[0]).sum())
    by, fl_ = affine_work(act, int(iters.sum()), run.numel(), cfg,
                          frame_px(inputs[0]))
    ph, pw = before[1].shape[-2:]
    s_bound = bound(by + n_init * 2 * 3 * ph * pw * 4 + run.numel() * 8 * 4,
                    fl_)
    s_ms, s_host = kernel_times(
        lambda: affine_step_cuda_(next(ring), *inputs, cfg), reps)
    ring = iter([AffineState(*(a.clone() for a in before)) for _ in range(3)])
    s_plain = cuda_ms(lambda: affine_consistency_step_plain(
        next(ring), *inputs[:4], None, *inputs[4:], cfg), 2)
    del ring
    print(f"[28 times] {card} | kernel F's step entry, {size}, step "
          f"{BATCHED_AFFINE_STEP} of the batched run: {act} lanes verified, "
          f"{n_init} save a patch, device us per call {us(s_ms)} = "
          f"{s_bound[0] / s_ms:.4f} of its bound ({us(s_bound[0])} by "
          f"{s_bound[1]}; host enqueue {us(s_host)}; plain version on the "
          f"card {us(s_plain)}), each call on its own copy of the state "
          f"made beforehand", flush=True)
    for name, ms, plain, bnd in (("affine_track", f_ms, f_plain, f_bound),
                                 ("affine_step", s_ms, s_plain, s_bound)):
        times.setdefault(name, {})["batched"] = {
            "ms": ms, "plain_ms": plain, "bound_ms": bnd[0],
            "bound_by": bnd[1]}
    torch.cuda.empty_cache()


def phase_batched_affine_profile(frames, feats, cfg) -> None:
    dev_frames = torch.from_numpy(frames).cuda()
    featd = [torch.from_numpy(a).cuda() for a in feats]
    b, t_len = frames.shape[:2]
    profile_device(
        lambda: track_sequences_affine_batched(dev_frames, *featd, cfg),
        t_len - 1, "29 profile",
        f"track_sequences_affine_batched, {b} sequences of "
        f"{frames.shape[3]}x{frames.shape[2]}, mode "
        f"{cfg.affine_consistency_check}",
        {"kernel F (affine_step_kernel)": "affine_step_kernel",
         "kernel C (lk_pyramid_batched_kernel)": "lk_pyramid_batched_kernel",
         "kernel E (pyramid_tiles)": PYRAMID_KERNELS},
        expect={"kernel F (affine_step_kernel)": t_len - 1,
                "kernel C (lk_pyramid_batched_kernel)": t_len - 1,
                "kernel E (pyramid_tiles)":
                    t_len * (1 + cfg.n_pyramid_levels)})


# A selection window no tile of kernel D holds, in a configuration whose
# smoothing taps and borders stay legal.
WIDE_WINDOW = {"window_width": 111, "window_height": 111,
               "smooth_sigma_fact": 0.02, "borderx": 60, "bordery": 60,
               "n_pyramid_levels": 2, "subsampling": 4}


def run_device_selection(frame, n_feats, tag, card, times) -> dict:
    """KLTracker.select_good_features from the response computed on the
    card (KLT_TPU_EXACT_SELECT=0: kernel A's level 0, then kernel D), with
    the default window (the tiled entry) and with a 111x111 window (the
    global-memory entry); picks equal to the same selection on the CPU.
    Returns the launch counts."""
    saved = os.environ.get("KLT_TPU_EXACT_SELECT")
    os.environ["KLT_TPU_EXACT_SELECT"] = "0"
    try:
        cuda.reset_launch_counts()
        picks = []
        for kw in ({}, WIDE_WINDOW):
            fl = select_on(frame, n_feats, klt.TrackingConfig(**kw))
            picks.append(fl)
        torch.cuda.synchronize()
        launches = {k.symbol: k.launches for k in cuda.KERNELS}
        for kw, fl in zip(({}, WIDE_WINDOW), picks):
            cfg = klt.TrackingConfig(**kw)
            ref = klt.FeatureList.create(n_feats)
            klt.KLTracker(cfg, device="cpu").select_good_features(frame, ref)
            same = (np.array_equal(fl.x, ref.x) and
                    np.array_equal(fl.y, ref.y) and
                    np.array_equal(fl.val, ref.val))
            print(f"[{tag}] {frame.shape[1]}x{frame.shape[0]}, window "
                  f"{cfg.window_width}x{cfg.window_height}: "
                  f"{fl.count_remaining()} of {n_feats} features selected "
                  f"from the card's response; picks equal to the CPU's: "
                  f"{same}")
            check(same and fl.count_remaining() > 0,
                  "selection from the card's response differs from the CPU's")
    finally:
        if saved is None:
            os.environ.pop("KLT_TPU_EXACT_SELECT")
        else:
            os.environ["KLT_TPU_EXACT_SELECT"] = saved
    want = {k.symbol: 0 for k in cuda.KERNELS} | {
        cuda.PYRAMID.symbol: 2, cuda.CORNER_RESPONSE.symbol: 1,
        cuda.CORNER_RESPONSE_GLOBAL.symbol: 1,
        cuda.SELECT_LIST.symbol: 2, cuda.SELECT_PARTITIONS.symbol: 2}
    print(f"[{tag}] launches {launches} (expected {want})")
    check(launches == want, "selection path launch counts differ from the "
          "expected")

    # the global-memory entry alone, on this frame's gradients
    cfg = klt.TrackingConfig(**WIDE_WINDOW)
    win = (cfg.window_width, cfg.window_height)
    _, gx, gy = build_pyramid_stacks_cuda(torch.from_numpy(frame).cuda(),
                                          klt.TrackingConfig())[0]
    check(library_tile_rows(*win) == 0, "the wide window fits a tile")
    g_ms, g_host = kernel_times(lambda: corner_response_cuda(gx, gy, *win),
                                50, launches=2)
    g_plain = cuda_ms(lambda: corner_response_plain(gx, gy, *win), 3)
    g_bound = bound(*response_work(*frame.shape, cfg))
    print(f"[{tag}] {card} | kernel D's global-memory entry, "
          f"{frame.shape[1]}x{frame.shape[0]}, window {win[0]}x{win[1]}, "
          f"device us per call {g_ms * 1e3:.1f} ({g_bound[0] * 1e3:.1f} by "
          f"{g_bound[1]}; host enqueue {g_host * 1e3:.1f}; plain version on "
          f"the card {g_plain * 1e3:.1f}), 2 device launches")
    times["corner_response_global"] = {
        "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound[0],
        "bound_by": g_bound[1]}
    return launches


# ------------------------------------------------------------------ #
# the bit-exact tier: kernel A as its pyramid, G, H2, R's tie entry   #
# ------------------------------------------------------------------ #

def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, dtypes and bits (-0.0 and +0.0 differ)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a.cpu(), b.cpu())


def max_err(got, ref) -> float:
    """The largest absolute difference over pairs of tensors (0 when a
    pair is empty)."""
    return max([(a.double() - b.double()).abs().max().item()
                for a, b in zip(got, ref) if a.numel()] or [0.0])


def launch_counts() -> dict:
    return {k.symbol: k.launches for k in cuda.KERNELS}


def _refuse(*args, **kw):
    raise SmokeFailure("a plain version ran on the kernel path")


# the plain versions the exact tier's kernels (A, G, H2, R's tie entry)
# stand in for, and those of the front end's (A, B, D, R, E)
EXACT_PLAIN = ((lk_exact, "track_features_exact_plain"),
               (pyramid_ops, "build_pyramid_stacks_plain"),
               (replace_exact, "exact_response_plain"),
               (replace_exact, "replace_lost_plain_"))
FRONT_END_PLAIN = ((pyramid_ops, "build_pyramid_stacks_plain"),
                   (pyramid_ops, "build_pyramid_stacks_batched_plain"),
                   (lk_ops, "track_features_pyramid_levels"),
                   (selection_ops, "corner_response_plain"),
                   (replace_ops, "replace_lost_plain_"))


@contextmanager
def no_plain_versions(plain=EXACT_PLAIN):
    """The given plain versions (by default those of A, G, H2 and R's tie
    entry) raise while the block runs: the kernel path must not reach
    one."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in plain]
    for mod, name, _ in saved:
        setattr(mod, name, _refuse)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextmanager
def counting_repairs(repaired: list):
    """Appends to `repaired` each frame repaired on the host (its pixels'
    sum, to tell frames apart) while the block runs."""
    orig = pipeline._repair_replacement_host

    def spy(frame, *args):
        repaired.append(int(frame.to(torch.int64).sum()))
        return orig(frame, *args)

    pipeline._repair_replacement_host = spy
    try:
        yield
    finally:
        pipeline._repair_replacement_host = orig


def exact_response_work(rows: int, cols: int, cfg) -> tuple[float, float]:
    """(bytes, flops) of kernel H2: two gradient maps read, the response
    written; per interior pixel 3 products and 3 sums a window cell and
    the eigenvalue (about 10 operations, the square root one of them)."""
    ww, wh = cfg.window_width, cfg.window_height
    inner = max(rows - 2 * (wh // 2), 0) * max(cols - 2 * (ww // 2), 0)
    return 3 * rows * cols * 4, inner * (6 * ww * wh + 10)


# operations of kernel G's lane program a window cell: per iteration two
# cells' weights (10 each), six bilinear samples, the difference, the two
# gradient sums and five products and sums; for the residue two weights,
# two samples and the absolute difference and its sum
G_ITER_FLOPS = 2 * 10 + 6 * SAMPLE_FLOPS + 3 + 10
G_RESIDUE_FLOPS = 2 * 10 + 2 * SAMPLE_FLOPS + 3


def exact_track_work(stats, n: int, cfg) -> tuple[float, float]:
    """(bytes, flops) of kernel G on a frame pair, from the plain run's
    per-level stats (level, lanes that entered the loop, their iterations,
    lanes whose residue was taken, the most iterations of a lane): each
    entering lane's (w+1)x(w+1) footprint in the three planes of both
    frames once, the lanes' x, y, val in and out; the lane program's
    operations."""
    cells = cfg.window_width * cfg.window_height
    foot = (cfg.window_width + 1) ** 2 * 3 * 2 * 4
    n_bytes, n_flops = 2 * 12 * n, 0
    for _, entered, iters, resid, _ in stats:
        n_bytes += entered * foot
        n_flops += cells * (iters * G_ITER_FLOPS + resid * G_RESIDUE_FLOPS) \
            + iters * 15
    return n_bytes, n_flops


def exact_response_entries(gx, gy, win, errs) -> bool:
    """Kernel H2's two entries against the plain version on the card: the
    one exact_response_cuda picks (the tiled entry where a tile holds the
    window) and the global-memory entry; True when both give its bits.
    The tile rule of the plain model must be the library's."""
    tiled = library_exact_tile_rows(*win) > 0
    check(exact_response_tile(*win) == library_exact_tile_rows(*win),
          "the tile rule of H2's plain model differs from the library's")
    counts = (cuda.EXACT_RESPONSE.launches,
              cuda.EXACT_RESPONSE_GLOBAL.launches)
    got = exact_response_cuda(gx, gy, *win)
    took = (cuda.EXACT_RESPONSE.launches - counts[0],
            cuda.EXACT_RESPONSE_GLOBAL.launches - counts[1])
    check(took == ((1, 0) if tiled else (0, 1)),
          f"unexpected choice of kernel H2's entry (window {win})")
    glob = exact_response_global_cuda(gx, gy, *win)
    ref = exact_response_plain(gx, gy, *win)
    tiled_entry = cuda.EXACT_RESPONSE if tiled else cuda.EXACT_RESPONSE_GLOBAL
    errs[tiled_entry.symbol].append(max_err([got], [ref]))
    errs[cuda.EXACT_RESPONSE_GLOBAL.symbol].append(max_err([glob], [ref]))
    return bits_equal(got, ref) and bits_equal(glob, ref)


# the latency of a dependent f32 add on an H100, in cycles, and the SXM
# part's boost clock
FADD_CYCLES = 4
SM_CLOCK_HZ = 1.98e9


def exact_chain_floor(stats, cfg) -> float:
    """ms: the least time of kernel G's slowest lane as chains, from the
    plain run's per-level stats: on every level its most iterations of
    win*win dependent adds (the five sums run side by side), and one more
    chain for the residue."""
    cells = cfg.window_width * cfg.window_height
    chains = sum(most + 1 for *_, most in stats)
    return chains * cells * FADD_CYCLES / SM_CLOCK_HZ * 1e3


def phase_exact_kernels(errs) -> None:
    """Kernel A as the exact tier takes it and both entries of H2 on
    exact_cases, H2 also on response_cases, G on exact_lk_cases and R's tie
    entry on replace_cases and exact_replace_cases, against their plain
    versions on the card, bit for bit."""
    for name, kw, frame in exact_cases():
        cfg = klt.TrackingConfig(**kw)
        img = torch.from_numpy(frame).cuda()
        for n, smooth in ((cfg.n_pyramid_levels, True), (1, False)):
            got = build_pyramid_stacks_cuda(img, cfg, n, smooth)
            ref = build_pyramid_stacks_plain(img, cfg, n, smooth)
            same = all(bits_equal(a, b) for a, b in zip(got, ref))
            errs[cuda.PYRAMID.symbol].append(max_err(got, ref))
            r_same = exact_response_entries(
                got[0][1], got[0][2], (cfg.window_width, cfg.window_height),
                errs)
            print(f"[30 kernels A, H2] {name}, {n} level(s), "
                  f"{'smoothed' if smooth else 'not smoothed'}: A bit-equal "
                  f"to its plain version: {same}; H2's two entries on its "
                  f"level 0: {r_same}")
            check(same and r_same, f"kernel A or H2 differs from its plain "
                  f"version ({name})")
    for name, gx, gy, win in response_cases():
        gx, gy = torch.from_numpy(gx).cuda(), torch.from_numpy(gy).cuda()
        same = exact_response_entries(gx, gy, win, errs)
        tiled = library_exact_tile_rows(*win) > 0
        print(f"[30 kernel H2] {name}: window {win[0]}x{win[1]}, "
              f"{'tiled' if tiled else 'global-memory'} entry and the "
              f"global-memory entry bit-equal to the plain version: {same}")
        check(same, f"kernel H2 differs from its plain version ({name})")
    for name, kw, f1, f2, x, y, val in exact_lk_cases():
        cfg = klt.TrackingConfig(**kw)
        p1 = build_pyramids_exact(torch.from_numpy(f1).cuda(), cfg)
        p2 = build_pyramids_exact(torch.from_numpy(f2).cuda(), cfg)
        feats = [torch.from_numpy(a).cuda() for a in (x, y, val)]
        got = track_exact_cuda(p1, p2, *feats, cfg)
        ref = track_features_exact_plain(p1, p2, *feats, cfg)
        same = all(bits_equal(a, b) for a, b in zip(got, ref))
        errs[cuda.EXACT_TRACK.symbol].append(max_err(got, ref))
        v = got[2].cpu().numpy()
        print(f"[30 kernel G] made lanes, {name}: statuses "
              f"{np.unique(v, return_counts=True)[1].tolist()} of "
              f"{np.unique(v).tolist()}; bit-equal to the plain version: "
              f"{same}")
        check(same, f"kernel G differs from its plain version ({name})")
    for name, kw, resp, x, y, val in replace_cases() + exact_replace_cases():
        cfg = klt.TrackingConfig(**kw)
        respd = torch.from_numpy(resp).cuda()
        outs = []
        for plain in (False, True):
            state = [torch.from_numpy(a.copy()).cuda() for a in (x, y, val)]
            tie = torch.full((1,), 7, dtype=torch.int32,
                             device=respd.device)
            replace_lost_exact_(respd, *state, cfg, tie, plain=plain)
            outs.append(state + [tie])
        same = all(bits_equal(a, b) for a, b in zip(*outs))
        errs[cuda.REPLACE_LOST_TIE.symbol].append(max_err(*outs))
        print(f"[30 kernel R, tie entry] {name}: tie {int(outs[0][3])}; "
              f"x, y, val, tie equal to the plain loop: {same}")
        check(same, f"kernel R's tie entry differs from its plain loop "
              f"({name})")


def exact_table(xs, ys, vs, start):
    """[N, T] (x, y, val) table with the first selection at column 0."""
    return [np.concatenate([s[:, None], a.T], axis=1) for a, s in
            ((xs, start.x), (ys, start.y), (vs, start.val))]


def run_exact_card(dev_frames, feats, cfg, tier="exact", chunk=32):
    """track_sequence_replace_exact with kernels and no plain version;
    returns (numpy table, frames repaired, seconds, launches)."""
    repaired = []
    before = launch_counts()
    with no_plain_versions(), counting_repairs(repaired):
        t0 = time.perf_counter()
        out = track_sequence_replace_exact(dev_frames, *feats, cfg,
                                           tier=tier, chunk=chunk)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    after = launch_counts()
    return ([a.cpu().numpy() for a in out], repaired, secs,
            {k: after[k] - before[k] for k in after})


def check_exact_launches(tag, launches, repaired, n_frames, tier,
                         response=cuda.EXACT_RESPONSE) -> None:
    """Every step computed is one launch each of A (the new frame's
    pyramid), G (or B), H2 (`response`: the entry the window takes) and
    R's tie entry, the first frame one of A, a repair one more of H2 (its
    response, from the kept pyramid); no other kernel."""
    steps = launches[cuda.REPLACE_LOST_TIE.symbol]
    rep = len(repaired)
    track = cuda.EXACT_TRACK if tier == "exact" else cuda.LK_PYRAMID
    want = {track.symbol: steps, cuda.PYRAMID.symbol: 1 + steps,
            response.symbol: steps + rep,
            cuda.REPLACE_LOST_TIE.symbol: steps}
    got = {k: v for k, v in launches.items() if v}
    print(f"[{tag}] launches of the {tier} tier: {got} ({rep} frames "
          f"repaired, {steps} steps computed for {n_frames - 1})")
    check(steps >= n_frames - 1 and got == want,
          f"{tier} tier launch counts differ from the expected {want}")


def run_exact_traffic(frames, n_feats, cfg, tag, n_cpu) -> dict:
    """The traffic configuration on the exact tier: the card's table
    against the plain CPU run over the first n_cpu frames (chunk 1: the
    table does not depend on the chunk), the frames repaired, slots
    refilled and the known motion; then the fast tier against its plain
    CPU run, and its parity with the exact table.  Returns the launches,
    the start and the exact table."""
    t_len = frames.shape[0]
    n_cpu = min(n_cpu, t_len - 1)
    fl = klt.FeatureList.create(n_feats)
    klt.KLTracker(cfg, device="cuda").select_good_features(frames[0], fl)
    start = fl.copy()
    dev_frames = torch.from_numpy(frames).cuda()
    feats = [torch.from_numpy(a).cuda() for a in
             (start.x, start.y, start.val)]
    (xs, ys, vs), repaired, secs, launches = run_exact_card(dev_frames, feats,
                                                            cfg)
    check_exact_launches(tag, launches, repaired, t_len, "exact")
    check(np.isfinite(xs).all() and np.isfinite(ys).all() and
          xs.shape == (t_len - 1, n_feats), "bad exact table")
    cpu_feats = [torch.from_numpy(a) for a in (start.x, start.y, start.val)]
    t0 = time.perf_counter()
    cpu = [a.numpy() for a in track_sequence_replace_exact(
        torch.from_numpy(frames[:n_cpu + 1]), *cpu_feats, cfg, chunk=1)]
    t_cpu = time.perf_counter() - t0
    card_cpu = all(np.array_equal(a[:n_cpu].view(np.int32),
                                  b.view(np.int32))
                   for a, b in zip((xs, ys, vs), cpu))
    refilled = (vs > 0).sum(axis=1)
    alive = (vs >= 0).sum(axis=1)
    print(f"[{tag}] {frames.shape[2]}x{frames.shape[1]}, {t_len} frames, "
          f"{start.count_remaining()} of {n_feats} requested features: "
          f"track_sequence_replace_exact on the card {secs:.3f} s, "
          f"{len(repaired)} frames repaired on the host; plain CPU run "
          f"over {n_cpu} frames {t_cpu:.1f} s, card bit-equal to it: "
          f"{card_cpu}")
    print(f"[{tag}] replaced per frame: {refilled.tolist()}")
    print(f"[{tag}] frames with replacements {int((refilled > 0).sum())} of "
          f"{t_len - 1}; features alive per frame min {alive.min()}, "
          f"median {np.median(alive):.0f}")
    check(card_cpu, "exact run on the card differs from the plain CPU run")
    check((refilled > 0).sum() >= (t_len - 1) / 2,
          "replacement filled slots on under half of the frames")
    check_known_motion(tag, xs, ys, vs, start)

    (fx, fy, fv), f_rep, f_secs, f_launches = run_exact_card(
        dev_frames, feats, cfg, tier="fast")
    check_exact_launches(tag, f_launches, f_rep, t_len, "fast")
    f_cpu = [a.numpy() for a in track_sequence_replace_exact(
        torch.from_numpy(frames[:n_cpu + 1]), *cpu_feats, cfg, tier="fast",
        chunk=1)]
    f_same = all(np.array_equal(a[:n_cpu].view(np.int32), b.view(np.int32))
                 for a, b in zip((fx, fy, fv), f_cpu))
    stats = table_parity_stats(*exact_table(fx, fy, fv, start),
                               *exact_table(xs, ys, vs, start))
    print(f"[{tag}] tier=\"fast\" (kernels A and B track): {f_secs:.3f} s, "
          f"{len(f_rep)} frames repaired; card bit-equal to its plain CPU "
          f"run over {n_cpu} frames: {f_same}; parity with the exact table "
          f"(utils/parity.py, for information): {json.dumps(stats)}")
    check(f_same, "fast tier on the card differs from its plain CPU run")
    return {"launches": {k: launches[k] + f_launches[k] for k in launches},
            "start": start, "table": (xs, ys, vs), "repaired": repaired}


def run_exact_flagship(frames, n_feats, cfg, tag) -> dict:
    """The exact tier at the example3 size with a tie-forcing frame: at
    least one frame repaired on the host, the card's table bit-equal to
    the plain CPU run.  Returns the launches."""
    fl = klt.FeatureList.create(n_feats)
    klt.KLTracker(cfg, device="cuda").select_good_features(frames[0], fl)
    feats = [torch.from_numpy(a) for a in (fl.x, fl.y, fl.val)]
    (xs, ys, vs), repaired, secs, launches = run_exact_card(
        torch.from_numpy(frames).cuda(), [f.cuda() for f in feats], cfg)
    check_exact_launches(tag, launches, repaired, len(frames), "exact")
    cpu = [a.numpy() for a in track_sequence_replace_exact(
        torch.from_numpy(frames), *feats, cfg)]
    same = all(np.array_equal(a.view(np.int32), b.view(np.int32))
               for a, b in zip((xs, ys, vs), cpu))
    print(f"[{tag}] {frames.shape[2]}x{frames.shape[1]}, {len(frames)} "
          f"frames, {n_feats} features, a block pasted at two places from "
          f"frame 5: {secs:.3f} s, {len(repaired)} frames repaired on the "
          f"host, replaced per frame {(vs > 0).sum(axis=1).tolist()}; card "
          f"bit-equal to the plain CPU run: {same}")
    check(len(repaired) >= 1, "no frame went through the host repair")
    check(same, "exact flagship on the card differs from the plain CPU run")
    return launches


def run_exact_wide(frames, n_feats, tag, card, times) -> dict:
    """The exact run with EXACT_WIDE's 121x121 window: no tile of kernel H2
    holds it (the global-memory entry runs), and kernel G runs a lane a
    block with 176 KB of image-1 samples.  The card's table bit-equal to
    the plain CPU run; then H2's global-memory entry timed on the last
    frame's gradients.  Returns the run's launches (not the timing's)."""
    cfg = klt.TrackingConfig(**EXACT_WIDE)
    win = (cfg.window_width, cfg.window_height)
    check(library_exact_tile_rows(*win) == 0,
          "a tile of kernel H2 holds the wide window")
    fl = klt.FeatureList.create(n_feats)
    klt.KLTracker(cfg, device="cuda").select_good_features(frames[0], fl)
    feats = [torch.from_numpy(a) for a in (fl.x, fl.y, fl.val)]
    (xs, ys, vs), repaired, secs, launches = run_exact_card(
        torch.from_numpy(frames).cuda(), [f.cuda() for f in feats], cfg)
    check_exact_launches(tag, launches, repaired, len(frames), "exact",
                         cuda.EXACT_RESPONSE_GLOBAL)
    t0 = time.perf_counter()
    cpu = [a.numpy() for a in track_sequence_replace_exact(
        torch.from_numpy(frames), *feats, cfg)]
    t_cpu = time.perf_counter() - t0
    same = all(np.array_equal(a.view(np.int32), b.view(np.int32))
               for a, b in zip((xs, ys, vs), cpu))
    print(f"[{tag}] {frames.shape[2]}x{frames.shape[1]}, {len(frames)} "
          f"frames, {fl.count_remaining()} of {n_feats} features, window "
          f"{win[0]}x{win[1]}, one level: {secs:.3f} s on the card, "
          f"tracked per frame {(vs >= 0).sum(axis=1).tolist()}, replaced "
          f"{(vs > 0).sum(axis=1).tolist()}; plain CPU run {t_cpu:.1f} s, "
          f"card bit-equal to it: {same}")
    check(same, "wide-window exact run on the card differs from the plain "
          "CPU run")
    check(fl.count_remaining() > 0 and (vs[-1] >= 0).any(),
          "the wide-window exact run tracked nothing")

    _, gx, gy = build_pyramids_exact(torch.from_numpy(frames[-1]).cuda(),
                                     cfg)[0]
    g_ms, g_host = kernel_times(lambda: exact_response_cuda(gx, gy, *win), 20)
    g_plain = cuda_ms(lambda: exact_response_plain(gx, gy, *win), 1)
    g_bound = bound(*exact_response_work(*frames.shape[1:], cfg))
    print(f"[{tag}] {card} | kernel H2's global-memory entry, "
          f"{frames.shape[2]}x{frames.shape[1]}, window {win[0]}x{win[1]}, "
          f"device us per call {g_ms * 1e3:.1f} ({g_bound[0] * 1e3:.1f} by "
          f"{g_bound[1]}; host enqueue {g_host * 1e3:.1f}; plain version on "
          f"the card {g_plain * 1e3:.1f})")
    times["exact_response_global"] = {
        "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound[0],
        "bound_by": g_bound[1]}
    return launches


def exact_state(frames, table, start, t: int, cfg):
    """Inputs of kernel G at step t of the exact run: the exact pyramids of
    frames t-1 and t on the card and the table's state after frame t-1."""
    xs, ys, vs = table
    feats = ((start.x, start.y, start.val) if t == 1 else
             (xs[t - 2], ys[t - 2], vs[t - 2]))
    return (build_pyramids_exact(torch.from_numpy(frames[t - 1]).cuda(), cfg),
            build_pyramids_exact(torch.from_numpy(frames[t]).cuda(), cfg),
            [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in feats])


def phase_exact_track_states(frames, run, cfg, errs) -> None:
    """Kernel G against its plain version on states of the exact run."""
    for t in EXACT_G_STEPS:
        p1, p2, feats = exact_state(frames, run["table"], run["start"], t, cfg)
        got = track_exact_cuda(p1, p2, *feats, cfg)
        ref = track_features_exact_plain(p1, p2, *feats, cfg)
        same = all(bits_equal(a, b) for a, b in zip(got, ref))
        errs[cuda.EXACT_TRACK.symbol].append(max_err(got, ref))
        v = got[2].cpu().numpy()
        print(f"[30 kernel G] step {t} of the exact traffic run: "
              f"{int((feats[2] >= 0).sum())} live lanes, "
              f"{int((v == klt.TRACKED).sum())} tracked; bit-equal to the "
              f"plain version: {same}")
        check(same, f"kernel G differs from its plain version at step {t}")


def phase_exact_times(card, frames, cfg, run, times, per_step) -> None:
    """Frames/s of the exact run (EXACT_RUNS card runs, spread), launches
    per step, and device us per call of G, H2 and R's tie entry with
    their bounds and plain versions' times on the card."""
    start = run["start"]
    dev_frames = torch.from_numpy(frames).cuda()
    feats = [torch.from_numpy(a).cuda() for a in (start.x, start.y,
                                                   start.val)]
    fps, reps = [], []
    for _ in range(EXACT_RUNS):
        _, repaired, secs, _ = run_exact_card(dev_frames, feats, cfg)
        fps.append((len(frames) - 1) / secs)
        reps.append(len(repaired))
    size = f"{frames.shape[2]}x{frames.shape[1]}"
    print(f"[32 times] {card} | track_sequence_replace_exact {size}, "
          f"{len(frames)} frames, {int((start.val >= 0).sum())} features: "
          f"{np.median(fps):.1f} frames/s = {1e6 / np.median(fps):.1f} us "
          f"of wall per step (runs {[round(f, 1) for f in fps]}, "
          f"{reps[0]} frames repaired in each)", flush=True)
    per_step["track_sequence_replace_exact"] = launches_per_step(
        lambda: track_sequence_replace_exact(dev_frames, *feats, cfg),
        len(frames) - 1)

    t = EXACT_G_STEPS[1]
    p1, p2, lanes = exact_state(frames, run["table"], start, t, cfg)
    stats = []
    track_features_exact_plain(p1, p2, *lanes, cfg, stats=stats)
    g_ms, g_host = kernel_times(lambda: track_exact_cuda(p1, p2, *lanes, cfg),
                                50)
    g_plain = cuda_ms(lambda: track_features_exact_plain(p1, p2, *lanes, cfg),
                      3)
    g_bound = bound(*exact_track_work(stats, len(lanes[0]), cfg))
    g_floor = exact_chain_floor(stats, cfg)
    # every lane that G does not kill runs max_iterations on every level
    worst = dataclasses.replace(cfg, min_displacement=0.0)
    w_stats = []
    track_features_exact_plain(p1, p2, *lanes, worst, stats=w_stats)
    gw_ms, _ = kernel_times(lambda: track_exact_cuda(p1, p2, *lanes, worst),
                            20)
    gw_floor = exact_chain_floor(w_stats, worst)
    gx, gy = p2[0][1], p2[0][2]
    win = (cfg.window_width, cfg.window_height)
    r2_ms, r2_host = kernel_times(lambda: exact_response_cuda(gx, gy, *win),
                                  200)
    r2_plain = cuda_ms(lambda: exact_response_plain(gx, gy, *win), 5)
    rows, cols = frames.shape[1:]
    r2_bound = bound(*exact_response_work(rows, cols, cfg))
    # R's tie entry on the state before replacement at the step after t
    # that refilled the most slots
    refilled = (run["table"][2][t - 1:] > 0).sum(axis=1)
    tr = t + int(refilled.argmax())
    q1, q2, q_lanes = exact_state(frames, run["table"], start, tr, cfg)
    pre = track_exact_cuda(q1, q2, *q_lanes, cfg)
    resp = exact_response_cuda(q2[0][1], q2[0][2], *win)
    n_lost = int((pre[2] < 0).sum())
    tie = torch.zeros(1, dtype=torch.int32, device=resp.device)
    fresh = lambda: [a.clone() for a in pre]
    clone_ms, _ = kernel_times(fresh, 100, launches=3)
    rt_ms, rt_host = kernel_times(
        lambda: replace_lost_tie_cuda_(resp, *fresh(), cfg, tie), 100,
        launches=4)
    r_ms, _ = kernel_times(lambda: replace_lost_cuda_(resp, *fresh(), cfg),
                           100, launches=4)
    rt_plain = cuda_ms(lambda: replace_lost_exact_(resp, *fresh(), cfg, tie,
                                                   plain=True), 3)
    rt_bound = bound(*replace_work(rows, cols, len(pre[0]), n_lost))
    us = lambda ms: f"{ms * 1e3:.1f}"
    print(f"[32 times] {card} | {size}, step {t} of the exact run, device us "
          f"per call (bound; host enqueue; plain version on the card): "
          f"kernel G {us(g_ms)} for {int((lanes[2] >= 0).sum())} live lanes "
          f"(levels: lanes, iterations, residues, most iterations of a lane "
          f"{[s[1:] for s in stats]}) "
          f"= {g_bound[0] / g_ms:.5f} of its bound ({us(g_bound[0])} by "
          f"{g_bound[1]}; {us(g_host)}; {us(g_plain)}), its slowest lane's "
          f"chains {us(g_floor)}; with min_displacement 0, every lane "
          f"max_iterations a level ({[s[1:] for s in w_stats]}): "
          f"{us(gw_ms)}, chains {us(gw_floor)}; "
          f"kernel H2 {us(r2_ms)} ({us(r2_bound[0])} by "
          f"{r2_bound[1]}; {us(r2_host)}; {us(r2_plain)}); kernel R's tie "
          f"entry at step {tr}, {n_lost} of {len(pre[0])} slots lost, "
          f"{us(rt_ms)} "
          f"({us(rt_bound[0])} by {rt_bound[1]}; {us(rt_host)}; "
          f"{us(rt_plain)}), kernel R on the same state {us(r_ms)}, with "
          f"{us(clone_ms)} of input copies in each", flush=True)
    for name, ms, plain, bnd in (
            ("exact_track", g_ms, g_plain, g_bound),
            ("exact_response", r2_ms, r2_plain, r2_bound),
            ("replace_lost_tie", rt_ms, rt_plain, rt_bound)):
        times[name] = {"ms": ms, "plain_ms": plain, "bound_ms": bnd[0],
                       "bound_by": bnd[1]}
    times["exact_track"]["worst_lanes_ms"] = gw_ms


def phase_exact_profile(frames, n_feats, cfg) -> None:
    """torch.profiler over track_sequence_replace_exact with kernels."""
    fl = klt.FeatureList.create(n_feats)
    klt.KLTracker(cfg).select_good_features(frames[0], fl)
    dev_frames = torch.from_numpy(frames).cuda()
    feats = [torch.from_numpy(a).cuda() for a in (fl.x, fl.y, fl.val)]
    profile_device(
        lambda: track_sequence_replace_exact(dev_frames, *feats, cfg),
        len(frames) - 1, "33 profile",
        f"track_sequence_replace_exact of {frames.shape[2]}x"
        f"{frames.shape[1]}",
        {"kernel G (exact_track)": "exact_track",
         "kernel A (pyramid_tiles)": PYRAMID_KERNELS,
         "kernel H2 (exact_response)": "exact_response",
         "kernel R, tie entry (replace_lost)": "replace_lost"})


# ------------------------------------------------------------------ #
# the selection prefilter and the SLAM back end                        #
# ------------------------------------------------------------------ #

PREFILTER_FRAMES = 64
PREFILTER_K = 4           # candidates kept a cell (candidate_points_topk)
SLAM_FRAMES = 1003        # images_laptops' length (klt_tpu's bench.py:977)
SLAM_CPU_FRAMES = 50
SLAM_GATED = dict(rounds=3, iterations=17, robust_delta=2.0, gate_px=2.0)
# the back end on the card against the CPU on the same observations (plain
# torch on both sides; products, solves and sums round differently)
SLAM_COST_TOL = 1e-3      # relative, cost curves
SLAM_POSE_TOL = 1e-3      # absolute, poses
SLAM_ACTIVE_SHARE = 0.99  # gate decisions that must agree
# phase 37's first two LM iterations, card against CPU, on their costs
# (what LM accepts on): with cg_iters 120 the BA's CG stops unconverged
# (relative residual 1.7e-2 and 3.1e-2 on the CPU, not 1e-5), and a CG
# iterate short of convergence depends on the rounding of its dot
# products, so the states are printed, not held (measured at 80,000
# observations: costs 2.25e-3 apart, landmarks 0.107 of their largest
# move)
SLAM_CG_TOL = 1e-2        # relative, costs


@contextmanager
def counting_prefilter(calls: dict):
    """Counts the prefiltered selections of KLTrackers with
    prefilter=True, certified or fallen back, while the block runs."""
    orig = KLTracker._suppress_prefiltered

    def spy(self, *a, **k):
        ok = orig(self, *a, **k)
        if self.prefilter:
            calls["certified" if ok else "fallback"] += 1
        return ok

    KLTracker._suppress_prefiltered = spy
    try:
        yield
    finally:
        KLTracker._suppress_prefiltered = orig


def corner_scene() -> np.ndarray:
    """uint8 [120, 160]: isolated corners of distinct strengths on a faint
    texture (the scene of klt_tpu's tests/test_selection.py whose
    replacement the prefilter's audit certifies)."""
    rng = np.random.RandomState(11)
    img = rng.randint(98, 102, (120, 160)).astype(np.uint8)
    for i, (cy, cx) in enumerate([(30, 40), (60, 100), (90, 50),
                                  (40, 130), (80, 20)]):
        amp = 60 + 20 * i
        img[cy:cy + 6, cx:cx + 6] = 100 + amp
        img[cy + 3:cy + 6, cx:cx + 3] = 100 - amp // 2
    return img


def same_list(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("x", "y", "val"))


def run_prefilter(frames, tag) -> dict:
    """KLTracker(prefilter=True) against prefilter=False: a selection of
    2000 features on frame 0, then select 500 and track + replace through
    the frames (the replacement's response is kernel D's on the card, cut
    to the best PREFILTER_K a cell there).  The lists must be bit-equal
    after every call.  Returns the launch counts."""
    cfg = klt.TrackingConfig(sequential_mode=True)
    rows, cols = frames.shape[1:]
    calls = {"certified": 0, "fallback": 0}
    cuda.reset_launch_counts()
    with counting_prefilter(calls):
        sel = []
        for pre in (True, False):
            fl = klt.FeatureList.create(2000)
            klt.KLTracker(cfg, prefilter=pre).select_good_features(frames[0],
                                                                   fl)
            sel.append(fl)
        check(same_list(*sel), "prefilter=True selected another list")
        at_select = dict(calls)
        trackers = [klt.KLTracker(cfg, prefilter=pre) for pre in (True, False)]
        lists = [klt.FeatureList.create(500) for _ in trackers]
        for tr, fl in zip(trackers, lists):
            tr.select_good_features(frames[0], fl)
        replaced, secs = 0, [0.0, 0.0]
        for i in range(1, frames.shape[0]):
            for tr, fl in zip(trackers, lists):
                tr.track_features(frames[i - 1], frames[i], fl)
            lost = lists[0].val < 0
            for j, (tr, fl) in enumerate(zip(trackers, lists)):
                t0 = time.perf_counter()
                tr.replace_lost_features(frames[i], fl)
                secs[j] += time.perf_counter() - t0
            check(same_list(*lists),
                  f"prefilter=True differs from the full list at frame {i}")
            replaced += int((lost & (lists[0].val > 0)).sum())
        # a replacement the audit certifies: 4 corners selected and
        # tracked in place, one lost, refilled from the card's response
        before = calls["certified"]
        scene = corner_scene()
        corners = []
        for pre in (True, False):
            tr = klt.KLTracker(cfg, prefilter=pre)
            fl = klt.FeatureList.create(4)
            tr.select_good_features(scene, fl)
            tr.track_features(scene, scene, fl)
            fl.val[2] = -1
            tr.replace_lost_features(scene, fl)
            corners.append(fl)
        check(same_list(*corners) and (corners[0].val >= 0).all(),
              "prefilter=True refilled the corner scene otherwise")
        check(calls["certified"] >= before + 2,
              "the corner scene's selection and replacement not certified")
    launches = launch_counts()
    cell = cfg.mindist
    n_cells = -(-rows // cell) * -(-cols // cell)
    cut = n_cells * (PREFILTER_K + 1) * 8  # int32 value + in-cell index
    print(f"[{tag}] {cols}x{rows}: selection of 2000 on frame 0 and select "
          f"500 + track + replace over {frames.shape[0]} frames ({replaced} "
          f"slots replaced): prefilter=True bit-equal to prefilter=False "
          f"after every call; prefiltered calls certified "
          f"{calls['certified']}, fallen back to the full list "
          f"{calls['fallback']} (of them at the selection: "
          f"{at_select['fallback']} fallen back, {at_select['certified']} "
          f"certified; the corner scene's selection and replacement, "
          f"certified: 2)")
    print(f"[{tag}] read back a call: cut {n_cells} cells x "
          f"{PREFILTER_K + 1} x 8 B = {cut} B (k * nCells * 12 B = "
          f"{PREFILTER_K * n_cells * 12} B as triples) against the whole "
          f"response {rows * cols * 4} B, plus the whole map on a fallback; "
          f"host seconds in replace_lost_features over the run: "
          f"prefilter {secs[0]:.3f}, full list {secs[1]:.3f}")
    check(calls["certified"] + calls["fallback"] >= 3,
          "too few prefiltered selections ran")
    return launches


@contextmanager
def eager_pair_solves():
    """build_keyframe_pose_graph's pair solves through their eager body
    (slam/frontend.py::_pair_solve_eager) inside."""
    graphed = slam_frontend._pair_solve
    slam_frontend._pair_solve = slam_frontend._pair_solve_eager
    try:
        yield
    finally:
        slam_frontend._pair_solve = graphed


def slam_back_end(obs, shape, device, gated=SLAM_GATED,
                  eager: bool = False) -> dict:
    """The keyframe pose graph (built and optimized 10 iterations) and the
    gated BA on `device`, as bench_slam_e2e runs them; seconds of each
    stage (host clock, the card synchronised).  eager: every solve through
    its eager body instead of its programs."""
    kfs, lm_idx, cam, u, v = obs
    h, w = shape
    fx = fy = 0.9 * w
    cx, cy = w / 2.0, h / 2.0
    n_pose = len(kfs)
    lm0 = unit_depth_landmarks(lm_idx, u, v, fx, fy, cx, cy)
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    secs = []
    optimize = pose_graph._optimize_pose_graph_eager if eager \
        else optimize_pose_graph
    gated_ba = slam_ba._bundle_adjust_gated_eager if eager \
        else bundle_adjust_gated
    t0 = time.perf_counter()
    with eager_pair_solves() if eager else contextlib.nullcontext():
        pg = build_keyframe_pose_graph(lm_idx, cam, u, v, n_pose, fx, fy,
                                       cx, cy, device=device)
    sync()
    secs.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    R0, t0_, pg_costs = optimize(pg, iterations=10)
    sync()
    secs.append(time.perf_counter() - t0)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    prob = BAProblem(R=R0, t=t0_, landmarks=on(lm0), cam_idx=on(cam),
                     lm_idx=on(lm_idx),
                     uv=on(np.stack([u, v], -1).astype(np.float32)),
                     weight=torch.ones(len(cam), dtype=torch.float32,
                                       device=device),
                     fx=fx, fy=fy, cx=cx, cy=cy)
    t0 = time.perf_counter()
    R, t, lm, costs, active = gated_ba(prob, **gated)
    sync()
    secs.append(time.perf_counter() - t0)
    return {"pg": [pg.R, pg.t, pg.Rz, pg.tz], "R0": R0, "t0": t0_,
            "pg_costs": pg_costs, "prob": prob, "R": R, "t": t, "lm": lm,
            "costs": costs, "active": active, "secs": secs}


def back_ends_bit_equal(a: dict, b: dict) -> bool:
    tensors = lambda r: r["pg"] + [r[k] for k in ("R0", "t0", "pg_costs", "R",
                                                  "t", "lm", "costs")]
    return all(bits_equal(x, y) for x, y in zip(tensors(a), tensors(b))) \
        and np.array_equal(a["active"], b["active"])


def rel_curve(a, b) -> float:
    a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
    return float(np.abs(a / b - 1).max())


def run_slam(frames, n_feats, tag, n_cpu) -> dict:
    """bench_slam_e2e (klt_tpu's "config 5") on the card: the front end
    (track_sequence_replace with precomp: kernels A, B, D, R and E) at
    the laptops width, the feature table, chains, keyframes, the keyframe
    pose graph and the gated bundle adjustment.  Holds the front end to
    its launch counts, without a plain version, and to the plain CPU run
    over its first n_cpu frames; the back end to a second card run (bit
    for bit) and to the CPU's back end on the same observations.  Returns
    the front end's launch counts, and the back end's observations, frame
    shape and second card run (phase 42's)."""
    check(not torch.backends.cuda.matmul.allow_tf32 and
          torch.get_float32_matmul_precision() == "highest",
          "f32 matrix products on the card are not full f32")
    cfg = klt.TrackingConfig(sequential_mode=True)
    t_len = frames.shape[0]
    steps = t_len - 1
    fl = klt.FeatureList.create(n_feats)
    klt.KLTracker(cfg).select_good_features(frames[0], fl)
    dev_frames = torch.from_numpy(frames).cuda()
    feats = [torch.from_numpy(a).cuda() for a in (fl.x, fl.y, fl.val)]
    track_sequence_replace(dev_frames[:PRECOMP_FRAMES + 1], *feats, cfg,
                           precomp=True)
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    with no_plain_versions(FRONT_END_PLAIN):
        t0 = time.perf_counter()
        out = track_sequence_replace(dev_frames, *feats, cfg, precomp=True)
        torch.cuda.synchronize()
        t_fe = time.perf_counter() - t0
    launches = launch_counts()
    want = {k.symbol: 0 for k in cuda.KERNELS} | {
        cuda.PYRAMID.symbol: 1,
        cuda.PYRAMID_BATCHED.symbol: precomp_launches(steps),
        cuda.LK_PYRAMID.symbol: steps,
        cuda.CORNER_RESPONSE.symbol: steps,
        cuda.REPLACE_LOST.symbol: steps}
    print(f"[{tag}] front end launches {launches} (expected {want})")
    check(launches == want, "SLAM front end launch counts differ")
    xs, ys, vs = (a.cpu().numpy() for a in out)
    check(np.isfinite(xs).all() and np.isfinite(ys).all(),
          "bad SLAM front end table")
    cpu = [a.numpy() for a in track_sequence_replace(
        torch.from_numpy(frames[:n_cpu]),
        *[torch.from_numpy(a) for a in (fl.x, fl.y, fl.val)], cfg,
        precomp=True)]
    card_cpu = all(np.array_equal(a[:n_cpu - 1], b)
                   for a, b in zip((xs, ys, vs), cpu))
    check(card_cpu, "SLAM front end differs from the plain CPU run")
    table = klt.FeatureTable.create(t_len, n_feats)
    table.store_list(fl, 0)
    table.x[:, 1:], table.y[:, 1:], table.val[:, 1:] = xs.T, ys.T, vs.T
    print(f"[{tag}] front end: {frames.shape[2]}x{frames.shape[1]}, "
          f"{fl.count_remaining()} of {n_feats} features selected, {t_len} "
          f"frames in {t_fe:.3f} s: {steps / t_fe:.1f} frames/s; "
          f"{int((vs > 0).sum())} slots replaced; bit-equal to the plain "
          f"CPU run over {n_cpu} frames: {card_cpu}; no plain version "
          f"reached")

    by_overlap = select_keyframes(table.val, overlap_thresh=0.8)
    t0 = time.perf_counter()
    obs = keyframe_observations(table)
    t_obs = time.perf_counter() - t0
    print(f"[{tag}] keyframes by overlap 0.8: {by_overlap.tolist()}"
          f"{'; evenly spaced instead' if len(by_overlap) < 3 else ''} "
          "(the synthetic frames move within +-4 px, so few features "
          "leave the view)")
    kfs, lm_idx, cam = obs[:3]
    shape = frames.shape[1:]
    runs = [slam_back_end(obs, shape, "cuda") for _ in range(2)]
    same = back_ends_bit_equal(*runs)
    on_cpu = slam_back_end(obs, shape, "cpu")
    card = runs[1]
    pg_rel = rel_curve(card["pg_costs"], on_cpu["pg_costs"])
    ba_rel = rel_curve(card["costs"], on_cpu["costs"])
    pose_err = max(float((card[k].cpu() - on_cpu[k]).abs().max())
                   for k in ("R0", "t0", "R", "t"))
    active_same = float((card["active"] == on_cpu["active"]).mean())
    costs = card["costs"].cpu().numpy()
    rn = _residual_norms(card["R"], card["t"], card["lm"],
                         card["prob"]).cpu().numpy()
    active = card["active"]
    inl = active & (rn <= 2.0)
    inlier_rms = float(np.sqrt(np.mean(rn[inl] ** 2))) if inl.any() else -1.0
    print(f"[{tag}] keyframes {len(kfs)} ({kfs.tolist()}), landmarks "
          f"{int(lm_idx.max()) + 1}, observations {len(cam)}; chains + "
          f"keyframes {t_obs:.3f} s (host)")
    print(f"[{tag}] back end on the card (the second of two runs): pose "
          f"graph build {card['secs'][0]:.3f} s, optimization (10 "
          f"iterations) {card['secs'][1]:.3f} s, gated BA (3 rounds x 17 "
          f"iterations) {card['secs'][2]:.3f} s; first run "
          f"{', '.join(f'{s:.3f}' for s in runs[0]['secs'])} s; the CPU "
          f"{', '.join(f'{s:.3f}' for s in on_cpu['secs'])} s")
    print(f"[{tag}] pose graph cost {float(card['pg_costs'][0]):.6g} -> "
          f"{float(card['pg_costs'][-1]):.6g}; BA cost {costs[0]:.6g} -> "
          f"{costs[-1]:.6g}; inlier RMS {inlier_rms:.4f} px, gated out "
          f"{1.0 - active.mean():.4f}, active {int(active.sum())}")
    print(f"[{tag}] two card runs bit-equal: {same}; card against the CPU: "
          f"pose graph costs {pg_rel:.3g} and BA costs {ba_rel:.3g} "
          f"relative (tolerance {SLAM_COST_TOL}), poses {pose_err:.3g} "
          f"(tolerance {SLAM_POSE_TOL}), gate decisions equal on "
          f"{active_same:.5f} of the observations (at least "
          f"{SLAM_ACTIVE_SHARE})")
    check(same, "two card runs of the SLAM back end differ")
    check(pg_rel <= SLAM_COST_TOL and ba_rel <= SLAM_COST_TOL,
          "SLAM back end cost curves differ from the CPU's")
    check(pose_err <= SLAM_POSE_TOL, "SLAM poses differ from the CPU's")
    check(active_same >= SLAM_ACTIVE_SHARE,
          "SLAM gate decisions differ from the CPU's")
    check(costs[-1] < costs[0], "the BA cost did not fall")
    # the profiler's cost grows with its events: the back end with one
    # round of 4 iterations of gated BA (3 x 17 above)
    profile_device(lambda: slam_back_end(obs, shape, "cuda",
                                         dict(SLAM_GATED, rounds=1,
                                              iterations=4)), 1, tag,
                   "the SLAM back end (pose graph build, 10 iterations of "
                   "its optimization, 4 of gated BA)", {})
    return launches, {"obs": obs, "shape": shape, "card": card}


def count_syncs(run) -> int:
    """Host synchronisations in run(), as torch's sync debug mode flags
    them (not its one-time notice that the mode is a prototype)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) and
               "prototype" not in str(w.message) for w in caught)


def scale_ba_fields():
    """tests/test_slam.py:241-287 (klt_tpu's north-star scale contract,
    there over an 8-device mesh): 200 poses, 20,000 landmarks seen by 4
    consecutive poses each, exact observations, landmarks perturbed by
    0.02.  Returns (numpy fields, true landmarks)."""
    rng = np.random.RandomState(4)
    n_pose, n_lm, obs_per_lm = 200, 20000, 4
    lm = rng.uniform([-4, -4, 4], [4, 4, 12], (n_lm, 3)).astype(np.float32)
    R = np.stack([so3_exp(torch.from_numpy(
        rng.randn(3).astype(np.float32) * 0.01)).numpy()
        for _ in range(n_pose)])
    t = np.stack([[0.02 * p, 0, 0] for p in range(n_pose)]).astype(
        np.float32)
    first = rng.randint(0, n_pose - obs_per_lm, n_lm)
    cam = (first[:, None] + np.arange(obs_per_lm)[None, :]).reshape(-1) \
        .astype(np.int32)
    lmi = np.repeat(np.arange(n_lm, dtype=np.int32), obs_per_lm)
    pc = np.einsum("mij,mj->mi", R[cam], lm[lmi]) + t[cam]
    uv = slam_project(torch.from_numpy(pc.astype(np.float32)), 300.0, 300.0,
                      160.0, 120.0).numpy()
    lm0 = lm + 0.02 * rng.randn(*lm.shape).astype(np.float32)
    return dict(R=R, t=t, landmarks=lm0.astype(np.float32), cam_idx=cam,
                lm_idx=lmi, uv=uv, weight=np.ones(len(cam), np.float32),
                fx=300.0, fy=300.0, cx=160.0, cy=120.0), lm


def scale_pose_graph_fields():
    """tests/test_slam.py:302-351: an 800-keyframe chain with loop
    closures every 50, exact edges, noisy initial poses.  Returns (numpy
    fields, true t)."""
    rng = np.random.RandomState(6)
    n = 800
    R_true = [np.eye(3, dtype=np.float32)]
    t_true = [np.zeros(3, np.float32)]
    for _ in range(1, n):
        w = rng.randn(3).astype(np.float32) * 0.01
        R_true.append(so3_exp(torch.from_numpy(w)).numpy() @ R_true[-1])
        t_true.append(t_true[-1] + [0.05, 0, 0])
    R_true, t_true = np.stack(R_true), np.stack(t_true)
    ei = np.arange(n - 1, dtype=np.int32)
    ej = ei + 1
    li = np.arange(0, n - 50, 50, dtype=np.int32)
    ei, ej = np.concatenate([ei, li]), np.concatenate([ej, li + 50])
    Rz = np.einsum("eij,ekj->eik", R_true[ei], R_true[ej])
    tz = t_true[ei] - np.einsum("eij,ej->ei", Rz, t_true[ej])
    R0 = np.stack([so3_exp(torch.from_numpy(
        rng.randn(3).astype(np.float32) * (0 if p == 0 else 0.005))).numpy()
        @ R_true[p] for p in range(n)])
    t0 = t_true + 0.01 * rng.randn(n, 3).astype(np.float32)
    t0[0] = t_true[0]
    return dict(R=R0.astype(np.float32), t=t0.astype(np.float32), ei=ei,
                ej=ej, Rz=Rz.astype(np.float32), tz=tz.astype(np.float32),
                weight=np.ones(len(ei), np.float32)), t_true


def spiked_ba_fields(n_pose=30, n_lm=2000):
    """tests/test_slam.py:16-52 and :88-126 at 30 poses x 2000 landmarks:
    every landmark seen by every pose, 0.3 px of noise, poses and
    landmarks perturbed, 40% of the observations moved by 8-60 px.
    Returns (numpy fields, spiked mask)."""
    rng = np.random.RandomState(7)
    fx = fy = 300.0
    cx, cy = 160.0, 120.0
    lm = rng.uniform([-2, -2, 4], [2, 2, 8], (n_lm, 3)).astype(np.float32)
    R_true = np.stack([so3_exp(torch.from_numpy(
        rng.randn(3).astype(np.float32) * 0.02)).numpy()
        for _ in range(n_pose)])
    t_true = np.stack([[0.1 * p, 0, 0] for p in range(n_pose)]).astype(
        np.float32)
    cam = np.repeat(np.arange(n_pose, dtype=np.int32), n_lm)
    lmi = np.tile(np.arange(n_lm, dtype=np.int32), n_pose)
    pc = np.einsum("mij,mj->mi", R_true[cam], lm[lmi]) + t_true[cam]
    uv = slam_project(torch.from_numpy(pc.astype(np.float32)), fx, fy, cx,
                      cy).numpy()
    uv = uv + 0.3 * rng.randn(*uv.shape).astype(np.float32)
    R0, t0 = [], []
    for p in range(n_pose):
        w = rng.randn(3).astype(np.float32) * (0 if p == 0 else 0.02)
        R0.append(so3_exp(torch.from_numpy(w)).numpy() @ R_true[p])
        t0.append(t_true[p] + (0 if p == 0 else
                               0.02 * rng.randn(3).astype(np.float32)))
    lm0 = lm + 0.05 * rng.randn(*lm.shape).astype(np.float32)
    m = len(cam)
    spike = rng.rand(m) < 0.4
    off = rng.uniform(8.0, 60.0, (m, 2)).astype(np.float32) * \
        np.sign(rng.randn(m, 2)).astype(np.float32)
    uv = uv + np.where(spike[:, None], off, 0.0)
    return dict(R=np.stack(R0).astype(np.float32),
                t=np.stack(t0).astype(np.float32),
                landmarks=lm0.astype(np.float32), cam_idx=cam, lm_idx=lmi,
                uv=uv.astype(np.float32),
                weight=np.ones(m, np.float32), fx=fx, fy=fy, cx=cx,
                cy=cy), spike


def solver_costs(out):
    """The cost curve of a solver's output (the last tensor but the
    gated BA's active mask)."""
    return out[3] if len(out) == 5 else out[-1]


# phase 37's wall ms and device us per LM iteration, by solver (phase 39
# prints them beside its mesh runs)
SCALE_TIMES = {}


def run_solver_at_scale(tag, name, solve, iterations, first_two,
                        start) -> tuple:
    """solve(device, iterations) on the card: one warm-up run, then host
    seconds and host syncs per LM iteration, device launches per LM
    iteration (profiler), and the first two LM iterations against the
    CPU (first_two(device) runs them; start: the CPU tensors of the state
    they begin from, in the order of the output).  Returns the card's
    output."""
    solve("cuda", iterations)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = solve("cuda", iterations)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    syncs = count_syncs(lambda: solve("cuda", iterations))
    # the profiler's cost grows with its events: two LM iterations (the
    # gated BA: one round of two)
    read = profile_device(lambda: first_two("cuda"), 2, tag,
                          f"{name}: its first two LM iterations", {})
    SCALE_TIMES[name.split(",")[0]] = (
        secs / iterations * 1e3, read and read["device_us"])
    two = [first_two(d) for d in ("cuda", "cpu")]
    rel = rel_curve(solver_costs(two[0]), solver_costs(two[1]))
    # the largest difference over the largest move of any state entry
    # (the poses of these problems start at or near the truth and barely
    # move, so each tensor's own move is no scale)
    step = max(float((a.cpu() - b).abs().max())
               for a, b, _ in zip(two[0], two[1], start)) / \
        max(float((b - s).abs().max()) for b, s in zip(two[1], start))
    print(f"[{tag}] {name}: {secs:.3f} s, {secs / iterations * 1e3:.2f} ms "
          f"and {syncs / iterations:.1f} host syncs per LM iteration; first "
          f"two LM iterations against the CPU: costs "
          f"{solver_costs(two[0]).tolist()} and "
          f"{solver_costs(two[1]).tolist()}, {rel:.3g} relative (tolerance "
          f"{SLAM_CG_TOL}); states {step:.3g} of their largest move")
    check(rel <= SLAM_CG_TOL,
          f"{name}: the card's first LM iterations differ from the CPU's")
    return out


def run_slam_scale(tag) -> None:
    """klt_tpu's SLAM scale tests (tests/test_slam.py, slow there and run
    over an 8-device mesh) on one card, with known ground truth."""
    f, lm_true = scale_ba_fields()
    prob = {d: ba_problem_from_numpy(f, d) for d in ("cuda", "cpu")}
    kw = dict(damping=1e-4, cg_iters=120)
    out = run_solver_at_scale(
        tag, "bundle_adjust_cg, 200 poses x 20,000 landmarks x 4 "
        "observations, 8 iterations, cg_iters 120",
        lambda d, its: bundle_adjust_cg(prob[d], iterations=its, **kw), 8,
        lambda d: bundle_adjust_cg(prob[d], iterations=2, **kw),
        (prob["cpu"].R, prob["cpu"].t, prob["cpu"].landmarks))
    costs = out[3].cpu().numpy()
    lm_err = float(np.abs(out[2].cpu().numpy() - lm_true).max())
    print(f"[{tag}] bundle_adjust_cg: cost after the first and the last "
          f"iteration {costs[0]:.6g} -> {costs[-1]:.6g} "
          f"({costs[0] / costs[-1]:.3g}x), landmarks within {lm_err:.3g} of "
          f"the truth")
    check(costs[-1] < costs[0] * 1e-2 and lm_err < 2e-2,
          "bundle_adjust_cg missed its scale contract")

    f, t_true = scale_pose_graph_fields()
    graph = {d: pose_graph_from_numpy(f, d) for d in ("cuda", "cpu")}
    kw = dict(solver="cg", damping=1e-4, cg_iters=400)
    out = run_solver_at_scale(
        tag, "optimize_pose_graph(solver=\"cg\"), 800 keyframes, loop "
        "closures every 50, 8 iterations, cg_iters 400",
        lambda d, its: optimize_pose_graph(graph[d], iterations=its, **kw),
        8, lambda d: optimize_pose_graph(graph[d], iterations=2, **kw),
        (graph["cpu"].R, graph["cpu"].t))
    costs = out[2].cpu().numpy()
    t_err = float(np.abs(out[1].cpu().numpy() - t_true).max())
    start = float(pose_graph._edge_cost(graph["cuda"].R, graph["cuda"].t,
                                        graph["cuda"]))
    print(f"[{tag}] optimize_pose_graph: cost {start:.6g} at the start, "
          f"{costs[0]:.6g} -> {costs[-1]:.6g} after the first and the last "
          f"iteration ({costs[0] / costs[-1]:.3g}x), t within {t_err:.3g} "
          f"of the truth")
    check(costs[-1] < costs[0] * 1e-2 and t_err < 3e-2,
          "optimize_pose_graph missed its scale contract")

    f, spike = spiked_ba_fields()
    prob = {d: ba_problem_from_numpy(f, d) for d in ("cuda", "cpu")}
    kw = dict(damping=1e-2, robust_delta=2.0, gate_px=3.0)
    out = run_solver_at_scale(
        tag, "bundle_adjust_gated, 30 poses x 2,000 landmarks, 40% spiked, "
        "3 rounds x 10 iterations",
        lambda d, its: bundle_adjust_gated(prob[d], rounds=3,
                                           iterations=its // 3, **kw), 30,
        lambda d: bundle_adjust_gated(prob[d], rounds=1, iterations=2, **kw),
        (prob["cpu"].R, prob["cpu"].t, prob["cpu"].landmarks))
    R, t, lm, costs, active = out
    rn = _residual_norms(R, t, lm, prob["cuda"]).cpu().numpy()
    rms = float(np.sqrt(np.mean(rn[active] ** 2)))
    print(f"[{tag}] bundle_adjust_gated: spikes active "
          f"{active[spike].mean():.4f} (at most 0.05), clean observations "
          f"active {active[~spike].mean():.4f} (at least 0.70), inlier RMS "
          f"{rms:.4f} px (at most 1)")
    check(active[spike].mean() <= 0.05 and active[~spike].mean() >= 0.70 and
          rms <= 1.0, "bundle_adjust_gated missed its contract")


# ------------------------------------------------------------------ #
# tooling (phase 38) and multi-device (phase 39)                       #
# ------------------------------------------------------------------ #

POS_TOL = 1e-3   # px, tests/test_torch_slice.py's: plain CPU against card
EXAMPLE_FRAMES = 64
EXAMPLE_MODES = ((), ("--replace",), ("--affine", "2"))


def debug_warnings(run) -> tuple:
    """(run()'s result, the messages of the debug checks' warnings)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = run()
    return out, [str(w.message) for w in caught
                 if "debug check failed" in str(w.message)]


def example_table_direct(frames, n_feats: int, mode) -> klt.FeatureTable:
    """The track_sequence example's loop written out with KLTracker on
    the card: its feature table."""
    cfg = klt.TrackingConfig(
        sequential_mode=True, affine_consistency_check=int(mode[1])
        if "--affine" in mode else -1)
    tracker = klt.KLTracker(cfg)
    fl = klt.FeatureList.create(n_feats)
    ft = klt.FeatureTable.create(len(frames), n_feats)
    tracker.select_good_features(frames[0], fl)
    ft.store_list(fl, 0)
    for i in range(1, len(frames)):
        tracker.track_features(frames[i - 1], frames[i], fl)
        if "--replace" in mode:
            tracker.replace_lost_features(frames[i], fl)
        ft.store_list(fl, i - 1)
    return ft


def phase_tooling(vga, aff, cfg, tag: str) -> dict:
    """Phase 38: the tooling on the card.  Returns each kernel's launches
    in the phase (all of them made by the paths it drives)."""
    from klt_tpu_torch import graft_entry
    from klt_tpu_torch.examples import track_sequence as example
    from klt_tpu_torch.io.features_io import read_feature_table
    from klt_tpu_torch.utils.debug import write_internal_images

    os.environ.pop("KLT_TPU_DEBUG", None)
    cuda.reset_launch_counts()
    launches = {k.symbol: 0 for k in cuda.KERNELS}

    def take():   # the counts so far into `launches`, then from 0
        for k in cuda.KERNELS:
            launches[k.symbol] += k.launches
        cuda.reset_launch_counts()

    fl = klt.FeatureList.create(2000)
    klt.KLTracker(cfg).select_good_features(vga[0], fl)
    dev_frames = torch.from_numpy(vga).cuda()
    feats = [torch.from_numpy(a).cuda() for a in (fl.x, fl.y, fl.val)]
    run = lambda: track_sequence(dev_frames, *feats, cfg)
    steps = len(vga) - 1
    groups = {"kernel B (lk_pyramid_kernel)": "lk_pyramid_kernel",
              "kernel A (pyramid_tiles)": PYRAMID_KERNELS}
    expect = {"kernel A (pyramid_tiles)":
              len(vga) * (1 + cfg.n_pyramid_levels)}
    label = f"track_sequence of {vga.shape[2]}x{vga.shape[1]}, " \
        f"{int((fl.val >= 0).sum())} features"

    # the checks with KLT_TPU_DEBUG unset against no checks at all
    def measure(what):
        take()   # launches_per_step counts from 0
        counts = launches_per_step(run, steps)
        syncs = count_syncs(run)
        read = profile_device(run, steps, tag, f"{label}, {what}", groups,
                              expect)
        return counts, syncs, read
    first = count_syncs(run)   # a process's first sync check may flag one
    with_checks = measure("the checks, KLT_TPU_DEBUG unset")
    saved = lk_ops._debug_checks
    lk_ops._debug_checks = lambda *a: None
    try:
        without = measure("no checks")
    finally:
        lk_ops._debug_checks = saved
    print(f"[{tag}] host syncs of a first checked run: {first}")
    print(f"[{tag}] KLT_TPU_DEBUG unset: kernel launches per step "
          f"{ {k: v for k, v in with_checks[0].items() if v} }, host syncs "
          f"{with_checks[1]}, device launches per step "
          f"{with_checks[2]['launches']:.2f}; without the checks "
          f"{ {k: v for k, v in without[0].items() if v} }, {without[1]}, "
          f"{without[2]['launches']:.2f}")
    check(with_checks[0] == without[0] and with_checks[1] == without[1] and
          with_checks[2]["launches"] == without[2]["launches"],
          "the checks cost launches or host syncs with debug off")

    # debug on, one feature planted outside the frame
    x = fl.x.copy()
    x[0] = -5.0
    val = fl.val.copy()
    val[0] = 0
    planted = [torch.from_numpy(a).cuda() for a in (x, fl.y, val)]
    off, none = debug_warnings(
        lambda: track_sequence(dev_frames, *planted, cfg))
    os.environ["KLT_TPU_DEBUG"] = "1"
    try:
        on, msgs = debug_warnings(
            lambda: track_sequence(dev_frames, *planted, cfg))
    finally:
        del os.environ["KLT_TPU_DEBUG"]
    same = all(bits_equal(a, b) for a, b in zip(on, off))
    print(f"[{tag}] KLT_TPU_DEBUG=1, feature 0 planted at x = -5: "
          f"{len(msgs)} warning(s) {msgs} over {steps} steps (none with "
          f"debug off: {len(none)}); table the same as with debug off: "
          f"{same}")
    check(len(msgs) == 1 and not none and same,
          "debug mode did not warn once, or changed the table")

    # write_internal_images from kernel A's stacks and the plain version's
    img = torch.from_numpy(vga[1]).cuda()
    stacks = {"kernel": pyramid_ops.build_pyramid_stacks(img, cfg),
              "plain": build_pyramid_stacks_plain(img, cfg)}
    with tempfile.TemporaryDirectory() as d:
        files = {k: write_internal_images([s[0] for s in st],
                                          [s[1] for s in st],
                                          [s[2] for s in st], f"{d}/{k}")
                 for k, st in stacks.items()}
        data = {k: [open(p, "rb").read() for p in v]
                for k, v in files.items()}
    print(f"[{tag}] write_internal_images: {len(files['kernel'])} PGMs "
          f"from kernel A's stacks, bytes equal to the plain version's: "
          f"{data['kernel'] == data['plain']}")
    check(data["kernel"] == data["plain"],
          "write_internal_images differs between kernel A and plain")

    # op_breakdown over a traced run against profile_device's
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d, head=run):
            run()
        rows = profiling.op_breakdown(d, runs=steps, top=1000)
    total = sum(r[0] for r in rows)
    named = {k: sum(r[1] for r in rows if any(s in r[3] for s in keys))
             for k, keys in (("A", PYRAMID_KERNELS),
                             ("B", ("lk_pyramid_kernel",)))}
    ref = with_checks[2]["device_us"]
    print(f"[{tag}] op_breakdown of {label}: {total:.1f} us of device "
          f"time per step (profile_device: {ref:.1f}, "
          f"{abs(total - ref) / ref:.3f} apart), launches per step: kernel "
          f"A {named['A']:.3f}, kernel B {named['B']:.3f}; top rows:")
    for us, n, cat, name in rows[:6]:
        print(f"[{tag}]   {us:9.2f} us/step  n={n:6.3f}  {cat:10s} "
              f"{name[:80]}")
    check(abs(named["A"] - expect["kernel A (pyramid_tiles)"] / steps) < 1e-9
          and named["B"] == 1.0 and abs(total - ref) <= 0.1 * ref,
          "op_breakdown disagrees with profile_device")

    # the track_sequence example against a KLTracker loop, three modes
    frames = aff[:EXAMPLE_FRAMES]
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(f"{d}/images_smoke")
        for i, f in enumerate(frames):
            klt.write_pgm(f"{d}/images_smoke/img{i}.pgm", f)
        saved_root = os.environ.get("KLT_DATA_ROOT")
        os.environ["KLT_DATA_ROOT"] = d
        try:
            for mode in EXAMPLE_MODES:
                out = f"{d}/out{len(mode)}{''.join(mode)}"
                t0 = time.perf_counter()
                check(example.main(["images_smoke", "1000",
                                    str(EXAMPLE_FRAMES), *mode, "--out",
                                    out]) == 0, "the example failed")
                secs = time.perf_counter() - t0
                got = read_feature_table(f"{out}/features.ft")
                ref = example_table_direct(frames, 1000, mode)
                equal = all(np.array_equal(getattr(got, k).view(np.int32),
                                           getattr(ref, k).view(np.int32))
                            for k in ("x", "y", "val"))
                print(f"[{tag}] example {' '.join(mode) or '(plain)'}, "
                      f"{frames.shape[2]}x{frames.shape[1]} x 1000 x "
                      f"{EXAMPLE_FRAMES} frames: {secs:.2f} s, "
                      f"{int((got.val[:, -2] == 0).sum())} tracked at the "
                      f"last step, features.ft equal to a KLTracker loop's: "
                      f"{equal}")
                check(equal, f"the example {mode} differs from KLTracker")
        finally:
            if saved_root is None:
                del os.environ["KLT_DATA_ROOT"]
            else:
                os.environ["KLT_DATA_ROOT"] = saved_root

    # the graft entry's pair step on the card against the plain CPU step
    fn, args = graft_entry.entry()
    card_out = [o.cpu() for o in fn(*args)]
    fn_c, args_c = graft_entry.entry(device="cpu")
    cpu_out = fn_c(*args_c)
    err = max_err(card_out[:2], cpu_out[:2])
    print(f"[{tag}] graft_entry.entry(): statuses equal to the plain CPU "
          f"step's: {torch.equal(card_out[2], cpu_out[2])} "
          f"({int((card_out[2] == 0).sum())} of 150 tracked), positions "
          f"within {err:.3g} px (tolerance {POS_TOL})")
    check(torch.equal(card_out[2], cpu_out[2]) and err <= POS_TOL,
          "graft_entry.entry() on the card differs from the CPU")
    torch.cuda.synchronize()
    take()
    return launches


def timed_iterations(solve, mesh, iterations: int, tag: str, label: str):
    """(solve(mesh, iterations), wall ms per LM iteration: the host clock
    around that synchronised run, device us per LM iteration:
    profile_device over solve(mesh, 1), the device traced alone)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = solve(mesh, iterations)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iterations
    read = profile_device(lambda: solve(mesh, 1), 1, tag, label, {},
                          host=False)
    return out, wall, read and read["device_us"]


def same_bits(a, b) -> bool:
    """Two outputs (tuples of tensors and numpy arrays) equal bit for
    bit."""
    return all(bits_equal(x, y) if isinstance(x, torch.Tensor)
               else np.array_equal(x, y) for x, y in zip(a, b))


def phase_multi_device(flag_b, flag_feats, cfg, tag: str) -> dict:
    """Phase 39: multi-device on the card, in a world of one rank on NCCL
    (a FileStore in a temporary directory).  Returns each kernel's
    launches in the phase."""
    import torch.distributed as dist
    from klt_tpu_torch import graft_entry
    from klt_tpu_torch.parallel import (make_batch_step, make_mesh,
                                        track_batch)
    from klt_tpu_torch.slam import bundle_adjust

    cuda.reset_launch_counts()
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/store",
                                rank=0, world_size=1)
        try:
            data = make_mesh({"data": -1})
            both = make_mesh({"data": 1, "feat": 1})
            frames = torch.from_numpy(flag_b).cuda()
            feats = [torch.from_numpy(a).cuda() for a in flag_feats]
            pair = (frames[:, 0].contiguous(), frames[:, 1].contiguous())
            for mesh, feat in ((data, None), (both, "feat")):
                step = make_batch_step(cfg, mesh, feat_axis=feat)(*pair,
                                                                  *feats)
                ref = make_batch_step(cfg)(*pair, *feats)
                seq = track_batch(frames, *feats, cfg, mesh, feat)
                seq_ref = track_batch(frames, *feats, cfg)
                ok = same_bits(step, ref) and same_bits(seq, seq_ref)
                print(f"[{tag}] make_batch_step and track_batch over "
                      f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} "
                      f"(feat_axis {feat}), {flag_b.shape[0]} x "
                      f"{flag_b.shape[3]}x{flag_b.shape[2]} x "
                      f"{flag_feats[0].shape[1]} over {flag_b.shape[1]} "
                      f"frames: bit-equal to mesh=None: {ok} "
                      f"({int((seq[2][-1] == 0).sum())} lanes tracked)")
                check(ok, "a mesh run differs from mesh=None")

            f, _ = scale_ba_fields()
            big = ba_problem_from_numpy(f, "cuda")
            f, _ = spiked_ba_fields()
            spiked = ba_problem_from_numpy(f, "cuda")
            f, _ = scale_pose_graph_fields()
            graph = pose_graph_from_numpy(f, "cuda")
            solves = (
                ("bundle_adjust_cg", "bundle_adjust_cg, 80,000 "
                 "observations", lambda m, its: bundle_adjust_cg(
                     big, m, iterations=its, damping=1e-4, cg_iters=120)),
                ("bundle_adjust", "bundle_adjust (dense), 60,000 "
                 "observations", lambda m, its: bundle_adjust(
                     spiked, m, iterations=its, damping=1e-2,
                     robust_delta=2.0)),
                ("bundle_adjust_gated", "bundle_adjust_gated, 60,000 "
                 "observations, rounds of 1 iteration",
                 lambda m, its: bundle_adjust_gated(
                     spiked, m, rounds=its, iterations=1, damping=1e-2,
                     robust_delta=2.0, gate_px=3.0)),
                ('optimize_pose_graph(solver="cg")', "optimize_pose_graph "
                 "cg, 800 keyframes, cg_iters 400",
                 lambda m, its: optimize_pose_graph(
                     graph, m, iterations=its, solver="cg", damping=1e-4,
                     cg_iters=400)))
            for key, label, solve in solves:
                ref, w0, d0 = timed_iterations(solve, None, 3, tag,
                                               f"{label}, mesh=None")
                got, w1, d1 = timed_iterations(solve, data, 3, tag,
                                               f"{label}, mesh {{data: 1}}")
                ok = same_bits(got, ref)
                p37 = SCALE_TIMES.get(key)
                nan = float("nan")
                print(f"[{tag}] {label}, 3 LM iterations: bit-equal to "
                      f"mesh=None: {ok}; per LM iteration, wall ms / device "
                      f"ms (one iteration profiled): mesh {w1:.2f} / "
                      f"{(d1 or nan) / 1e3:.2f}, mesh=None {w0:.2f} / "
                      f"{(d0 or nan) / 1e3:.2f}"
                      + (f"; phase 37 (8 or 30 iterations, two profiled) "
                         f"{p37[0]:.2f} / {(p37[1] or nan) / 1e3:.2f}"
                         if p37 else "; phase 37 does not run it"))
                check(ok, f"{label}: the mesh run differs from mesh=None")

            # the host's cost of one reduce: 2000 calls enqueued, then a
            # sync
            from klt_tpu_torch.parallel.mesh import all_reduce_sum
            parts = [torch.ones(6, device="cuda"),
                     torch.ones(800, 6, device="cuda")]
            group = data.get_group(0)
            for name, fn in (
                    ("all_reduce_sum of [6] and [800, 6]",
                     lambda: all_reduce_sum(parts, data, "data")),
                    ("dist.all_reduce of [800, 6] alone",
                     lambda: dist.all_reduce(parts[1], group=group))):
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(2000):
                    fn()
                torch.cuda.synchronize()
                us = (time.perf_counter() - t0) * 1e6 / 2000
                print(f"[{tag}] {name}: {us:.1f} us of wall a call (2000 "
                      f"calls, one sync)")

            graft_entry.dryrun_multichip(1)
            print(f"[{tag}] graft_entry.dryrun_multichip(1) on the card: "
                  f"ok")
        finally:
            dist.destroy_process_group()
    print(f"[{tag}] runs of more than one rank are held on the CPU with "
          f"gloo (tests/test_torch_mesh.py: 2 and 4 ranks); a run across "
          f"cards waits for a machine with more than one "
          f"({torch.cuda.device_count()} card here)")
    torch.cuda.synchronize()
    return launch_counts()


# ------------------------------------------------------------------ #
# whole-sequence programs: the graphed entries against their chunks    #
# run eagerly                                                          #
# ------------------------------------------------------------------ #

def graph_overhead(steps: int, nlev: int, longest: int = graph.K) -> float:
    """Device copies a step that the graphed loop adds to a single-sequence
    entry's (runtime/pipeline.py::_run): per call the first frame's stacks
    and the features into the static buffers (nlev + 3), per chunk the
    frames into the staging buffer, the last stacks and features carried
    (nlev + 3) and the table's rows out (3)."""
    chunks = len(graph.chunk_lengths(steps, longest))
    return (nlev + 3 + chunks * (nlev + 7)) / steps


def precomp_launches(steps: int, b: int = 1) -> int:
    """Kernel E's launches with precomp over `steps` steps of b sequences
    (the first frame apart): each chunk of the graphed loop builds its
    frames in launches of max(1, PRECOMP_FRAMES // b) frame indices."""
    per = max(1, PRECOMP_FRAMES // b)
    return sum(-(-n // per) for n in graph.chunk_lengths(steps, graph.K))


def graph_replays() -> int:
    return sum(p.replays for _, p in graph.programs())


@contextmanager
def eager_chunks():
    """Every chunk of every program run as a key's first chunk runs:
    eagerly on the side stream (Program.run's warm_up=True), with no
    capture and no replay."""
    run = graph.Program.run

    def eager(self, n, flags=None, warm_up=False):
        return run(self, n, flags, warm_up=True)
    graph.Program.run = eager
    try:
        yield
    finally:
        graph.Program.run = run


def graph_cell(tag: str, name: str, fn, steps: int,
               exact: bool = False) -> dict:
    """One cell of phase 40: the graphed entry's first call (the key's
    warm-up chunk and its captures) and a second one (replays only), both
    bit-equal to the same call with every chunk run eagerly; each call's
    kernel launches equal to the eager run's (the exact tier: every
    computed step one launch each of A, G, H2 and R's tie entry, as its
    chunking after a repair may differ); graphs replayed.  Prints the
    key's capture plus instantiation time.  Returns the warm call's
    launches."""
    known = {id(p) for _, p in graph.programs()}
    runs = {}
    for run in ("cold", "warm", "eager"):
        before, replays = launch_counts(), graph_replays()
        with eager_chunks() if run == "eager" else contextlib.nullcontext():
            out = fn()
        torch.cuda.synchronize()
        after = launch_counts()
        runs[run] = (out, {k: after[k] - before[k] for k in after},
                     graph_replays() - replays)
    new = [p for _, p in graph.programs() if id(p) not in known]
    ref = runs["eager"][0]
    same = {run: all(bits_equal(a, b) for a, b in zip(runs[run][0], ref))
            for run in ("cold", "warm")}
    nz = lambda c: {k: v for k, v in c.items() if v}
    print(f"[{tag}] {name}, {steps} steps: bit-equal to the eager run "
          f"{same}; graphs {sum(len(p.graphs) for p in new)} of "
          f"{len(new)} key(s), capture and instantiation "
          f"{sum(p.capture_seconds() for p in new) * 1e3:.1f} ms; replays "
          f"cold {runs['cold'][2]}, warm {runs['warm'][2]}, eager "
          f"{runs['eager'][2]}; launches warm {nz(runs['warm'][1])}, eager "
          f"{nz(runs['eager'][1])}")
    check(all(same.values()), f"{name}: the graphed run differs from the "
          f"eager run")
    check(runs["warm"][2] > 0 and runs["eager"][2] == 0,
          f"{name}: no graph replayed, or one replayed in the eager run")
    if not exact:
        check(runs["cold"][1] == runs["warm"][1] == runs["eager"][1],
              f"{name}: the graphed run's launches differ from the eager "
              f"run's")
    return runs["warm"][1]


def graph_capture_error(tag: str) -> None:
    """A chunk function that reads the host cannot be captured: the
    program raises at its first capture (after the eager warm-up) and
    runs nothing in its place."""
    flag = torch.zeros(1, device="cuda")
    prog = graph.Program(None, lambda n: float(flag.sum()),
                         torch.device("cuda"), capture=True)
    from klt_tpu_torch.utils.checks import Flags
    prog.run(1, Flags())          # the warm-up runs eagerly
    try:
        prog.run(1, Flags())
    except RuntimeError as e:
        msg = str(e).splitlines()[0]
    else:
        msg = None
    torch.cuda.synchronize()
    print(f"[{tag}] a chunk function that reads the host: its capture "
          f"raised {msg!r}")
    check(msg is not None, "a failed capture did not raise")


def phase_graphs(cells: dict, cfg, acfg, tag: str) -> dict:
    """Phase 40: each graphed sequence entry (cuda/graph.py) on the six
    cells against the same call with every chunk run eagerly, launches
    per step equal, the debug checks' one warning from inside the graphs,
    a capture that fails raising.  cells: name -> inputs.  Returns each
    cell's launches per step (warm graphed call)."""
    graph._clear()   # every key captured here, so its cost is printed
    per_step = {}

    def single(name, frames, n_feats, seq, c=cfg):
        fl = select_on(frames[0], n_feats, c)
        f = torch.from_numpy(frames).cuda()
        feats = [torch.from_numpy(a).cuda() for a in (fl.x, fl.y, fl.val)]
        steps = len(frames) - 1
        got = graph_cell(tag, name, lambda: seq(f, *feats, c), steps)
        per_step[name] = {k: round(v / steps, 3) for k, v in got.items()}
        return f, feats

    f, feats = single("track_sequence 640x480", cells["vga"], 2000,
                      track_sequence)
    single("replace run 640x480 x 500", cells["traffic"], 500,
           track_sequence_replace)
    single("affine run 640x480", cells["aff"], 2000, track_sequence_affine,
           acfg)
    for name, frames, feats_b, c, seq in (
            ("batched 32 x 320x240 x 150", cells["flag_b"],
             cells["flag_feats"], cfg, track_sequences_batched),
            ("batched affine 8 x 640x480", cells["aff_b"],
             cells["aff_b_feats"], acfg, track_sequences_affine_batched)):
        fb = torch.from_numpy(frames).cuda()
        fd = [torch.from_numpy(a).cuda() for a in feats_b]
        steps = frames.shape[1] - 1
        got = graph_cell(tag, name, lambda: seq(fb, *fd, c), steps)
        per_step[name] = {k: round(v / steps, 3) for k, v in got.items()}
        del fb, fd

    # the exact run: the traffic frames, then the tie-forcing flagship,
    # whose repair resumes in the middle of a chunk
    for name, frames, n_feats in (
            ("exact run 640x480 x 500", cells["exact"], 500),
            ("exact flagship with a tie 320x240 x 150", cells["tie"], 150)):
        fl = select_on(frames[0], n_feats, cfg)
        fe = torch.from_numpy(frames).cuda()
        fd = [torch.from_numpy(a).cuda() for a in (fl.x, fl.y, fl.val)]
        reps = []   # the frames each call repaired: cold, warm, eager

        def run():
            reps.append([])
            with no_plain_versions(), counting_repairs(reps[-1]):
                return track_sequence_replace_exact(fe, *fd, cfg)
        got = graph_cell(tag, name, run, len(frames) - 1, exact=True)
        check_exact_launches(tag, got, reps[1], len(frames), "exact")
        print(f"[{tag}] {name}: frames repaired, graphed {reps[1]}, eager "
              f"{reps[2]}")
        check(reps[0] == reps[1] == reps[2], f"{name}: the graphed run "
              f"repaired other frames than the eager run")
        if "tie" in name:
            check(len(reps[1]) >= 1, "the tie flagship repaired no frame")
        steps = max(1, got[cuda.REPLACE_LOST_TIE.symbol])
        per_step[name] = {k: round(v / steps, 3) for k, v in got.items()}

    # the debug checks from inside the graphs: one warning, the same table
    fl = select_on(cells["vga"][0], 2000, cfg)
    x = fl.x.copy()
    x[0] = -5.0
    val = fl.val.copy()
    val[0] = 0
    planted = [torch.from_numpy(a).cuda() for a in (x, fl.y, val)]
    off = track_sequence(f, *planted, cfg)
    os.environ["KLT_TPU_DEBUG"] = "1"
    try:
        track_sequence(f, *planted, cfg)     # the debug key's captures
        replays = graph_replays()
        on, msgs = debug_warnings(lambda: track_sequence(f, *planted, cfg))
        replays = graph_replays() - replays
    finally:
        del os.environ["KLT_TPU_DEBUG"]
    same = all(bits_equal(a, b) for a, b in zip(on, off))
    print(f"[{tag}] KLT_TPU_DEBUG=1, feature 0 planted at x = -5, {replays} "
          f"replays: {len(msgs)} warning(s) {msgs}; table the same as with "
          f"debug off: {same}")
    check(len(msgs) == 1 and same and replays > 0,
          "the graphed debug checks did not warn once, or changed the table")
    graph_capture_error(tag)
    return per_step


# ------------------------------------------------------------------ #
# KLTracker's step programs and track_pair_carry's against their steps #
# run eagerly                                                          #
# ------------------------------------------------------------------ #

TRACKER_AFFINE_FRAMES = 20
TRACKER_PROFILE_CALLS = 20


def tracker_programs(tr) -> list:
    return [p for _, progs in tr._steps.values() for p in progs.values()]


def tracker_flow(frames, fl, cfg, replace: bool = False, tracker=None,
                 calls=None) -> dict:
    """KLTracker on the card over the frames, with replace_lost_features
    after every call when asked; fl moves in place.  Returns the feature
    list after every call, the kernel launches of the run, the number of
    tracking calls, the tracker's graph replays and its programs' capture
    seconds."""
    tr = tracker or klt.KLTracker(cfg, device="cuda")
    before = launch_counts()
    rows = []
    n_calls = len(frames) - 1 if calls is None else calls
    for i in range(1, n_calls + 1):
        tr.track_features(frames[i - 1], frames[i], fl)
        rows.append(fl.copy())
        if replace:
            tr.replace_lost_features(frames[i], fl)
            rows.append(fl.copy())
    after = launch_counts()
    progs = tracker_programs(tr)
    return {"rows": rows, "tracker": tr, "calls": n_calls,
            "launches": {k: after[k] - before[k] for k in after},
            "replays": sum(p.replays for p in progs),
            "capture_s": [p.capture_seconds() for p in progs if p.graphs]}


def same_rows(a, b) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(getattr(r, k).view(np.int32),
                       getattr(q, k).view(np.int32))
        for r, q in zip(a, b) for k in ("x", "y", "val"))


def tracker_device_us(frames, n_feats, cfg, replace, tag, label):
    """Device time and device launches per call of a tracker's steady
    calls (profile_device over TRACKER_PROFILE_CALLS calls, after the
    calls that warm up and capture the programs)."""
    fl = select_on(frames[0], n_feats, cfg)
    tr = klt.KLTracker(cfg, device="cuda")
    tracker_flow(frames, fl, cfg, replace, tr, calls=5)
    state = {"i": 5}

    def run():
        for _ in range(TRACKER_PROFILE_CALLS):
            i = state["i"] % (len(frames) - 1) + 1
            tr.track_features(frames[i - 1], frames[i], fl)
            if replace:
                tr.replace_lost_features(frames[i], fl)
            state["i"] += 1
    return profile_device(run, TRACKER_PROFILE_CALLS, tag, label, {})


def tracker_cell(tag: str, name: str, frames, n_feats: int, cfg,
                 replace: bool) -> dict:
    """One cell of phase 41: the graphed KLTracker flow bit-equal to the
    same flow with every step run eagerly, with its launches, the calls
    after the first ones replays; the graphed flow's device time per
    call.  Returns the graphed flow."""
    start = select_on(frames[0], n_feats, cfg)
    graphed = tracker_flow(frames, start.copy(), cfg, replace)
    with eager_chunks():
        eager = tracker_flow(frames, start.copy(), cfg, replace)
    same = same_rows(graphed["rows"], eager["rows"])
    dev = tracker_device_us(frames, n_feats, cfg, replace, tag, name)
    calls = graphed["calls"]
    nz = lambda c: {k: v for k, v in c.items() if v}
    print(f"[{tag}] {name}, {calls} calls: bit-equal to the eager run "
          f"{same}; replays {graphed['replays']}; capture and "
          f"instantiation ms a key "
          f"{[round(v * 1e3, 1) for v in graphed['capture_s']]}; device us "
          f"per call (with the replacement's, where it replaces) "
          f"{dev['device_us']:.1f}; launches graphed "
          f"{nz(graphed['launches'])}, eager {nz(eager['launches'])}")
    check(same, f"{name}: the graphed KLTracker differs from its eager "
          f"run")
    check(graphed["launches"] == eager["launches"],
          f"{name}: the graphed KLTracker's launches differ from the eager "
          f"run's")
    check(graphed["replays"] == calls - 3 and eager["replays"] == 0,
          f"{name}: {graphed['replays']} replays in {calls} calls, "
          f"{eager['replays']} in the eager run")
    return graphed


def tracker_capture_error(tag: str, cfg, frames, fl) -> None:
    """A step that reads the host: the tracker's second call (the
    capture) raises and runs nothing in its place; the card goes on."""
    from klt_tpu_torch.runtime import tracker as tracker_mod
    orig = tracker_mod._track_step

    def reads_host(b, *args):
        orig(b, *args)
        float(b.out.sum())
    tracker_mod._track_step = reads_host
    try:
        tr = klt.KLTracker(cfg, device="cuda")
        tr.track_features(frames[0], frames[1], fl.copy())
        try:
            tr.track_features(frames[1], frames[2], fl.copy())
        except RuntimeError as e:
            msg = str(e).splitlines()[0]
        else:
            msg = None
    finally:
        tracker_mod._track_step = orig
    torch.cuda.synchronize()
    after = fl.copy()
    klt.KLTracker(cfg, device="cuda").track_features(frames[0], frames[1],
                                                     after)
    print(f"[{tag}] a step that reads the host: the tracker's capture "
          f"raised {msg!r}; a new tracker then tracked "
          f"{int((after.val == 0).sum())} features")
    check(msg is not None, "a failed capture of the tracker did not raise")


def pair_carry_cell(tag: str, frames, n_feats: int, cfg) -> dict:
    """track_pair_carry's graph against the same calls with the step run
    eagerly over the frames: bit-equal, the same launches, every returned
    tensor unchanged after the later calls.  Returns the graphed chain's
    launches."""
    graph._clear()
    fl = select_on(frames[0], n_feats, cfg)
    feats0 = [torch.from_numpy(a).cuda() for a in (fl.x, fl.y, fl.val)]
    imgs = torch.from_numpy(frames).cuda()
    runs = {}
    for name in ("graphed", "eager"):
        feats, state = feats0, pipeline.prepare_pyramids(imgs[0], cfg)
        before = launch_counts()
        outs = []
        with eager_chunks() if name == "eager" else contextlib.nullcontext():
            for i in range(1, len(frames)):
                feats, state = pipeline.track_pair_carry(state, imgs[i],
                                                         feats, cfg)
                outs.append((*feats, *state))
        torch.cuda.synchronize()
        after = launch_counts()
        runs[name] = (outs, {k: after[k] - before[k] for k in after},
                      [[a.clone() for a in o] for o in outs])
    same = all(bits_equal(a, b) for o, q in zip(runs["graphed"][0],
                                                runs["eager"][0])
               for a, b in zip(o, q))
    kept = all(bits_equal(a, b) for o, q in zip(runs["graphed"][0],
                                                runs["graphed"][2])
               for a, b in zip(o, q))
    progs = [p for k, p in graph.programs() if k[0] == "pair_carry"]
    print(f"[{tag}] track_pair_carry {frames.shape[2]}x{frames.shape[1]} x "
          f"{int((fl.val >= 0).sum())}, {len(frames) - 1} calls: bit-equal "
          f"to the eager run {same}; returned tensors unchanged after the "
          f"later calls {kept}; replays {sum(p.replays for p in progs)}; "
          f"capture ms {[round(p.capture_seconds() * 1e3, 1) for p in progs]}")
    check(same and kept, "track_pair_carry's graph differs from its eager "
          "run, or a returned tensor changed")
    check(runs["graphed"][1] == runs["eager"][1],
          "track_pair_carry's launches differ from the eager run's")
    check(sum(p.replays for p in progs) == len(frames) - 2,
          "track_pair_carry did not replay its graph")
    return runs["graphed"][1]


def phase_tracker_graphs(vga, traffic, aff, cfg, acfg, tag: str) -> dict:
    """Phase 41: KLTracker's step programs against its steps run eagerly
    on the translation run (640x480 x 2000 requested, 100 frames), the
    replace loop (640x480 x 500, the first 100 traffic frames) and the
    affine run with replacement (640x480 x 2000 requested, mode 2, 4
    levels, TRACKER_AFFINE_FRAMES frames); two trackers interleaved; a
    capture that fails; track_pair_carry's graph against its step run
    eagerly.  Returns
    the graphed runs' kernel launches (counted from 0)."""
    cuda.reset_launch_counts()
    launches = dict.fromkeys(launch_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v
    aff20 = aff[:TRACKER_AFFINE_FRAMES]
    cells = {}
    for name, frames, n, c, replace in (
            ("track 640x480 x 2000 requested", vga, 2000, cfg, False),
            ("replace loop 640x480 x 500", traffic[:100], 500, cfg, True),
            ("affine 640x480 x 2000 requested, mode 2, with replacement",
             aff20, 2000, acfg, True)):
        cells[name] = tracker_cell(tag, name, frames, n, c, replace)
        add(cells[name]["launches"])

    # two trackers interleaved call by call: each equals its run alone
    first, third = (cells[k] for k in list(cells)[::2])
    fa, fb = select_on(vga[0], 2000, cfg), select_on(aff20[0], 2000, acfg)
    ta = klt.KLTracker(cfg, device="cuda")
    tb = klt.KLTracker(acfg, device="cuda")
    rows_a, rows_b = [], []
    before = launch_counts()
    for i in range(1, len(aff20)):
        ta.track_features(vga[i - 1], vga[i], fa)
        rows_a.append(fa.copy())
        tb.track_features(aff20[i - 1], aff20[i], fb)
        rows_b.append(fb.copy())
        tb.replace_lost_features(aff20[i], fb)
        rows_b.append(fb.copy())
    after = launch_counts()
    add({k: after[k] - before[k] for k in after})
    same = (same_rows(rows_a, first["rows"][:len(rows_a)]) and
            same_rows(rows_b, third["rows"]))
    print(f"[{tag}] two trackers interleaved call by call (translation "
          f"and affine with replacement, {len(aff20) - 1} calls each): each "
          f"equal to its run alone: {same}")
    check(same, "interleaved trackers differ from their runs alone")

    tracker_capture_error(tag, klt.TrackingConfig(), vga,
                          select_on(vga[0], 2000, cfg))
    add(pair_carry_cell(tag, vga, 2000, cfg))
    return launches


# ------------------------------------------------------------------ #
# the SLAM solvers' programs against their eager bodies (phase 42)     #
# ------------------------------------------------------------------ #

@contextmanager
def made_solves():
    """Every solve's programs made inside (slam/solvers.py::LMSolve), in
    order."""
    made = []
    init = slam_solvers.LMSolve.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)
    slam_solvers.LMSolve.__init__ = spy
    try:
        yield made
    finally:
        slam_solvers.LMSolve.__init__ = init


@contextmanager
def strict_programs():
    """Every program made inside runs its step (warm-up and capture)
    under torch.cuda.set_sync_debug_mode("error"): a step that reads the
    host raises."""
    base = graph.Program

    class Strict(base):
        def __init__(self, static, chunk_fn, device, capture):
            def strict(n):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return chunk_fn(n)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            super().__init__(static, strict, device, capture)
    graph.Program = Strict
    try:
        yield
    finally:
        graph.Program = base


# copies a solve's programs make into their static buffers and out of
# them, per solve (slam/ba.py::_Solve: R, t, landmarks, uv, weight in and
# R, t, landmarks out; slam/pose_graph.py::_Solve: the 7 fields of the
# graph in, R and t out; slam/frontend.py::_PairSolve: R, t, landmarks,
# uv, weight in, R and t out)
SOLVE_COPIES = {"ba": (5, 3), "pose_graph": (7, 2), "pair": (5, 2)}
# what CG's start copies into its static buffers an LM iteration (r, p,
# rz: slam/solvers.py::_cg_start)
CG_START_COPIES = 3


def program_overhead(solve, kind: str, iterations: int,
                     rounds: int = 1) -> int:
    """Device launches a solve's programs add to its eager body's: the
    copies in and out (SOLVE_COPIES), an LM iteration CG's start copies
    and the cost slot's copy out, less the eager body's stack of each
    round's cost curve; kernel R's ticket, made at each program's first
    capture (cuda/graph.py); and two fills a captured graph (the random
    generator's seed and offset, which torch's capture sets)."""
    into, out = SOLVE_COPIES[kind]
    curve = solve.cost is not None
    per_it = CG_START_COPIES * (solve.cg is not None) + curve
    tickets = sum(1 for p in solve.programs() if p.graphs)
    graphs = sum(len(p.graphs) for p in solve.programs())
    return into + out + per_it * iterations * rounds - curve * rounds + \
        tickets + 2 * graphs


SCALE_KW = {"ba_cg": dict(damping=1e-4, cg_iters=120),
            "pg_cg": dict(solver="cg", damping=1e-4, cg_iters=400),
            "gated": dict(damping=1e-2, robust_delta=2.0, gate_px=3.0)}


def scale_cells() -> dict:
    """Phase 37's three solves on the card: kind -> (name, problem,
    iterations of the full solve's rounds, rounds)."""
    f, _ = scale_ba_fields()
    ba_prob = ba_problem_from_numpy(f, "cuda")
    f, _ = scale_pose_graph_fields()
    graph_prob = pose_graph_from_numpy(f, "cuda")
    f, _ = spiked_ba_fields()
    spiked = ba_problem_from_numpy(f, "cuda")
    return {
        "ba_cg": ("bundle_adjust_cg, 200 poses x 20,000 landmarks x 4 "
                  "observations, cg_iters 120", ba_prob, 8, 1),
        "pg_cg": ("optimize_pose_graph(solver=\"cg\"), 800 keyframes, "
                  "cg_iters 400", graph_prob, 8, 1),
        "gated": ("bundle_adjust_gated, 30 poses x 2,000 landmarks, 40% "
                  "spiked, cg_iters 250", spiked, 10, 3)}


def scale_solve(kind: str, x, eager: bool, iterations: int,
                rounds: int = 1):
    """One of phase 37's solves on x: the entry point (its programs) or
    its eager body; iterations LM iterations a round (rounds: the gated
    BA's)."""
    kw = SCALE_KW[kind]
    if kind == "ba_cg":
        if eager:
            return slam_ba._bundle_adjust_eager(
                x, iterations, kw["damping"], cg=(kw["cg_iters"], 1e-5))
        return bundle_adjust_cg(x, iterations=iterations, **kw)
    if kind == "pg_cg":
        solve = pose_graph._optimize_pose_graph_eager if eager \
            else optimize_pose_graph
        return solve(x, iterations=iterations, **kw)
    solve = slam_ba._bundle_adjust_gated_eager if eager \
        else bundle_adjust_gated
    return solve(x, rounds=rounds, iterations=iterations, **kw)


def solve_bits(out) -> list:
    """A solve's outputs as tensors (the gated BA's active mask too)."""
    return [o if isinstance(o, torch.Tensor) else torch.from_numpy(o)
            for o in out]


def check_replays(name: str, solve, lm_iterations: int,
                  refits: int = 0) -> None:
    """After its first LM iteration a solve runs only replays: each step
    program lm_iterations - 1 of them, CG's every chunk but the first
    iteration's (at most ceil(cg_iters / 8) run eagerly), the refit
    program every step but its first."""
    steps = [p.replays for p in solve.steps]
    cg_first = -(-solve.cg.cg_iters // slam_solvers.CG_CHECK_EVERY) \
        if solve.cg is not None else 0
    ok = all(r == lm_iterations - 1 for r in steps)
    cg = (solve.cg.chunks, solve.cg.program.replays) if solve.cg else None
    if cg:
        ok &= cg[1] > 0 and cg[0] - cg[1] <= cg_first
    if refits:
        ok &= solve.refit.replays == refits - 1
    check(ok, f"{name}: LM iterations after the first did not all replay "
          f"(step replays {steps}, CG chunks and replays {cg})")


def graph_captures(solve) -> list:
    """Capture plus instantiation ms of each graph of a solve."""
    return [round(g.seconds * 1e3, 1) for p in solve.programs()
            for g in p.graphs.values()]


# LM iterations (a round's) of phase 42's solves: the first eager, the
# second capturing, the others replays (phase 37 runs the full solves)
SOLVER_CELL_ITERATIONS = 4


def paired_device(head, runs: dict, steps: int, tag: str,
                  label: str) -> dict | None:
    """Device us and device launches per step of each run in runs (name
    -> callable), read as profile_device reads one run: in one
    torch.profiler window opened by head() (not read) and each run
    between two marker kernels, the window closed by
    utils/profiling.py::close_window.  None when the profiler recorded
    no device event or lost a marker."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        head()
        for run in runs.values():
            profiling.marker()
            run()
        torch.cuda.synchronize()
        profiling.close_window()
    events = sorted((ev for ev in prof.events()
                     if "CUDA" in str(ev.device_type)),
                    key=lambda ev: ev.time_range.start)
    marks = [i for i, ev in enumerate(events) if "spin_kernel" in ev.name]
    print(f"[{tag}] {label}: {len(events)} device events in the window, "
          f"{len(marks)} of the {len(runs) + 1} markers")
    if len(marks) != len(runs) + 1:
        return None
    return {name: {"device_us": sum(ev.time_range.elapsed_us()
                                    for ev in events[a + 1:b]) / steps,
                   "launches": (b - a - 1) / steps}
            for name, a, b in zip(runs, marks, marks[1:])}


def solver_cell(tag: str, kind: str, name: str, x, iterations: int,
                rounds: int) -> None:
    """One of phase 37's solves in phase 42: the graphed solve bit-equal
    to its eager body, every LM iteration after the first a replay, host
    syncs per LM iteration (the eager body's: a capture reads nothing),
    and, from one profile of two LM iterations of each (one round;
    paired_device), device time and device launches per LM iteration
    (the graphed solve's: the eager body's plus program_overhead; a
    profile that differs is taken once more)."""
    its = iterations * rounds
    walls, outs, syncs = {}, {}, {}
    for mode in ("graphs", "eager"):
        with made_solves() as made:
            t0 = time.perf_counter()
            syncs[mode] = count_syncs(lambda: outs.setdefault(
                mode, solve_bits(scale_solve(kind, x, mode == "eager",
                                             iterations, rounds))))
            walls[mode] = time.perf_counter() - t0
        if mode == "graphs":
            solve = made[-1]
    same = all(bits_equal(a, b) for a, b in zip(outs["graphs"],
                                                outs["eager"]))
    check_replays(name, solve, its, 3 * (rounds - 1))
    captures = graph_captures(solve)
    for attempt in (1, 2):
        with made_solves() as made:
            dev = paired_device(
                lambda: scale_solve(kind, x, False, 1, 1),
                {m: (lambda m=m: scale_solve(kind, x, m == "eager", 2, 1))
                 for m in ("graphs", "eager")}, 2, tag,
                f"{name}: two LM iterations")
        overhead = program_overhead(
            made[1], "pose_graph" if kind == "pg_cg" else "ba", 2)
        n = dev and {m: round(dev[m]["launches"] * 2) for m in dev}
        if not n or n["graphs"] == n["eager"] + overhead:
            break
        print(f"[{tag}] {name}: device launches {n}, expected graphed = "
              f"eager + {overhead}" + (": profiling once more"
                                       if attempt == 1 else ""))
    print(f"[{tag}] {name}, {rounds} x {iterations} LM iterations: "
          f"bit-equal to the eager body {same}; wall per LM iteration "
          f"graphed {walls['graphs'] / its * 1e3:.2f} ms, eager "
          f"{walls['eager'] / its * 1e3:.2f} ms (first iteration and "
          f"captures included, sync debug mode on); graphs "
          f"{len(captures)}, capture and "
          f"instantiation ms {captures}; host syncs per LM iteration "
          f"graphed {syncs['graphs'] / its:.2f}, eager "
          f"{syncs['eager'] / its:.2f}")
    check(same, f"{name}: the graphed solve differs from its eager body")
    check(syncs["graphs"] == syncs["eager"],
          f"{name}: host syncs {syncs['graphs']} graphed, {syncs['eager']} "
          f"eager")
    if n:
        print(f"[{tag}] {name}: device us per LM iteration graphed "
              f"{dev['graphs']['device_us']:.1f}, eager "
              f"{dev['eager']['device_us']:.1f}; device launches of two LM "
              f"iterations graphed {n['graphs']}, eager {n['eager']} (+ "
              f"{overhead}: the programs' copies, tickets and capture "
              f"fills)")
        check(n["graphs"] == n["eager"] + overhead,
              f"{name}: device launches {n['graphs']} graphed, expected "
              f"{n['eager']} + {overhead}")


def solver_capture_error(tag: str) -> None:
    """A step that reads the host: the solve's second LM iteration (the
    captures) raises and nothing runs in its place; the card goes on."""
    f, _ = scale_pose_graph_fields()
    g = pose_graph_from_numpy(f, "cuda")
    orig = pose_graph._edge_cost

    def reads_host(R, t, pg):
        c = orig(R, t, pg)
        float(c)
        return c
    pose_graph._edge_cost = reads_host
    try:
        optimize_pose_graph(g, iterations=3, solver="cg", cg_iters=16)
    except RuntimeError as e:
        msg = str(e).splitlines()[0]
    else:
        msg = None
    finally:
        pose_graph._edge_cost = orig
    torch.cuda.synchronize()
    after = optimize_pose_graph(g, iterations=3, solver="cg", cg_iters=16)
    print(f"[{tag}] a step that reads the host: the solve's capture raised "
          f"{msg!r}; the next solve's costs "
          f"{[float(c) for c in after[2]]}")
    check(msg is not None, "a failed capture of a solve did not raise")
    check(bool(torch.isfinite(after[2]).all()),
          "the card did not go on after a failed capture")


def phase_solver_graphs(back_end: dict, tag: str) -> None:
    """Phase 42: the SLAM solvers' programs (slam/solvers.py::LMSolve)
    against their eager bodies: phase 37's three solves (bit-equal,
    replays, host syncs, device launches per LM iteration), each step run
    under the sync debug mode's "error" (warm-up and capture), phase 36's
    back end graphed and eager bit-equal to phase 36's run, and a capture
    that fails raising."""
    cells = scale_cells()
    for kind, (name, x, _, rounds) in cells.items():
        solver_cell(tag, kind, name, x, SOLVER_CELL_ITERATIONS, rounds)
    with strict_programs():
        for kind, (name, x, _, _) in cells.items():
            scale_solve(kind, x, False, 2, 2)
    torch.cuda.synchronize()
    print(f"[{tag}] every step of the three solves (2 LM iterations, the "
          f"gated BA 2 rounds) warmed up and captured under "
          f"set_sync_debug_mode(\"error\"): no host read")

    runs = {mode: slam_back_end(back_end["obs"], back_end["shape"], "cuda",
                                eager=mode == "eager")
            for mode in ("graphs", "eager")}
    same = all(back_ends_bit_equal(r, back_end["card"])
               for r in runs.values())
    secs = {m: [round(v, 4) for v in r["secs"]] for m, r in runs.items()}
    print(f"[{tag}] the SLAM back end (phase 36's observations): graphed "
          f"and eager bit-equal to phase 36's card run: {same}; seconds of "
          f"build, optimization, gated BA: graphs {secs['graphs']}, eager "
          f"{secs['eager']}")
    check(same, "the graphed SLAM back end differs from its eager body")
    solver_capture_error(tag)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1

    klt.set_verbosity(0)
    card = card_line()
    with phase("1 build"):
        phase_build(card)

    cfg = klt.TrackingConfig(sequential_mode=True)
    lighting = klt.TrackingConfig(sequential_mode=True,
                                  lighting_insensitive=True)
    n_traffic = TRAFFIC_FRAMES
    with phase("inputs"):
        qvga = synthetic_frames(10)
        traffic = synthetic_frames(n_traffic, scale=2)
        vga = traffic[:100]
        flag_b = batched_frames(*BATCHED_FLAGSHIP)
        real_b = batched_frames(*BATCHED_REAL, scale=2)
        flag_feats = batched_features(flag_b, 150, cfg)
        real_feats = batched_features(real_b, 4096, cfg)
        aff = affine_frames(AFFINE_FRAMES, scale=2)
        aff_small = affine_frames(10)
        aff_b = batched_affine_frames(*BATCHED_AFFINE, scale=2)
        aff_b_feats = batched_features(aff_b, 2000, affine_config())
    print("[inputs] synthetic frames: fixture scene translated by "
          "(3.2 sin 0.3k, 2.1 sin 0.23k) px, bilinear, u8; "
          f"{len(qvga)} x 320x240 and {len(traffic)} x 640x480 (scene "
          f"upsampled 2x); batched: {len(flag_b)} x {flag_b.shape[1]} x "
          f"320x240 and {len(real_b)} x {real_b.shape[1]} x 640x480, "
          "sequence b the scene flipped by b % 4 (none, x, y, both) and "
          "moved along its own path (lane_shift), features selected on "
          "each sequence's frame 0; affine: "
          f"{len(aff)} x 640x480 and {len(aff_small)} x 320x240, the same "
          "motion with a region of 112x96 (56x48) px slowly covered by a "
          "noise texture (weight 0.01 k) and zoomed (1 + 0.002 k); batched "
          f"affine: {aff_b.shape[0]} x {aff_b.shape[1]} x 640x480, sequence "
          "b that scene flipped by b % 4 and moved along lane_shift(b)",
          flush=True)
    errs = {k.symbol: [] for k in cuda.KERNELS}
    times = {}
    with phase("2 kernel A"):
        phase_pyramid((qvga, vga), cfg, errs[cuda.PYRAMID.symbol])
    with phase("2, 8 kernels A, E, configurations"):
        phase_pyramid_cases(errs[cuda.PYRAMID.symbol],
                            errs[cuda.PYRAMID_BATCHED.symbol])
    with phase("3 kernel B"):
        phase_lk((qvga, vga), (cfg, lighting), (150, 2000),
                 errs[cuda.LK_LEVEL.symbol])
    with phase("7 kernel D"):
        phase_corner_response((qvga, vga), cfg,
                              errs[cuda.CORNER_RESPONSE.symbol])
        phase_response_cases(errs[cuda.CORNER_RESPONSE.symbol],
                             errs[cuda.CORNER_RESPONSE_GLOBAL.symbol])
    with phase("8 kernel E"):
        phase_batched_pyramid((qvga[:10], traffic[:PRECOMP_FRAMES]), cfg,
                              errs[cuda.PYRAMID_BATCHED.symbol])
    with phase("9 kernel R"):
        phase_replace_kernel((qvga, vga), (150, 500), cfg,
                             errs[cuda.REPLACE_LOST.symbol])
        phase_replace_cases(errs[cuda.REPLACE_LOST.symbol])
    with phase("43 kernel S"):
        phase_select_sort(card, traffic, cfg,
                          errs[cuda.SELECT_LIST.symbol],
                          errs[cuda.SELECT_PARTITIONS.symbol], times)

    with phase("15 kernel C"):
        phase_batched_lk(((flag_b, flag_feats), (real_b, real_feats)),
                         (cfg, lighting), errs[cuda.LK_LEVEL_BATCHED.symbol])
    with phase("20 LK pyramid entries"):
        single = []
        for frames, n in ((qvga, 150), (vga, 2000)):
            fl = klt.FeatureList.create(n)
            klt.KLTracker(cfg).select_good_features(frames[0], fl)
            single.append((frames, (fl.x, fl.y, fl.val)))
        one_level = dataclasses.replace(cfg, n_pyramid_levels=1)
        phase_lk_pyramid(
            single,
            [(flag_b[:, :2], flag_feats), (real_b[:, :2], real_feats)],
            (("default", cfg), ("lighting", lighting),
             ("one level", one_level)),
            errs[cuda.LK_PYRAMID.symbol],
            errs[cuda.LK_PYRAMID_BATCHED.symbol])

    acfg = affine_config()
    # path 7: the affine run step by step, with the verification alone
    # (kernel F's track entry) at some of its steps; their states feed the
    # kernel's checks and times
    with phase("22 kernel F"):
        aff_states, step_launches = run_affine_steps(
            aff, select_on(aff[0], 2000, acfg), acfg, AFFINE_STEPS,
            "22 kernel F", errs[cuda.AFFINE_STEP.symbol])
        small_state = run_affine_steps(
            aff_small, select_on(aff_small[0], 150, acfg), acfg, (5,))[0][5]
        b_state, b_step_launches = run_batched_affine_steps(
            aff_b, aff_b_feats, acfg, BATCHED_AFFINE_STEP, "22 kernel F",
            errs[cuda.AFFINE_STEP.symbol])
        for name, st in ((f"640x480 x 2000 requested, step {AFFINE_STEPS[2]}",
                          aff_states[AFFINE_STEPS[2]]),
                         (f"{aff_b.shape[0]} x 640x480 x 2000 requested, step "
                          f"{BATCHED_AFFINE_STEP}", b_state)):
            print(f"[22 kernel F] {name}: iterations of the active lanes, "
                  f"how many ran 0, 1, .. {acfg.affine_max_iterations}: "
                  f"{iteration_histogram(st[8], st[7], acfg)}")
        phase_affine_kernel({t: aff_states[t] for t in AFFINE_STEPS
                             if t != AFFINE_STEPS[2]},
                            errs[cuda.AFFINE_TRACK.symbol],
                            [(f"{aff_b.shape[0]} x 640x480 x 2000 requested, step "
                              f"{BATCHED_AFFINE_STEP} of the batched run",
                              b_state[:8])])

    # main path 1: tracking (example3)
    cuda.reset_launch_counts()
    real = provided_frames()
    if real is not None:
        print("[4 flagship] images_provided frames from KLT_IMAGES_PROVIDED")
    with phase("4 flagship"):
        run_main_path(qvga if real is None else real, 150, cfg, "4 flagship",
                      known_motion=real is None)
    with phase("5 real size"):
        run_main_path(vga, 2000, cfg, "5 real size", known_motion=True)
    track_launches = {k.symbol: k.launches for k in cuda.KERNELS}
    # KLTracker and track_sequence each build every frame's pyramid once
    # and run one LK launch, the pyramid entry, per frame pair
    want_a = 2 * (len(qvga) + len(vga))
    want_b = 2 * sum(len(f) - 1 for f in (qvga, vga))
    print(f"[4-5 launches] {track_launches} (expected pyramid {want_a}, "
          f"lk_pyramid {want_b}, no other)")
    check(track_launches[cuda.PYRAMID.symbol] == want_a and
          track_launches[cuda.LK_PYRAMID.symbol] == want_b and
          sum(track_launches.values()) == want_a + want_b,
          "main path launch counts differ from the expected")

    # main path 2: tracking with replacement (example3 REPLACE, traffic)
    cuda.reset_launch_counts()
    with phase("10 replace flagship"):
        lost_q = run_replace_flagship(qvga, 150, cfg, "10 replace flagship")
    with phase("11 replace traffic"):
        lost_t = run_replace_traffic(traffic, 500, cfg, "11 replace traffic",
                                     n_cpu=100)
    replace_launches = {k.symbol: k.launches for k in cuda.KERNELS}
    # flagship: KLTracker + track_sequence_replace; traffic: kernels,
    # precomp, KLTracker; KLTracker computes the response (D) only on
    # frames with a lost feature, and kernel S's two entries make the list
    # and its large partitions from it before the walk on the host
    steps_q, steps_t = len(qvga) - 1, n_traffic - 1
    want = {k.symbol: 0 for k in cuda.KERNELS} | {
        cuda.PYRAMID.symbol: 2 * len(qvga) + 2 * n_traffic + 1,
        cuda.LK_PYRAMID.symbol: 2 * steps_q + 3 * steps_t,
        cuda.CORNER_RESPONSE.symbol: steps_q + lost_q + 2 * steps_t + lost_t,
        cuda.PYRAMID_BATCHED.symbol: precomp_launches(steps_t),
        cuda.REPLACE_LOST.symbol: steps_q + 2 * steps_t,
        cuda.SELECT_LIST.symbol: lost_q + lost_t,
        cuda.SELECT_PARTITIONS.symbol: lost_q + lost_t,
    }
    print(f"[10-11 launches] {replace_launches} (expected {want})")
    check(replace_launches == want,
          "replace path launch counts differ from the expected")

    # main path 3: batched multi-sequence tracking; run_batched counts
    # and checks each run's launches
    with phase("16 batched flagship"):
        l16 = run_batched(flag_b, flag_feats, cfg, "16 batched flagship",
                          n_cpu=min(4, len(flag_b)))
    with phase("17 batched real size"):
        l17 = run_batched(real_b, real_feats, cfg, "17 batched real size",
                          n_cpu=len(real_b))
    batched_launches = {k: l16[k] + l17[k] for k in l16}

    # path 4: level by level, the level entries under the torch level loop
    per_step = {}
    with phase("21 level path"):
        level_launches = run_level_path(vga[:20], 2000, flag_b, flag_feats,
                                        cfg, "21 level path", per_step)

    # main path 5: tracking with the affine consistency check (laptops);
    # run_affine counts and checks its launches
    with phase("23 affine"):
        affine_launches = run_affine(aff, 2000, acfg, "23 affine",
                                     n_cpu=AFFINE_CPU_FRAMES)

    # main path 8: the batched affine check (laptops_affine_batched_b8);
    # run_batched_affine counts and checks its launches
    with phase("27 batched affine"):
        b_affine_launches = run_batched_affine(
            aff_b, aff_b_feats, acfg, "27 batched affine", BATCHED_AFFINE_CPU)

    # main path 9: the bit-exact replace run (klt_tpu's traffic row on
    # its exact tier, and the example3 size with a tie-forcing frame);
    # run_exact_card checks each run's launches and that no plain version
    # runs
    with phase("30 exact kernels"):
        phase_exact_kernels(errs)
    cuda.reset_launch_counts()
    with phase("31 exact traffic"):
        exact_run = run_exact_traffic(traffic, 500, cfg, "31 exact traffic",
                                      n_cpu=EXACT_CPU_FRAMES)
    with phase("31 exact flagship"):
        run_exact_flagship(tie_frames(qvga, 5), 150, cfg,
                           "31 exact flagship")
    exact_launches = launch_counts()
    for k in (cuda.PYRAMID, cuda.EXACT_TRACK, cuda.EXACT_RESPONSE,
              cuda.REPLACE_LOST_TIE):
        check(exact_launches[k.symbol] > 0,
              f"{k.symbol} was not launched on the exact path")
    with phase("30 kernel G, exact run states"):
        phase_exact_track_states(traffic, exact_run, cfg, errs)

    # path 10: the exact run with a window no tile of kernel H2 holds (its
    # global-memory entry); run_exact_wide checks its launches
    cuda.reset_launch_counts()
    with phase("34 exact wide window"):
        wide_launches = run_exact_wide(qvga[:EXACT_WIDE_FRAMES], 150,
                                       "34 exact wide window", card, times)

    # path 6: selection from the card's response, both entries of kernel D
    with phase("26 device selection"):
        select_launches = run_device_selection(vga[0], 500,
                                               "26 device selection", card,
                                               times)

    # path 11: selection and replacement through the prefilter (the cut
    # made on the card from kernel D's response); run_prefilter counts
    # its launches
    with phase("35 prefilter"):
        prefilter_launches = run_prefilter(traffic[:PREFILTER_FRAMES],
                                           "35 prefilter")

    # main path 12: the SLAM pipeline (klt_tpu's bench_slam_e2e) at the
    # laptops width, front end on the kernels, back end in plain torch;
    # run_slam counts and checks the front end's launches
    with phase("36 inputs"):
        laptops = np.concatenate([traffic, synthetic_frames(
            SLAM_FRAMES, scale=2, start=len(traffic))])
    with phase("36 slam pipeline"):
        slam_launches, back_end = run_slam(laptops, 1000, "36 slam pipeline",
                                           n_cpu=SLAM_CPU_FRAMES)
        per_step["36 slam front end"] = {
            k: round(n / (len(laptops) - 1), 3)
            for k, n in slam_launches.items()}
    del laptops
    with phase("37 slam solvers at scale"):
        run_slam_scale("37 slam solvers at scale")

    # path 13: the tooling (checks, debug dumps, the profiler wrapper, the
    # track_sequence example, the graft entry); path 14: multi-device in
    # a world of one on NCCL; each counts its launches from 0
    with phase("38 tooling"):
        tooling_launches = phase_tooling(vga, aff, cfg, "38 tooling")
    with phase("39 multi-device"):
        mesh_launches = phase_multi_device(flag_b, flag_feats, cfg,
                                           "39 multi-device")
    for tag, counts in (("38", tooling_launches), ("39", mesh_launches)):
        print(f"[{tag} launches] "
              f"{ {k: n for k, n in counts.items() if n} }")

    # path 15: every graphed sequence entry against its chunks run eagerly
    # on the six cells of PERF.md section 5
    with phase("40 graphs"):
        graph_steps = phase_graphs(
            {"vga": vga, "traffic": traffic, "aff": aff, "flag_b": flag_b,
             "flag_feats": flag_feats, "aff_b": aff_b,
             "aff_b_feats": aff_b_feats, "exact": traffic[:EXACT_CPU_FRAMES],
             "tie": tie_frames(qvga, 5)}, cfg, acfg, "40 graphs")
        per_step.update({f"40 {k}": v for k, v in graph_steps.items()})

    # path 16: KLTracker's step programs and track_pair_carry's graph
    # against their steps run eagerly
    with phase("41 tracker graphs"):
        tracker_launches = phase_tracker_graphs(vga, traffic, aff, cfg, acfg,
                                                "41 tracker graphs")
        print(f"[41 launches] "
              f"{ {k: n for k, n in tracker_launches.items() if n} }")

    # path 17: the SLAM solvers' programs against their eager bodies (no
    # kernel of the port runs in a solve)
    cuda.reset_launch_counts()
    with phase("42 solver graphs"):
        phase_solver_graphs(back_end, "42 solver graphs")
    solver_launches = launch_counts()
    print(f"[42 launches] {solver_launches} (the solvers launch no kernel "
          f"of the port)")
    check(not any(solver_launches.values()),
          "a kernel of the port was launched in the solvers")

    with phase("12 no sync"):
        phase_no_sync(traffic[:PRECOMP_FRAMES + 2], 500, cfg)

    with phase("6 times"):
        phase_times(card, (qvga, vga), cfg, (150, 2000), times, per_step)
    with phase("13 times"):
        phase_replace_times(card, traffic, 500, cfg, times, per_step)
    with phase("14 profile"):
        phase_profile_tracking(vga, 2000, cfg)
        phase_profile(traffic[:PRECOMP_FRAMES + 1], 500, cfg)
    with phase("18 times"):
        phase_batched_times(card, ((flag_b, flag_feats, 10),
                                   (real_b, real_feats, 5)), cfg, times,
                            per_step)
    with phase("19 profile"):
        phase_batched_profile(flag_b, flag_feats, cfg)
    with phase("24 times"):
        phase_affine_times(card, aff, 2000, acfg,
                           aff_states[AFFINE_STEPS[2]], small_state, times,
                           per_step)
    with phase("25 profile"):
        phase_affine_profile(aff[:PRECOMP_FRAMES + 1], 2000, acfg)
    with phase("28 times"):
        phase_batched_affine_times(card, aff_b, aff_b_feats, acfg, b_state,
                                   times, per_step)
    with phase("29 profile"):
        phase_batched_affine_profile(aff_b[:, :33], aff_b_feats, acfg)
    with phase("32 times"):
        phase_exact_times(card, traffic, cfg, exact_run, times, per_step)
    with phase("33 profile"):
        phase_exact_profile(traffic[:PRECOMP_FRAMES + 1], 500, cfg)

    # A and B's entries at 640x480 with 2000 features requested, D, E and
    # R at the traffic run's 640x480 with 500 (D's global-memory entry with
    # a 111x111 window), C's entries at 32 x 320x240 x 150, F at step 10 of
    # the affine run's 640x480 with 2000 requested; G, H2 and R's tie
    # entry at step 100 of the exact traffic run (640x480, 500), H2's
    # global-memory entry on the wide-window run's 320x240 with 121x121;
    # S's entries on kernel D's map of a traffic frame (640x480).
    # No single PyTorch call computes any of these functions (a chain of
    # separable passes with decimation, a Newton loop that ends by the
    # data, a fused product, box sum and eigenvalue, a greedy loop, a
    # Gauss-Newton loop with an elimination per step, the reference's
    # quicksort partitions with its tie order), and none keeps the C
    # summation order of the exact tier, so library_ms is null
    # throughout.
    report = {"kernels": []}
    names = {cuda.PYRAMID: "pyramid", cuda.LK_LEVEL: "lk_level",
             cuda.LK_PYRAMID: "lk_pyramid",
             cuda.CORNER_RESPONSE: "corner_response",
             cuda.PYRAMID_BATCHED: "pyramid_batched",
             cuda.REPLACE_LOST: "replace_lost",
             cuda.LK_LEVEL_BATCHED: "lk_level_batched",
             cuda.LK_PYRAMID_BATCHED: "lk_pyramid_batched",
             cuda.CORNER_RESPONSE_GLOBAL: "corner_response_global",
             cuda.AFFINE_TRACK: "affine_track",
             cuda.AFFINE_STEP: "affine_step",
             cuda.EXACT_TRACK: "exact_track",
             cuda.EXACT_RESPONSE: "exact_response",
             cuda.EXACT_RESPONSE_GLOBAL: "exact_response_global",
             cuda.REPLACE_LOST_TIE: "replace_lost_tie",
             cuda.SELECT_LIST: "select_list",
             cuda.SELECT_PARTITIONS: "select_partitions"}
    for k in cuda.KERNELS:
        name = names[k]
        report["kernels"].append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces,
            "launches": track_launches[k.symbol] + replace_launches[k.symbol]
            + batched_launches[k.symbol] + level_launches[k.symbol]
            + affine_launches[k.symbol] + select_launches[k.symbol]
            + step_launches[k.symbol] + b_step_launches[k.symbol]
            + b_affine_launches[k.symbol] + exact_launches[k.symbol]
            + wide_launches[k.symbol] + prefilter_launches[k.symbol]
            + slam_launches[k.symbol] + tooling_launches[k.symbol]
            + mesh_launches[k.symbol] + tracker_launches[k.symbol],
            "max_abs_err": max(errs[k.symbol]), **times[name],
            "library_ms": None,
            "launches_per_step": {path: counts[k.symbol]
                                  for path, counts in per_step.items()}})
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
