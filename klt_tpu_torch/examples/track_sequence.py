"""Example: select-and-track over a PGM sequence.

The klt_tpu_torch counterpart of klt_tpu's examples/track_sequence.py and
of the reference's example3 (src/V1/example3.c / src/V3/example3GPU.c):
selects features on the first frame, tracks through the sequence in
sequential mode, writes feature-table files and PPM overlays.  The
dataset is looked up by name under KLT_DATA_ROOT or the checkout's
`data/` (io/dataset.py); without it the example exits.

Usage:
    python -m klt_tpu_torch.examples.track_sequence [dataset] [nFeatures]
        [nFrames] [--replace] [--affine MODE] [--out DIR] [--overlays]
        [--device cpu]

It runs on the card (kernels A and B; D with --replace, F with
--affine 2); --device cpu takes the plain torch versions on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import klt_tpu_torch as klt
from klt_tpu_torch.io.dataset import ImageSequence, find_dataset


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", nargs="?", default="images_provided")
    ap.add_argument("n_features", nargs="?", type=int, default=150)
    ap.add_argument("n_frames", nargs="?", type=int, default=10)
    ap.add_argument("--replace", action="store_true",
                    help="replace lost features every frame")
    ap.add_argument("--affine", type=int, default=-1,
                    help="affine consistency mode (-1/0/1/2)")
    ap.add_argument("--out", default="feat")
    ap.add_argument("--overlays", action="store_true",
                    help="write per-frame PPM overlays")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu for the "
                         "plain torch versions)")
    args = ap.parse_args(argv)

    path = find_dataset(args.dataset)
    if path is None:
        sys.exit(f"dataset '{args.dataset}' not found")
    seq = ImageSequence(path)
    n_frames = min(args.n_frames, len(seq))
    os.makedirs(args.out, exist_ok=True)

    cfg = klt.TrackingConfig(sequential_mode=True,
                             affine_consistency_check=args.affine)
    tracker = klt.KLTracker(cfg, device=args.device)
    fl = klt.FeatureList.create(args.n_features)
    ft = klt.FeatureTable.create(n_frames, args.n_features)

    img1 = seq[0]
    tracker.select_good_features(img1, fl)
    ft.store_list(fl, 0)
    if args.overlays:
        klt.write_feature_list_ppm(fl, img1, f"{args.out}/feat1.ppm")

    total = 0.0
    for i in range(1, n_frames):
        img2 = seq[i]
        t0 = time.perf_counter()
        tracker.track_features(img1, img2, fl)
        total += time.perf_counter() - t0
        if args.replace:
            tracker.replace_lost_features(img2, fl)
        # the reference's quirk: frame i's track lands in column i - 1
        ft.store_list(fl, i - 1)
        if args.overlays:
            klt.write_feature_list_ppm(fl, img2, f"{args.out}/feat{i}.ppm")
        img1 = img2

    klt.write_feature_table(ft, f"{args.out}/features.txt", "%5.1f")
    klt.write_feature_table(ft, f"{args.out}/features.ft")
    print(f"tracked {n_frames - 1} frame pairs in {total:.3f}s "
          f"({(n_frames - 1) / max(total, 1e-9):.1f} fps incl. host loop); "
          f"{fl.count_remaining()} features remaining")
    return 0


if __name__ == "__main__":
    sys.exit(main())
