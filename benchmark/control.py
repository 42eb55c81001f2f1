"""The control of the comparison that decides `correct`: the plain
reference with its pyramid computed in bfloat16 (the precision below the
configuration's float32), put in the program's place on the steps that a
run checks, and where the loop compares later stages (the map's back
end), the reference's solve in bfloat16 in the program's place there.
The comparison must refuse it.

    python3 -m benchmark.control --workload traffic_vga_500.farm \
        --seeds 11,12,13 --seconds 2

runs the cell at its own size for each seed (a short window at the
cell's own load), judges the program's steps and the control's on the
same starting states, and prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import harness
from benchmark.reference import check


def readings(workload: str, seed: int, seconds: float,
             device: str = "cuda", overrides: dict | None = None,
             bench: dict | None = None) -> dict:
    out = harness.execute(workload, seed, seconds, False, device, overrides,
                          bench=bench)
    run, steps, loop = out["_run"], out["_steps"], out["_loop"]
    control = check.judge([check.control_step(st, run.ref_cfg)
                           for st in steps], run.ref_cfg)
    readings = dict(run.counters.get("map_readings", {}))
    if hasattr(loop, "compare"):
        control.update(loop.compare(control=True))
    out = {"seed": seed, "steps": len(steps),
           "program": {k: v["value"] for k, v in out["checked"].items()},
           "control": control}
    if readings:
        # a loop's readings that are not compared, for the record
        out["readings"] = {"program": readings,
                           "control": run.counters["map_readings"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--pending", action="store_true",
                    help="also the cells of pending/, which wait on the "
                         "program")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  bench=harness.benchmark(args.pending))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
