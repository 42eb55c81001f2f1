"""Run one cell of the benchmark of klt_tpu_torch once, on this machine's
card, and print one JSON line of results as the last line of standard
output.

    python3 -m benchmark.run --workload traffic_vga_500.farm --seed 7 \
        --seconds 10 --trace 0

--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
metrics, from spans around the program's calls and a profiled segment of
the cell's own work after the window.  Every run checks what the timed
path produced against the plain reference (benchmark/reference) and
prints each compared number beside its limit, last on standard error and
last in the result line.  Exits non-zero without a result when there is
no CUDA card (or fewer than the cell asks for), or when JAX or the
package the port was made from was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power.limit not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness
    t_torch = time.perf_counter() - _T0
    # one process a card, with one host thread for torch's CPU operators,
    # as a deployment of one tracker process per camera or card runs
    torch.set_num_threads(1)
    _, cell, _, _ = harness.cell_spec(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.execute(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", t_start=_T0)
    run = out.pop("_run")
    out.pop("_loop")
    steps = len(out.pop("_steps"))
    print(f"phases (s): torch import {t_torch:.3f} (within imports), " +
          ", ".join(f"{k} {v:.3f}" for k, v in
                    run.counters["phases"].items()), file=sys.stderr)
    counts = {k: v for k, v in run.counters.items()
              if isinstance(v, (int, float))}
    print(f"counters: {json.dumps(counts)}", file=sys.stderr)
    if args.trace:
        print(f"card: {power_limit()}", file=sys.stderr)
        for line in run.counters.get("roofline_lines", []):
            print(line, file=sys.stderr)
        if run.trace is None:
            print("the profiler recorded no device event between its "
                  "markers: the trace's metrics are not measured",
                  file=sys.stderr)
            return 4
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules that must not be: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(f"checked {steps} steps of the timed path against the reference",
          file=sys.stderr)
    for k, v in out["checked"].items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
