"""One run of one cell: set-up, the measured window, the traced segment,
the check against the reference and the metrics, all found by name.

`BENCHMARK.json` names the cell's configuration and traffic mix.  The
configuration's sizes are `configs/<config>.json`; the mix's parameters
are `traffic/<traffic>.json`, which names the loop (`loops/<name>.py`)
that runs the system under test; each metric is read by
`metrics/<metric>.py`.  Nothing here branches on a cell.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

from benchmark import frames as frame_gen
from benchmark.reference import check, klt

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that must not be loaded: JAX and the package the
# port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "klt_tpu")
# a loop's checked steps begin with this many of the start (the
# features all lost), which stay out of the roofline's counts
START_STEPS = 2


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(pending: bool = False) -> dict:
    """BENCHMARK.json; with `pending`, joined by the entries of each file
    of pending/: cells whose harness is here but which wait on a fault
    of the program (PERF.md, Open questions) and so are not measured."""
    bench = load_json(ROOT, "BENCHMARK.json")
    if pending:
        folder = os.path.join(HERE, "pending")
        for f in sorted(os.listdir(folder)):
            for key, entries in load_json(folder, f).items():
                bench[key] = bench[key] + entries
    return bench


def cell_spec(name: str, bench: dict | None = None) -> tuple[dict, dict,
                                                            dict, dict]:
    """(BENCHMARK.json, its workload entry, the configuration, the traffic
    mix) of cell `name`."""
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = load_json(HERE, "configs", f"{cell['config']}.json")
    traffic = load_json(HERE, "traffic", f"{cell['traffic']}.json")
    return bench, cell, config, traffic


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    as whole names (klt_tpu_torch is not klt_tpu)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def metric_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Run:
    """What a run knows; loops fill it, metric readers read it."""
    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    program_cfg: object = None
    ref_cfg: klt.Config = None
    frames: torch.Tensor = None
    spans: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    frames_done: int = 0
    trace: object = None
    lk_stats: list = dataclasses.field(default_factory=list)
    sample_size: int = 0
    _rng: object = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reservoir(self, i: int) -> int | None:
        """The sample slot of request i (reservoir sampling from the
        seed), or None when it is not kept."""
        if i < self.sample_size:
            return i
        j = int(self._rng.integers(0, i + 1))
        return j if j < self.sample_size else None

    @staticmethod
    def keep(kept: list, slot: int | None, item) -> None:
        """Put item into the sample's slot (reservoir)."""
        if slot is None:
            return
        if slot < len(kept):
            kept[slot] = item
        else:
            kept.append(item)


def configs(config: dict):
    """(the program's TrackingConfig, the reference's Config), checked to
    derive the same pyramid and border."""
    from klt_tpu_torch import TrackingConfig
    tracking = dict(config["tracking"])
    prog = TrackingConfig(**tracking)
    tracking.pop("sequential_mode", None)
    ref = klt.Config(**tracking)
    for k in ("n_pyramid_levels", "subsampling", "borderx", "bordery",
              "window_width", "window_height"):
        if getattr(prog, k) != getattr(ref, k):
            raise ValueError(f"the program derives {k} = "
                             f"{getattr(prog, k)}, the reference "
                             f"{getattr(ref, k)}")
    return prog, ref


def execute(name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", overrides: dict | None = None,
            t_start: float | None = None, bench: dict | None = None) -> dict:
    """Run cell `name` once on `device`; returns the result line's object,
    with the run itself under "_run", its loop under "_loop" and its
    checked steps under "_steps".
    overrides: {"config": {...}, "traffic": {...}} merged into the files
    (the tests' small sizes); bench: BENCHMARK.json's entries, when not
    the file's own (benchmark(pending=True))."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench, cell, config, traffic = cell_spec(name, bench)
    for key, part in (overrides or {}).items():
        {"config": config, "traffic": traffic}[key].update(part)
    dev = torch.device(device)
    run = Run(cell=cell, config=config, traffic=traffic, seed=seed,
              device=dev, sample_size=int(traffic["sample"]),
              _rng=np.random.default_rng([seed, 0]))
    phases = run.counters["phases"] = {}
    last = [t_start]

    def phase(name):
        now = time.perf_counter()
        phases[name] = now - last[0]
        last[0] = now

    run.program_cfg, run.ref_cfg = configs(config)
    if dev.type == "cuda":
        torch.cuda.init()
    phase("imports")
    # a mix may take its frames from another mix's parameters
    shots = traffic
    if "frames_of" in traffic:
        shots = load_json(HERE, "traffic", f"{traffic['frames_of']}.json")
        shots.update((overrides or {}).get("traffic", {}))
    run.frames = frame_gen.streams(config["width"], config["height"],
                                   shots, seed, dev)
    run.sync()
    phase("frames")
    loop = importlib.import_module(
        f"benchmark.loops.{traffic['loop']}").Loop(run)
    loop.setup()
    run.sync()
    phase("warm_up")
    run.setup_s = time.perf_counter() - t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    loop.window(seconds)
    phase("window")
    if trace:
        from benchmark import trace as tracing
        n = int(traffic["traced_requests"])
        run.trace = tracing.profile(loop.traced(max(1, n // 8)),
                                    loop.traced(n))
        run.counters["traced_requests"] = n
        phase("trace")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    steps = loop.steps()
    numbers = check.judge(steps[:START_STEPS], run.ref_cfg)
    for k, v in check.judge(steps[START_STEPS:], run.ref_cfg,
                            run.lk_stats).items():
        numbers[k] += v
    if hasattr(loop, "compare"):
        numbers.update(loop.compare())
    failed = int(run.counters.get("failed", 0))
    correct = check.passed(numbers) and failed == 0
    phase("check")

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[kind]:
        if not applies(m, name):
            continue
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": run.attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checked"] = check.summary(numbers)
    out["_steps"] = steps
    out["_run"] = run
    out["_loop"] = loop
    return out
