"""The harness on the CPU at a tiny size, through the same dispatch as a
run on the card: each cell's result line, the faults and the control that
the comparison must refuse, the roofline counts against hand counts, the
whole-name check of forbidden modules, and a cell, a traffic mix and a
metric added as files alone."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness, run as run_mod
from benchmark.reference import check, klt
from benchmark.rooflines import klt_build_pyramid, klt_lk_pyramid

CELLS = ["traffic_vga_500.farm", "laptops_vga_slam.map",
         "traffic_vga_500.live"]
TINY = {"config": {"width": 160, "height": 120, "n_features": 24},
        "traffic": {"streams": 2, "pool": 4, "sample": 3, "warm_frames": 4,
                    "traced_requests": 2,
                    "blocks": {"width": 24, "height": 12,
                               "speeds": [1.0, 2.0, 3.0, 4.0],
                               "lanes": [0.1, 0.35, 0.6, 0.85],
                               "directions": [1, 1, -1, -1],
                               "phases": [0.0, 0.25, 0.5, 0.75]}}}
# the map's clip: 40 frames of the two-depth sweep at a quarter of its
# pixels a frame
TINY_MAP = {"config": {"width": 160, "height": 120, "n_features": 40},
            "traffic": {"frames": 40, "near_px": 2.0, "far_px": 0.75,
                        "sweep_px": 60.0, "post_px": 12, "gap_px": 24,
                        "sample": 4}}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny(cell):
    return TINY_MAP if cell.endswith(".map") else TINY


# with the cells that wait on the program (pending/), run here all the same
BENCH = harness.benchmark(pending=True)


def _run(cell, seed=2 ** 31 + 9, **kw):
    return harness.execute(cell, seed, 0.3, False, "cpu", tiny(cell),
                           bench=BENCH, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_tiny(cell):
    out = _run(cell)
    assert out["correct"], out["checked"]
    line = {k: v for k, v in out.items() if not k.startswith("_")}
    assert list(line)[:5] == KEYS and list(line)[-1] == "checked"
    want = {m["name"] for m in BENCH["end_to_end"]
            if harness.applies(m, cell)}
    assert set(out["metrics"]) == want
    assert out["metrics"]["setup_s"]["value"] > 0
    assert out["attempted"] > 0 and len(out["_steps"]) >= 3
    json.dumps(line)


def _farm_faults():
    import klt_tpu_torch.runtime.pipeline as pl
    orig = pl.track_sequence_replace

    def unchanged(frames, x, y, val, cfg, **kw):
        t = frames.shape[0] - 1
        return tuple(a.expand(t, -1).clone() for a in (x, y, val))

    def half(frames, x, y, val, cfg, **kw):
        n, t = x.shape[0] // 2, frames.shape[0] - 1
        out = orig(frames, x[:n], y[:n], val[:n], cfg)
        return tuple(torch.cat([o, a[n:].expand(t, -1)], 1)
                     for o, a in zip(out, (x, y, val)))

    def altered(frames, x, y, val, cfg, **kw):
        xs, ys, vs = orig(frames, x, y, val, cfg)
        xs[:, 0] += 0.25          # one feature, every step
        return xs, ys, vs

    return pl, "track_sequence_replace", {"unchanged": unchanged,
                                          "half": half, "altered": altered}


def _live_faults():
    import klt_tpu_torch.runtime.tracker as tr
    orig = tr.KLTracker.track_features

    def unchanged(self, img1, img2, fl):
        self._pyr_last = None

    def half(self, img1, img2, fl):
        n = fl.n_features // 2
        keep = [a[n:].copy() for a in (fl.x, fl.y, fl.val)]
        orig(self, img1, img2, fl)
        fl.x[n:], fl.y[n:], fl.val[n:] = keep

    def altered(self, img1, img2, fl):
        orig(self, img1, img2, fl)
        alive = (fl.val >= 0).nonzero()[0]
        if len(alive):
            fl.x[alive[0]] += 0.25

    return tr.KLTracker, "track_features", {"unchanged": unchanged,
                                             "half": half,
                                             "altered": altered}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in
                                        ("unchanged", "half", "altered")])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    """The timed path broken underneath: a step that returns its state
    unchanged, half of the features left out, an answer altered where it
    is produced."""
    owner, attr, faults = (_live_faults if cell.endswith("live")
                           else _farm_faults)()
    monkeypatch.setattr(owner, attr, faults[fault])
    assert not _run(cell)["correct"]


def test_map_back_end_unchanged_is_not_correct(monkeypatch):
    """The gated BA returning the poses and landmarks it started from."""
    import klt_tpu_torch.slam as slam
    orig = slam.bundle_adjust_gated

    def unchanged(prob, **kw):
        R, t, lm, costs, active = orig(prob, **kw)
        return prob.R.clone(), prob.t.clone(), prob.landmarks.clone(), \
            costs, active

    monkeypatch.setattr(slam, "bundle_adjust_gated", unchanged)
    out = _run("laptops_vga_slam.map")
    assert not out["correct"]
    assert out["checked"]["ba_loss_gap"]["value"] > \
        check.LIMITS["ba_loss_gap"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    from benchmark import control
    r = control.readings(cell, 11, 0.3, "cpu", tiny(cell), BENCH)
    assert check.passed(r["program"])
    assert not check.passed(r["control"])


def test_pending_cells_are_complete_and_unmeasured():
    """A pending cell brings its configuration and metrics, and
    BENCHMARK.json, which the driver measures, holds none of it."""
    bench = harness.benchmark()
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = {e["name"] for e in bench[key]}
        assert not names & {e["name"] for e in BENCH[key]
                            if e not in bench[key]}
    for w in BENCH["workloads"]:
        assert w["config"] in {c["name"] for c in BENCH["configs"]}
        assert any(harness.applies(m, w["name"]) for m in BENCH["per_layer"])


def test_roofline_counts_by_hand():
    cfg = klt.Config()
    # taps: smoothing 5, gradients 7, pyramid 21; levels 640x480, 160x120
    n_bytes, n_flops = klt_build_pyramid.work(640, 480, cfg)
    assert n_bytes == 640 * 480 * 13 + 3 * 160 * 120 * 4
    assert n_flops == 640 * 480 * (4 * 5 + 8 * 7 + 4 * 21) + \
        160 * 120 * 8 * 7
    by, fl = klt_lk_pyramid.level_work(100, 300, cfg, True)
    assert by == 100 * 2 * 3 * 8 * 8 * 4
    assert fl == 49 * (100 * 21 + 300 * 34 + 100 * 10)
    stats = [(1, torch.ones(10, dtype=torch.bool), torch.full((10,), 3)),
             (0, torch.ones(10, dtype=torch.bool), torch.full((10,), 2))]
    shapes = klt.pyramid_shapes(640, 480, cfg)
    by, fl = klt_lk_pyramid.work(stats, 500, shapes, cfg)
    b1, f1 = klt_lk_pyramid.level_work(10, 30, cfg, False)
    b0, f0 = klt_lk_pyramid.level_work(10, 20, cfg, True)
    assert (by, fl) == (24 * 500 + b1 + b0, f1 + f0)


def test_forbidden_modules_by_whole_name(monkeypatch):
    before = set(harness.forbidden_modules())
    for name in ("klt_tpu_torch", "klt_tpu_torch.cuda", "jaxy", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "klt_tpu.config", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert set(harness.forbidden_modules()) == before | {"klt_tpu",
                                                          "jaxlib"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_reference_no_program():
    for dirpath, _, files in os.walk(harness.HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = set(_imports(path))
            assert not tops & set(harness.FORBIDDEN), path
            if os.sep + "reference" + os.sep in path:
                assert "klt_tpu_torch" not in tops, path


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run_mod.main(["--workload", CELLS[0], "--seed", "1",
                         "--seconds", "1"]) != 0
    assert capsys.readouterr().out.strip() == ""


def test_added_by_files_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and entries, no file of the harness edited."""
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cfg = harness.load_json(harness.HERE, "configs", "traffic_vga_500.json")
    cfg.update(name="dummy_qvga", width=160, height=120, n_features=16)
    (tmp_path / "benchmark/configs/dummy_qvga.json").write_text(
        json.dumps(cfg))
    mix = harness.load_json(harness.HERE, "traffic", "farm.json")
    mix.update(TINY["traffic"], streams=3)
    (tmp_path / "benchmark/traffic/dummy_mix.json").write_text(
        json.dumps(mix))
    (tmp_path / "benchmark/metrics/dummy.clips.py").write_text(
        "def read(run):\n    return float(run.attempted)\n")
    bench["configs"].append(dict(bench["configs"][0], name="dummy_qvga",
                                 file="benchmark/configs/dummy_qvga.json"))
    bench["workloads"].append({"name": "dummy_qvga.dummy_mix",
                               "config": "dummy_qvga",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "dummy.clips", "unit": "clips",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["dummy_qvga.dummy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json; from benchmark import harness; "
            "out = harness.execute('dummy_qvga.dummy_mix', 3, 0.3, False, "
            "'cpu'); print(json.dumps([out['correct'], out['metrics']]))")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}"
               f"{harness.ROOT}")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    correct, metrics = json.loads(res.stdout.strip().splitlines()[-1])
    assert correct and metrics["dummy.clips"]["value"] > 0
    assert "setup_s" in metrics
