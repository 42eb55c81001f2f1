"""The program's spans and counters (klt_tpu_torch/utils/profiling.py) at
its layer boundaries: KLTracker's calls (runtime/tracker.py), the
sequence entries' frame loop (runtime/pipeline.py::_run) and the
programs' warm-ups, captures and replays (cuda/graph.py).

On the CPU: with no profiler active nothing is recorded; under
`torch.profiler.profile` every call records its named spans, with their
parents and one request id a call, and the profiler's host events carry
the "klt:" names; the counters count the candidate list, the rows of it
the lazy sort made final, the list buffers made and reused (once a
geometry, bit-equal to the numpy list) and the chunk replays; the
benchmark's readers
of these spans give their numbers from a store made by hand and None
without a span.  On the card (-m cuda): a graph replay records
`graph.replay` and nothing of its chunk function, and the benchmark's
traced segment counts no span as device work.  This file imports no
jax, so on the card it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spans.py
"""

import collections
import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import klt_tpu_torch as kt
from benchmark import harness
from chip_smoke import synthetic_frames, tie_frames
from klt_tpu_torch.cuda import graph
from klt_tpu_torch.runtime import pipeline
from klt_tpu_torch.utils import profiling

H, W = 64, 80
N_FEAT = 30
T = 6
CFG = kt.TrackingConfig(sequential_mode=True)
PROGRAM = ("graph.warm_up", "graph.capture", "graph.replay")

kt.set_verbosity(0)


@pytest.fixture(autouse=True)
def _clean():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    profiling.reset_spans()
    yield
    profiling.reset_spans()
    torch.set_num_threads(saved)


@functools.lru_cache(maxsize=None)
def scene() -> np.ndarray:
    """T frames of 64x80 of the synthetic scene with a flat patch from
    frame 3 (tie_frames): features are lost and replaced."""
    return np.ascontiguousarray(
        tie_frames(synthetic_frames(T), 3)[:, 40:40 + H, 60:60 + W])


def tracker_calls(tr, fl, frames, k):
    """Track into frame k + 1, lose three features, replace them."""
    tr.track_features(frames[k], frames[k + 1], fl)
    fl.val[:3] = -1
    tr.replace_lost_features(frames[k + 1], fl)


def selected(frames):
    tr = kt.KLTracker(CFG, device="cpu")
    fl = kt.FeatureList.create(N_FEAT)
    tr.select_good_features(frames[0], fl)
    return tr, fl


def sequence_call(steps):
    frames = torch.from_numpy(np.concatenate(
        [scene()] * (steps // (T - 1) + 1))[:steps + 1])
    x = torch.full((N_FEAT,), -1.0)
    val = torch.full((N_FEAT,), -1, dtype=torch.int32)
    pipeline.track_sequence_replace(frames, x, x.clone(), val, CFG)


def by_request(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s.request].append(s)
    return out


def children(spans, parent):
    return [s.name for s in spans if s.parent == parent.index]


def assert_program_spans_are_leaves(spans):
    """Nothing a chunk function runs records a span: on the CPU it runs
    inside graph.replay, so a span there would be that span's child."""
    for s in spans:
        if s.name in PROGRAM:
            assert children(spans, s) == [], s


@pytest.mark.parametrize("flow", ["select", "track_replace", "sequence"])
def test_no_profiler_no_span(flow):
    frames = scene()
    before = profiling.counters()
    if flow == "sequence":
        sequence_call(T - 1)
    else:
        tr, fl = selected(frames)
        if flow == "track_replace":
            tracker_calls(tr, fl, frames, 0)
    assert profiling.spans() == []
    assert profiling.span("a") is profiling.span("b")
    if flow != "sequence":
        # the counters are always on
        assert profiling.counters()["select.calls"] > \
            before.get("select.calls", 0)


def test_tracker_spans_under_the_profiler():
    frames = scene()
    tr, fl = selected(frames)
    tracker_calls(tr, fl, frames, 0)          # the step program warm
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracker_calls(tr, fl, frames, 1)
        tr.select_good_features(frames[2], fl)
    spans = profiling.spans()
    assert all(s.end >= s.start > 0 for s in spans)
    calls = by_request(spans)
    assert len(calls) == 3
    roots = []
    for request, group in sorted(calls.items()):
        root = group[0]
        assert root.parent is None and \
            all(s.parent is not None for s in group[1:])
        assert {s.request for s in group} == {request}
        roots.append(root.name)
        kids = children(group, root)
        if root.name == "tracker.track":
            assert kids == ["track.stage", "graph.replay", "track.readback",
                            "track.unpack"]
        elif root.name == "tracker.replace":
            # sequential replacement reads kernel D's response back
            assert kids == ["select.response", "select.readback",
                            "select.candidates", "select.sort",
                            "select.suppress"]
        else:
            # selection's exact host chain hands over a numpy map
            assert kids == ["select.response", "select.candidates",
                            "select.sort", "select.suppress"]
        for s in group[1:]:
            assert root.start <= s.start <= s.end <= root.end
    assert roots == ["tracker.track", "tracker.replace", "tracker.select"]
    assert_program_spans_are_leaves(spans)
    names = {e.name for e in prof.events()}
    for s in spans:
        assert profiling.SPAN_PREFIX + s.name in names


def test_replace_without_lost_slots_records_no_root():
    frames = scene()
    tr, fl = selected(frames)
    fl.val[:] = np.maximum(fl.val, 0)
    with profile(activities=[ProfilerActivity.CPU]):
        tr.replace_lost_features(frames[0], fl)
    assert profiling.spans() == []


def test_prefilter_records_its_span():
    frames = scene()
    tr = kt.KLTracker(CFG, device="cpu", prefilter=True)
    fl = kt.FeatureList.create(N_FEAT)
    with profile(activities=[ProfilerActivity.CPU]):
        tr.select_good_features(frames[0], fl)
    spans = profiling.spans()
    root = spans[0]
    assert root.name == "tracker.select"
    assert children(spans, root)[:2] == ["select.response",
                                         "select.prefilter"]


@pytest.mark.parametrize("overwrite_all", [True, False])
def test_candidates_counted_as_the_list_sorted(overwrite_all):
    frames = scene()
    tr, fl = selected(frames)
    tr.track_features(frames[0], frames[1], fl)
    fl.val[:3] = -1
    before = profiling.counters()
    if overwrite_all:
        tr.select_good_features(frames[1], fl)
    else:
        tr.replace_lost_features(frames[1], fl)
    after = profiling.counters()
    assert after["select.calls"] - before["select.calls"] == 1
    assert after["select.candidates"] - before["select.candidates"] == \
        (W - 2 * CFG.borderx) * (H - 2 * CFG.bordery)


@pytest.mark.parametrize("overwrite_all", [True, False])
def test_sorted_counted_as_the_rows_made_final(overwrite_all, monkeypatch):
    """`select.sorted` is counted once a full-list call: the rows of the
    candidate list that the lazy sort made final, at least those the walk
    read and at most the list."""
    from klt_tpu_torch import native
    from klt_tpu_torch.runtime import tracker as tracker_mod
    frames = scene()
    tr = kt.KLTracker(CFG, device="cpu")
    fl = kt.FeatureList.create(4)      # few slots: the walk stops early
    tr.select_good_features(frames[0], fl)
    tr.track_features(frames[0], frames[1], fl)
    fl.val[:2] = -1
    made, counted = [], []

    class Spy(native.LazySort):
        def __init__(self, pts, walk_map):
            made.append((self, pts.copy()))
            super().__init__(pts, walk_map)

    real_count = tracker_mod.count

    def spy_count(name, n=1):
        counted.append((name, n))
        real_count(name, n)

    monkeypatch.setattr(native, "LazySort", Spy)
    monkeypatch.setattr(tracker_mod, "count", spy_count)
    target = np.ones(4, bool) if overwrite_all else fl.val < 0
    before = profiling.counters()
    if overwrite_all:
        tr.select_good_features(frames[1], fl)
    else:
        tr.replace_lost_features(frames[1], fl)
    after = profiling.counters()
    sorted_ = after["select.sorted"] - before.get("select.sorted", 0)
    assert [n for n, _ in counted].count("select.sorted") == 1
    [(lazy, pts)] = made
    assert sorted_ == lazy.n_final == dict(counted)["select.sorted"]
    # the rows the walk read: through its last pick in the full sort's
    # order, or all of them when it left a slot unfilled
    full = native.sort_points_desc(pts)
    if (fl.val[target] < 0).any():
        read = len(full)
    else:
        at = {(x, y): p for p, (x, y, _) in enumerate(full.tolist())}
        read = 1 + max(at[(int(x), int(y))]
                       for x, y in zip(fl.x[target], fl.y[target]))
    assert read <= sorted_ <= \
        after["select.candidates"] - before["select.candidates"]
    assert sorted_ < len(full)         # the lazy sort left rows unsorted


def test_sorted_not_counted_on_the_prefilter_branch():
    frame = synthetic_frames(1)[0]
    tr = kt.KLTracker(CFG, device="cpu", prefilter=True)
    fl = kt.FeatureList.create(10)
    before = profiling.counters()
    tr.select_good_features(frame, fl)
    after = profiling.counters()
    assert after["select.calls"] - before.get("select.calls", 0) == 1
    # the audit certified the cut list, so the full list was never made
    assert after["select.candidates"] - before.get("select.candidates", 0) \
        < (frame.shape[0] - 2 * CFG.bordery) * \
        (frame.shape[1] - 2 * CFG.borderx)
    assert after.get("select.sorted", 0) == before.get("select.sorted", 0)


def frozen_candidate_points(response, cfg, ncols, nrows, out=None):
    """`candidate_points` as numpy built it before the C pass: fresh
    arrays a call, the list that the tracker's owned buffers must give."""
    from klt_tpu_torch.ops.selection import _candidate_borders
    borderx, bordery, step = _candidate_borders(cfg)
    ys = np.arange(bordery, nrows - bordery, step, dtype=np.int32)
    xs = np.arange(borderx, ncols - borderx, step, dtype=np.int32)
    vals = np.asarray(response)[np.ix_(ys, xs)].astype(np.int32)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.empty((vals.size, 3), dtype=np.int32)
    pts[:, 0] = gx.ravel()
    pts[:, 1] = gy.ravel()
    pts[:, 2] = vals.ravel()
    return pts


def lists_counted(before):
    after = profiling.counters()
    return tuple(after.get(k, 0) - before.get(k, 0) for k in
                 ("select.calls", "select.lists_made", "select.lists_reused"))


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda",
                                                 marks=pytest.mark.cuda)])
def test_selection_reuses_the_trackers_lists(device, monkeypatch):
    """A tracker makes its list buffers once for a geometry and reuses
    them at every later selection (on the card kernel S's list there, and
    the pinned list its head comes back into); the spans stay, and the
    features are those of the numpy list on the host, bit for bit."""
    from klt_tpu_torch.runtime import tracker as tracker_mod
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest "
                    "--noconftest -m cuda tests/test_torch_spans.py` on the "
                    "GPU")
    frames = scene()

    def run(device):
        tr = kt.KLTracker(CFG, device=device)
        fl = kt.FeatureList.create(N_FEAT)
        tr.select_good_features(frames[0], fl)
        out = [fl.copy()]
        for k in range(T - 1):
            tracker_calls(tr, fl, frames, k)
            out.append(fl.copy())
        return tr, out

    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        tr, got = run(device)
    assert lists_counted(before) == (T, 1, T - 1)
    card_lists = profiling.counters().get("select.card_lists", 0) - \
        before.get("select.card_lists", 0)
    names = [s.name for s in profiling.spans()]
    assert names.count("select.readback") == T - 1   # the replacements
    assert names.count("select.candidates") == T
    [bufs] = tr._lists.values()
    assert bufs.walk_map.shape == frames[0].shape
    if device == "cuda":
        assert bufs.card.stage_pts.is_pinned()
        assert bufs.card.stage_pts.shape == bufs.pts.shape
        assert bufs.card.pts.shape == bufs.pts.shape and card_lists == T - 1
    else:
        assert bufs.card is None and card_lists == 0
    monkeypatch.setattr(tracker_mod, "candidate_points",
                        frozen_candidate_points)
    _, want = run("cpu")
    for a, b in zip(got, want):
        for u, v in ((a.x, b.x), (a.y, b.y), (a.val, b.val)):
            np.testing.assert_array_equal(u.view(np.int32),
                                          v.view(np.int32))
    assert (np.stack([f.val for f in got]) >= 0).any()


def test_list_buffers_one_pair_a_geometry(monkeypatch):
    """Two frame sizes in turn: one pair of buffers each, made once; past
    STEP_KEYS geometries the least recently used is dropped."""
    from klt_tpu_torch.runtime import tracker as tracker_mod
    frames = scene()
    small = np.ascontiguousarray(frames[:, :56, :72])
    tiny = np.ascontiguousarray(frames[:, :52, :68])
    tr = kt.KLTracker(CFG, device="cpu")
    fl = kt.FeatureList.create(N_FEAT)
    before = profiling.counters()
    for k in range(4):
        tr.select_good_features((frames, small)[k % 2][k], fl)
    assert lists_counted(before) == (4, 2, 2)
    assert [k[0] for k in tr._lists] == [(H, W), (56, 72)]
    monkeypatch.setattr(tracker_mod, "STEP_KEYS", 2)
    tr.select_good_features(tiny[0], fl)
    assert [k[0] for k in tr._lists] == [(56, 72), (52, 68)]
    assert [len(b.pts) for b in tr._lists.values()] == \
        [(56 - 48) * (72 - 48), (52 - 48) * (68 - 48)]


@pytest.mark.parametrize("steps", [1, graph.K - 1, graph.K, graph.K + 3,
                                   2 * graph.K + 1])
def test_sequence_records_a_replay_a_chunk(steps):
    with profile(activities=[ProfilerActivity.CPU]):
        sequence_call(steps)
        sequence_call(steps)
    spans = profiling.spans()
    calls = by_request(spans)
    assert len(calls) == 2
    chunks = len(graph.chunk_lengths(steps, graph.K))
    for group in calls.values():
        root = group[0]
        assert root.name == "sequence" and root.parent is None
        kids = children(group, root)
        assert kids == ["sequence.load"] + \
            ["sequence.stage", "graph.replay", "sequence.rows"] * chunks
    assert len(profiling.span_seconds("graph.replay", root="sequence")) == \
        2 * chunks
    assert_program_spans_are_leaves(spans)


def _hand_made(monkeypatch, rows, counters=None, cap=None):
    """A store of spans made by hand: rows of (name, parent index or None,
    start us, end us), indexed in order; a root opens a request."""
    store = collections.deque(maxlen=cap or profiling.MAX_SPANS)
    request = -1
    made = []
    for i, (name, parent, a, b) in enumerate(rows):
        if parent is None:
            request += 1
        s = profiling.Span(name, i, parent,
                           request if parent is None else made[parent].request)
        s.start, s.end = int(a * 1e3), int(b * 1e3)
        made.append(s)
        store.append(s)
    monkeypatch.setattr(profiling, "_store", store)
    monkeypatch.setattr(profiling, "_counters", dict(counters or {}))


def test_readers_of_the_store(monkeypatch):
    _hand_made(monkeypatch, [("tracker.track", None, 0, 100),
                             ("track.stage", 0, 10, 20),
                             ("track.readback", 0, 30, 90),
                             ("tracker.track", None, 200, 260),
                             ("track.readback", 3, 210, 250),
                             ("track.unpack", 3, 250, 255)])
    assert profiling.span_seconds("track.readback") == \
        pytest.approx([60e-6, 40e-6])
    assert profiling.self_seconds("tracker.track") == \
        pytest.approx([30e-6, 15e-6])
    assert profiling.self_seconds(
        "tracker.track", children=("track.readback",)) == \
        pytest.approx([40e-6, 20e-6])
    assert profiling.span_seconds("track.stage", root="sequence") == []


def test_store_keeps_the_last_spans_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 4)
    monkeypatch.setattr(profiling, "_store", collections.deque(maxlen=4))
    before = profiling.counters().get("spans.dropped", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(6):
            with profiling.span(f"s{k}"):
                pass
    assert [s.name for s in profiling.spans()] == ["s2", "s3", "s4", "s5"]
    assert profiling.counters()["spans.dropped"] - before == 2


# (metric, hand-made spans, counters, the value read)
READERS = [
    ("live.track_host_us_p50",
     [("tracker.track", None, 0, 100), ("track.readback", 0, 30, 90),
      ("tracker.track", None, 200, 300), ("track.readback", 2, 210, 250),
      ("tracker.track", None, 400, 530), ("track.readback", 4, 410, 500)],
     None, 40.0),
    ("live.track_readback_us_p50",
     [("tracker.track", None, 0, 100), ("track.readback", 0, 30, 90)],
     None, 60.0),
    ("live.select_readback_us_p50",
     [("tracker.replace", None, 0, 100), ("select.readback", 0, 5, 25)],
     None, 20.0),
    ("live.select_candidates_us_p50",
     [("tracker.replace", None, 0, 100), ("select.candidates", 0, 5, 12)],
     None, 7.0),
    ("live.select_sort_us_p50",
     [("tracker.replace", None, 0, 100), ("select.sort", 0, 10, 90),
      ("tracker.replace", None, 100, 200), ("select.sort", 2, 110, 160)],
     None, 65.0),
    ("live.select_suppress_us_p50",
     [("tracker.replace", None, 0, 100), ("select.suppress", 0, 90, 99)],
     None, 9.0),
    ("live.candidates_per_replace", [],
     {"select.calls": 4, "select.candidates": 4 * 512}, 512.0),
    ("live.sorted_per_replace", [],
     {"select.calls": 4, "select.candidates": 4 * 512,
      "select.sorted": 4 * 30}, 30.0),
    ("live.list_reuse_share", [],
     {"select.calls": 400, "select.lists_made": 1,
      "select.lists_reused": 399}, 99.75),
    ("live.captures_traced",
     [("tracker.track", None, 0, 100), ("graph.replay", 0, 10, 20)],
     None, 0.0),
    ("farm.captures_traced",
     [("sequence", None, 0, 100), ("graph.capture", 0, 10, 20),
      ("graph.replay", 0, 20, 30)], None, 1.0),
    ("farm.replays_per_clip",
     [("sequence", None, 0, 100), ("graph.replay", 0, 10, 20),
      ("graph.replay", 0, 30, 40), ("sequence", None, 100, 200),
      ("graph.replay", 3, 110, 120), ("graph.replay", 3, 130, 140),
      ("tracker.track", None, 300, 400), ("graph.replay", 6, 310, 320)],
     None, 2.0),
    ("farm.replay_us_p50",
     [("sequence", None, 0, 100), ("graph.replay", 0, 10, 20),
      ("graph.replay", 0, 30, 42), ("graph.replay", 0, 50, 64),
      ("tracker.track", None, 300, 400), ("graph.replay", 4, 310, 390)],
     None, 12.0),
    ("graphs.capture_s", [], {"graph.captures": 3, "graph.capture_s": 0.25},
     0.25),
    ("affine.reset_us_p50",
     [("sequence", None, 0, 100), ("sequence.load", 0, 0, 40),
      ("affine.reset", 1, 10, 30), ("sequence", None, 100, 200),
      ("sequence.load", 3, 100, 150), ("affine.reset", 4, 110, 160)],
     None, 35.0),
    ("affine.lanes_per_step", [],
     {"affine.steps": 200, "affine.lanes": 200 * 16000}, 16000.0),
    ("live.card_select_share", [],
     {"select.calls": 400, "select.card_lists": 399,
      "select.card_spills": 1}, 99.5),
]


@pytest.mark.parametrize("metric,rows,counters,value", READERS,
                         ids=[r[0] for r in READERS])
def test_reader_reads_the_program(metric, rows, counters, value,
                                  monkeypatch):
    read = harness.metric_reader(metric)
    _hand_made(monkeypatch, rows, counters)
    assert read(None) == pytest.approx(value)
    _hand_made(monkeypatch, [], None)
    if metric == "graphs.capture_s":
        assert read(None) == 0.0       # a run that captured nothing
    else:
        assert read(None) is None
    # a program without spans or counters (an older commit)
    monkeypatch.delattr(profiling, "spans")
    assert read(None) is None


def test_benchmark_lists_every_reader():
    per_layer = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for metric, *_ in READERS:
        m = per_layer[metric]
        assert m["source"] in ("program_span", "program_counter")
        assert m["workloads"]


# ------------------------------------------------------------- on the card

@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest --noconftest "
                    "-m cuda tests/test_torch_spans.py` on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_replay_records_nothing_of_its_chunk_function(dev):
    x = torch.zeros(1024, device=dev)

    def chunk(n):
        with profiling.span("chunk"):
            for _ in range(n):
                x.add_(1.0)

    prog = graph.Program(None, chunk, dev, capture=True)
    prog.run(2)                           # the warm-up, eager
    prog.run(2)                           # captured, then replayed
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        prog.run(2)
        torch.cuda.synchronize()
        replayed = [(s.name, s.parent) for s in profiling.spans()]
        prog.run(2, warm_up=True)         # the chunk function run eagerly
        torch.cuda.synchronize()
    assert replayed == [("graph.replay", None)]
    assert [(s.name, s.parent) for s in profiling.spans()[1:]] == \
        [("graph.warm_up", None), ("chunk", 1)]
    assert prog.replays == 2 and float(x[0]) == 8.0


@pytest.mark.cuda
def test_traced_segment_counts_no_span_as_device_work(dev):
    from benchmark import trace as tracing
    frames = scene()
    tr = kt.KLTracker(CFG, device=dev)
    fl = kt.FeatureList.create(N_FEAT)
    tr.select_good_features(frames[0], fl)
    k = [0]

    def work():
        for _ in range(3):
            tracker_calls(tr, fl, frames, k[0] % (T - 1))
            k[0] += 1
        sequence_on_card = torch.from_numpy(scene()).to(dev)
        x = torch.full((N_FEAT,), -1.0, device=dev)
        val = torch.full((N_FEAT,), -1, dtype=torch.int32, device=dev)
        pipeline.track_sequence_replace(sequence_on_card, x, x.clone(), val,
                                        CFG)

    for _ in range(2):                    # every program captured
        work()
    profiling.reset_spans()
    trace = tracing.profile(work, work)
    assert trace is not None and trace.kernels
    assert not [k for k in trace.kernels if profiling.SPAN_PREFIX in k]
    names = {s.name for s in profiling.spans()}
    assert {"tracker.track", "tracker.replace", "select.readback",
            "sequence", "graph.replay"} <= names
    assert "graph.capture" not in names
