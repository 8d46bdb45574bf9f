"""The readers of the port's spans and counters (`spans.py` and the
readers that use it) on hand-made spans, device intervals, runtime events
and counters: unions, intersections and differences, self time by
children, idle time inside spans and by innermost span, syncs inside
frames, the replay counters, and None where there is nothing to read."""
import pytest

from g2o_frontend_tpu_torch.utils import graphs, profiling
from g2o_frontend_tpu_torch.utils.profiling import Span
from perfbench import harness, spans

MS = 1_000_000


def reading(device=(), window_s=0.1, runtime=()):
    device = sorted(device, key=lambda d: d[1])
    trace = harness.Trace(list(device), [], sorted(runtime, key=lambda e: e[1]), harness.busy_ns(device) / 1e9)
    return harness.Reading(trace, {}, window_s, {})


def frame(i, t0, t1, request):
    return Span(i, "pwn_tracker.frame", t0 * MS, t1 * MS, -1, request)


# two frames: 0-10 ms and 20-30 ms, the device busy 2-6 and 22-29 ms
SPANS = [
    Span(1, "upload", 0 * MS, 1 * MS, 0, 0),
    Span(3, "launch", 3 * MS, 4 * MS, 2, 0),
    Span(2, "stage:align", 2 * MS, 5 * MS, 0, 0),
    Span(4, "host_read", 5 * MS, 7 * MS, 0, 0),
    Span(5, "host_read", 6 * MS, 8 * MS, 0, 0),  # overlaps the first: the union counts once
    frame(0, 0, 10, 0),
    Span(7, "stage:align", 21 * MS, 24 * MS, 6, 1),
    Span(8, "host_read", 24 * MS, 25 * MS, 6, 1),
    Span(9, "launch", 22 * MS, 23 * MS, 7, 1),
    frame(6, 20, 30, 1),
]
DEVICE = [("k", 2 * MS, 6 * MS), ("k", 22 * MS, 29 * MS)]
# the runtime's calls: three syncs start in frame 0 (one in no host_read: the
# upload's), one in frame 1, one between the frames; copies are not syncs
RUNTIME = [
    ("cudaStreamSynchronize", MS // 2, MS - 1),
    ("cudaMemcpyAsync", 5 * MS + 10, 5 * MS + 20),
    ("cudaStreamSynchronize", 5 * MS + 30, 6 * MS),
    ("cudaDeviceSynchronize", 7 * MS, 7 * MS + 5),
    ("cudaStreamSynchronize", 15 * MS, 16 * MS),
    ("cudaMemcpyAsync", 24 * MS + 1, 24 * MS + 2),
    ("cudaStreamSynchronize_ptsz", 24 * MS + 3, 24 * MS + 9),
    ("cudaGraphLaunch", 22 * MS + 5, 22 * MS + 9),
]


@pytest.fixture
def recorded(monkeypatch):
    box = {"spans": list(SPANS)}
    monkeypatch.setattr(profiling, "spans", lambda: list(box["spans"]))
    return box


def test_intervals():
    assert spans.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert spans.minus([(0, 3), (5, 8)], [(2, 6)]) == [(0, 2), (6, 8)]
    assert spans.minus([(0, 3)], []) == [(0, 3)] and spans.minus([], [(0, 1)]) == []
    assert spans.intersect([(0, 3), (5, 8)], [(2, 6), (7, 9)]) == [(2, 3), (5, 6), (7, 8)]
    assert spans.complement([(2, 3), (5, 6)], 0, 10) == [(0, 2), (3, 5), (6, 10)]
    assert spans.complement([(0, 12)], 0, 10) == []
    assert spans.length([(0, 3), (5, 8)]) == 6
    assert spans.covered([(0, 3), (5, 8)], 2, 6) == 2


def test_self_time_takes_away_the_union_of_counted_children():
    f = SPANS[5]
    kids = spans.children(SPANS)[f.id]
    # stages 2-5 and reads 5-8: 6 ms of the frame's 10 covered; the upload is the frame's own
    assert spans.self_ns(f, kids, lambda s: s.name.startswith("stage:") or s.name == "host_read") == 4 * MS
    assert spans.self_ns(f, kids) == 3 * MS


def test_tracker_host_ms_and_host_syncs_per_frame(recorded):
    r = reading(DEVICE, runtime=RUNTIME)
    # frame 0: 10 - 6 = 4 ms; frame 1: 10 - 4 = 6 ms
    assert harness.layer_reader("tracker_host_ms")(r) == pytest.approx(5.0)
    # three syncs in frame 0, wherever they sit in it, and one in frame 1
    assert harness.layer_reader("host_syncs_per_frame")(r) == 2.0


def test_syncs_are_the_runtimes_blocking_calls():
    assert [e[0] for e in RUNTIME if spans.is_sync(e[0])] == [
        "cudaStreamSynchronize", "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaStreamSynchronize",
        "cudaStreamSynchronize_ptsz"]
    assert not spans.is_sync("cudaMemcpyAsync") and spans.is_sync("cudaMemcpy")


def test_launch_host_us_reads_the_replay_counters(monkeypatch):
    monkeypatch.setattr(graphs, "replay_ns", 4 * 31_500)
    monkeypatch.setattr(graphs, "replays", 4)
    assert harness.layer_reader("launch_host_us.schur")(reading()) == pytest.approx(31.5)


def test_idle_program_pct_counts_idle_time_inside_the_top_spans(recorded):
    r = reading(DEVICE, window_s=0.04)
    # idle inside the frames: 0-2, 6-10, 20-22, 29-30 = 9 ms of a 40-ms window
    assert harness.layer_reader("idle_program_pct.track")(r) == pytest.approx(100 * 9 / 40)
    assert harness.layer_reader("device_idle_pct.track")(r) == pytest.approx(100 * (1 - 11 / 40))


def test_idle_program_pct_leaves_out_the_idle_time_inside_launches(recorded):
    """The device idles 0-4 and 6-10 ms of the frame, 1-3 ms of it inside
    a graph replay: 6 ms of host work in a 20-ms window."""
    recorded["spans"] = [Span(1, "launch", 1 * MS, 3 * MS, 0, 0), frame(0, 0, 10, 0)]
    r = reading([("k", 4 * MS, 6 * MS)], window_s=0.02)
    assert harness.layer_reader("idle_program_pct.track")(r) == pytest.approx(100 * 6 / 20)


def test_a_gap_counts_where_it_lies_not_where_it_starts(recorded):
    """A gap that starts inside a frame and ends outside it counts only
    for its part inside."""
    recorded["spans"] = [frame(0, 0, 10, 0)]
    r = reading([("k", 0, 4 * MS), ("k", 16 * MS, 20 * MS)], window_s=0.02)
    assert harness.layer_reader("idle_program_pct.schur")(r) == pytest.approx(100 * 6 / 20)


def test_idle_by_innermost_span():
    idle = spans.idle_by_innermost(SPANS, DEVICE, 0, 40 * MS)
    assert idle == {"upload": 1 * MS, "pwn_tracker.frame": 5 * MS, "host_read": 2 * MS,
                    "stage:align": 1 * MS, "outside the program": 10 * MS + 10 * MS}
    assert sum(idle.values()) == 40 * MS - spans.length(spans.busy(DEVICE))


def test_anchors_inside_their_spans():
    events = [("cudaGraphLaunch", 3 * MS + 10, 3 * MS + 50), ("cudaGraphLaunch", 23 * MS - 5, 23 * MS + 5)]
    assert spans.inside(events, SPANS, "launch") == 0.5
    assert spans.inside(events, SPANS, "launch", slack_ns=5) == 1.0
    assert spans.inside([], SPANS, "launch") is None
    launches = spans.intervals(SPANS, "launch")
    assert spans.holders(events, launches) == [(3 * MS, 4 * MS), (22 * MS, 23 * MS)]
    assert spans.holders([("x", 10 * MS, 10 * MS + 1)], launches) == [None]


@pytest.mark.parametrize("name", ["tracker_host_ms", "host_syncs_per_frame", "launch_host_us.schur",
                                  "idle_program_pct.track", "idle_program_pct.schur"])
def test_each_reader_reads_none_without_spans(monkeypatch, name):
    """Nothing recorded (no profiler session, no graph replayed on a card),
    and a program older than the spans and counters."""
    monkeypatch.setattr(profiling, "spans", lambda: [])
    monkeypatch.setattr(graphs, "replays", 0)
    assert harness.layer_reader(name)(reading(DEVICE, runtime=RUNTIME)) is None
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(graphs, "replays")
    monkeypatch.delattr(graphs, "replay_ns")
    assert harness.layer_reader(name)(reading(DEVICE, runtime=RUNTIME)) is None
