"""The port's ``Tracer`` (``cubed_tpu_torch/observability/tracer.py``): the
counterparts of tests/observability/test_tracer.py, and parity with the JAX
package's ``Tracer``: both driven by one injected clock through the same
calls give equal ``chrome_events()``."""

import json
import threading

import pytest

from cubed_tpu.observability.tracer import Tracer as ReferenceTracer
from cubed_tpu_torch.observability.tracer import Tracer


def test_span_nesting_records_parent_and_depth():
    tr = Tracer()
    with tr.span("outer", kind="test"):
        with tr.span("inner"):
            pass
        with tr.span("inner2"):
            pass
    names = [e["name"] for e in tr.events]
    # spans are recorded on exit: inner finishes before outer
    assert names == ["inner", "inner2", "outer"]
    by_name = {e["name"]: e for e in tr.events}
    assert by_name["outer"]["args"]["depth"] == 0
    assert "parent" not in by_name["outer"]["args"]
    assert by_name["inner"]["args"]["parent"] == "outer"
    assert by_name["inner"]["args"]["depth"] == 1
    assert by_name["outer"]["args"]["kind"] == "test"
    assert by_name["outer"]["ts"] <= by_name["inner"]["ts"]
    assert by_name["outer"]["dur"] >= by_name["inner"]["dur"]


def test_span_records_exception_and_does_not_swallow():
    tr = Tracer()
    with pytest.raises(ValueError):
        with tr.span("boom"):
            raise ValueError("x")
    assert tr.events[0]["args"]["error"] is True
    assert tr.events[0]["args"]["error_type"] == "ValueError"


def test_open_span_is_exported_closed_with_error_not_dropped():
    tr = Tracer()
    with tr.span("done"):
        pass
    sp = tr.span("left-open")
    sp.__enter__()
    open_recs = [e for e in tr.chrome_events() if e.get("ph") == "X" and e["name"] == "left-open"]
    assert len(open_recs) == 1
    assert open_recs[0]["args"]["error"] is True
    assert open_recs[0]["args"]["unterminated"] is True
    # the synthesized close is export-only: the live span records its real
    # completion when it exits
    assert all(e["name"] != "left-open" for e in tr.events)
    sp.__exit__(None, None, None)
    assert "error" not in [e for e in tr.events if e["name"] == "left-open"][0]["args"]


def test_nesting_is_per_thread():
    tr = Tracer()
    seen = {}

    def worker():
        with tr.span("in-thread"):
            seen["depth"] = len(tr._stack())

    with tr.span("main-span"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    by_name = {e["name"]: e for e in tr.events}
    assert "parent" not in by_name["in-thread"]["args"]
    assert by_name["in-thread"]["args"]["depth"] == 0
    assert seen["depth"] == 1


def test_jsonl_sink_streams_events(tmp_path):
    path = str(tmp_path / "events.jsonl")
    tr = Tracer(jsonl_path=path)
    with tr.span("a", idx=1):
        pass
    tr.instant("marker", note="hi")
    tr.close()
    lines = [json.loads(line) for line in open(path).read().splitlines()]
    assert len(lines) == 2
    assert lines[0]["name"] == "a" and lines[0]["args"]["idx"] == 1
    assert lines[1]["name"] == "marker" and lines[1]["ph"] == "i"


def test_chrome_export_is_loadable_and_well_formed(tmp_path):
    tr = Tracer()
    with tr.span("alpha", lane="ops"):
        with tr.span("beta", lane="ops"):
            pass
    tr.add_complete("task-0", 100.0, 100.5, lane="op:x", cat="task", chunk="(0,0)")
    out = str(tmp_path / "trace.json")
    tr.export_chrome(out)
    doc = json.load(open(out))
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    for e in xs:
        assert {"name", "ph", "ts", "dur", "pid", "tid"} <= set(e)
        assert e["ts"] >= 0 and e["dur"] >= 0
    assert {"ops", "op:x"} <= {m["args"]["name"] for m in metas if m["name"] == "thread_name"}
    task = next(e for e in xs if e["name"] == "task-0")
    assert task["args"]["chunk"] == "(0,0)"
    assert abs(task["dur"] - 0.5e6) < 1.0


def test_max_events_bounds_memory():
    tr = Tracer(max_events=3)
    for i in range(10):
        tr.instant(f"e{i}")
    assert len(tr.events) == 3
    assert tr.dropped == 7


class _Clock:
    """A clock that advances 0.25 s at every reading."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        self.t += 0.25
        return self.t


def _drive(tracer_cls, max_events=1_000_000):
    """The same calls on a tracer of *tracer_cls*: nested spans, a span that
    raises, instants, counters, externally timed spans, a span in another
    thread and two spans left open at export."""
    tr = tracer_cls(max_events=max_events, clock=_Clock())
    with tr.span("outer", lane="ops", kind="test"):
        with tr.span("inner", lane="ops"):
            tr.instant("mark", lane="scheduler", note="hi")
        with pytest.raises(KeyError):
            with tr.span("fails", lane="ops"):
                raise KeyError("k")
    tr.add_complete("task-0", 1001.0, 1001.5, lane="op:x", cat="task", chunk="(0, 0)")
    tr.add_counter("rss_bytes", 1002.0, 123456, lane="memory")
    tr.instant("at", lane="scheduler", ts=1003.0)

    def worker():
        with tr.span("in-thread", lane="worker"):
            pass

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    tr.span("left-open", lane="ops", attempt=1).__enter__()
    tr.span("left-open-2").__enter__()  # the thread lane: a default lane label
    return tr


@pytest.mark.parametrize("max_events", [1_000_000, 4])
def test_chrome_events_equal_the_reference_tracers(max_events):
    ours, theirs = _drive(Tracer, max_events), _drive(ReferenceTracer, max_events)
    assert ours.dropped == theirs.dropped
    assert ours.events == theirs.events
    mine = ours.chrome_events()
    assert mine == theirs.chrome_events()
    assert {e["args"]["name"] for e in mine if e["ph"] == "M"} >= {"ops", "scheduler"}
