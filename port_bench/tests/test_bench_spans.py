"""``spans.py``'s arithmetic on a hand-built trace and span list: spans
outside the trace's span are dropped, a step's device idle is its length
less its overlap with the busy intervals, the means are per replayed step
call, and nothing to read gives None."""

import types

import pytest

from port_bench import spans, trace
from scgib_tpu_torch.utils.profiling import STEP_PARTS, Span

MS = 1_000_000                                   # ns


def _call(step, start, kind="replay", copies=22, clones=3):
    """A step call's spans from ``start`` ms: key 1 ms, inputs 1 ms,
    replay 2 ms, tally 1 ms, outputs 1 ms (6 ms in all)."""
    lengths = (1, 1, 2, 1, 1)
    at = start * MS
    out = [Span("scgib.step", at, at + 6 * MS, step, None, {"kind": kind})]
    counts = {"scgib.step.inputs": {"copies": copies, "bytes": 4096},
              "scgib.step.outputs": {"clones": clones}}
    for name, n in zip(STEP_PARTS, lengths):
        out.append(Span(name, at, at + n * MS, step, "scgib.step",
                        counts.get(name, {})))
        at += n * MS
    return out


def _trace(lo_ms, hi_ms, device=()):
    return trace.Trace((lo_ms * MS, hi_ms * MS),
                       [("k", a * MS, b * MS) for a, b in device], [])


def test_spans_outside_the_window_and_other_calls_are_dropped():
    kept = _call(1, 10) + _call(2, 20)
    every = (_call(0, 0) + kept + _call(3, 30)           # 30-36: past 34
             + _call(4, 17, kind="capture") + _call(5, 26, kind="eager"))
    found = spans.replayed(_trace(10, 34), every)
    assert [top.step for top, _ in found] == [1, 2]
    assert all(set(parts) == set(STEP_PARTS) for _, parts in found)
    # a call that lost a part it is counted by is left out
    partial = [s for s in _call(6, 40) if s.name != "scgib.step.replay"]
    assert spans.replayed(_trace(0, 100), partial) == []


def test_idle_inside_a_span_is_its_length_less_the_busy_overlap():
    busy = [(0, 5), (8, 12), (14, 15), (19, 30), (40, 41)]
    assert spans.idle_ns([(2, 10), (12, 20), (30, 40)], busy) == [
        8 - 3 - 2, 8 - 1 - 1, 10]
    assert spans.idle_ns([(0, 5)], []) == [5]
    assert spans.idle_ns([(1, 4)], [(0, 5)]) == [0]


def test_the_means_are_per_replayed_step():
    every = _call(1, 10) + _call(2, 20, copies=20, clones=1)
    tr = _trace(0, 40, device=[(10, 13), (12, 14), (22, 23)])
    found = spans.replayed(tr, every)
    assert spans.step_host_ms(found) == pytest.approx(6.0)
    assert spans.replay_host_ms(found) == pytest.approx(2.0)
    assert spans.host_calls(found) == pytest.approx(
        ((22 + 1 + 3) + (20 + 1 + 1)) / 2)
    # step 1 (10-16 ms): busy 10-14, idle 2; step 2 (20-26): busy 22-23,
    # idle 5
    assert spans.step_idle_ms(tr, found) == pytest.approx((2 + 5) / 2)


def test_none_without_spans_to_read(monkeypatch):
    from scgib_tpu_torch.utils import profiling
    assert spans.calls(types.SimpleNamespace(trace=None)) is None
    run = types.SimpleNamespace(trace=_trace(0, 40))
    monkeypatch.setattr(profiling, "spans_between", lambda a, b: [])
    assert spans.calls(run) is None
    monkeypatch.setattr(profiling, "spans_between",
                        lambda a, b: _call(1, 10, kind="eager"))
    assert spans.calls(run) is None
    monkeypatch.setattr(profiling, "spans_between",
                        lambda a, b: _call(1, 10))
    assert [top.step for top, _ in spans.calls(run)] == [1]
    # a program without the span reader (an older one) gives None too
    monkeypatch.delattr(profiling, "spans_between")
    assert spans.calls(run) is None
