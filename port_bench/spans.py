"""The program's spans of a traced run's replayed steps, and the per-step
means the ``program_span`` and ``program_counter`` readers give.

The program keeps its spans while a profiler session is open, on the
trace's own clock (``scgib_tpu_torch/utils/profiling.py``): each step call's
``scgib.step`` and the parts of a replay.  ``calls(run)`` reads those inside
the trace's span; every mean is over the replayed step calls found there.
A program that keeps no spans, a run with no trace, and a trace with no
replayed step (a CPU rehearsal steps eagerly) give None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

STEP = "scgib.step"
INPUTS = "scgib.step.inputs"
REPLAY = "scgib.step.replay"
OUTPUTS = "scgib.step.outputs"

Call = Tuple[object, Dict[str, object]]     # a step's span, its parts by name


def replayed(trace, spans: Sequence) -> List[Call]:
    """The replayed step calls whose spans lie inside ``trace.span``, in
    order: each call's ``STEP`` span and its parts by name (calls missing
    a part they count on are left out)."""
    lo, hi = trace.span
    inside = [s for s in spans if lo <= s.start and s.end <= hi]
    tops = {s.step: s for s in inside
            if s.name == STEP and s.args.get("kind") == "replay"}
    parts: Dict[int, Dict[str, object]] = {k: {} for k in tops}
    for s in inside:
        if s.parent == STEP and s.step in parts:
            parts[s.step][s.name] = s
    return [(top, parts[top.step])
            for top in sorted(tops.values(), key=lambda s: s.start)
            if {INPUTS, REPLAY, OUTPUTS} <= parts[top.step].keys()]


def calls(run) -> Optional[List[Call]]:
    """The run's replayed step calls, or None where there are none to
    read."""
    if run.trace is None:
        return None
    try:
        from scgib_tpu_torch.utils.profiling import spans_between
    except ImportError:
        return None
    found = replayed(run.trace, spans_between(*run.trace.span))
    return found or None


def _mean(values: List[float]) -> float:
    return sum(values) / len(values)


def step_host_ms(found: List[Call]) -> float:
    """Host ms a step call: its ``STEP`` span."""
    return _mean([(top.end - top.start) * 1e-6 for top, _ in found])


def replay_host_ms(found: List[Call]) -> float:
    """Host ms a step call inside ``graph.replay()``."""
    return _mean([(p[REPLAY].end - p[REPLAY].start) * 1e-6
                  for _, p in found])


def host_calls(found: List[Call]) -> float:
    """The host's CUDA calls a step call: its copies into the input
    buffers, the graph's launch and the clones of its outputs."""
    return _mean([p[INPUTS].args["copies"] + 1 + p[OUTPUTS].args["clones"]
                  for _, p in found])


def idle_ns(intervals: Sequence[Tuple[int, int]],
            busy: Sequence[Tuple[int, int]]) -> List[int]:
    """Each interval's length less its overlap with ``busy`` (the device's
    busy intervals: sorted, disjoint); ``intervals`` sorted by start."""
    out, j = [], 0
    for a, b in intervals:
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        covered, k = 0, j
        while k < len(busy) and busy[k][0] < b:
            covered += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
        out.append(b - a - covered)
    return out


def step_idle_ms(trace, found: List[Call]) -> float:
    """Device-idle ms a step call: its ``STEP`` span less the device's
    busy time inside it (``trace.busy()``)."""
    gaps = idle_ns([(top.start, top.end) for top, _ in found], trace.busy())
    return _mean([g * 1e-6 for g in gaps])
