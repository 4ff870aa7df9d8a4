"""Observability: step timers with edges/s counters, the program's spans,
profiler traces and run logs.

Counterpart of ``scgib_tpu/utils/profiling.py``.  ``StepTimer``'s time is
the host clock around a step; the caller ends the step with a value read
back from the device (the loss), so the time covers the device work.
``profile_trace`` is ``torch.profiler`` (the JAX package's XLA trace):
CPU and CUDA activities, one Chrome trace written into the directory.
Unlike the JAX function it raises where the profiler cannot start or
writes nothing, rather than passing silently.

The spans: while a ``torch.profiler`` session is open, and only then, each
call of a step (``train/trainer.py::_CapturedSteps``) records its span,
``scgib.step``, and the spans of its parts, on ``time.time_ns()``'s clock
(the profiler's own): the call's kind in the step's span, the counts of
the work where it happens.  ``SPANS`` keeps the newest ``SPAN_CAPACITY``
of them in memory; ``spans_between`` reads them without taking them, and
``profile_trace`` writes those of its session into its trace, on a track
of their own.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import os
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


class StepTimer:
    """Accumulates step wall-times and work counters; reports edges/s.

        timer = StepTimer()
        with timer.step(edges=n_edges):
            losses = step(g, sub)
            float(losses.total)
        print(timer.summary())
    """

    def __init__(self):
        self.steps = 0
        self.total_time = 0.0
        self.total_edges = 0
        self.total_nodes = 0
        self.total_graphs = 0

    @contextlib.contextmanager
    def step(self, edges: int = 0, nodes: int = 0,
             graphs: int = 0) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        self.total_time += time.perf_counter() - t0
        self.steps += 1
        self.total_edges += edges
        self.total_nodes += nodes
        self.total_graphs += graphs

    @property
    def edges_per_s(self) -> float:
        return self.total_edges / self.total_time if self.total_time else 0.0

    @property
    def steps_per_s(self) -> float:
        return self.steps / self.total_time if self.total_time else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "steps": self.steps,
            "wall_s": round(self.total_time, 3),
            "steps_per_s": round(self.steps_per_s, 2),
            "edges_per_s": round(self.edges_per_s, 1),
            "nodes_per_s": round(
                self.total_nodes / self.total_time, 1
            ) if self.total_time else 0.0,
        }

    def reset(self) -> None:
        self.__init__()


# --- the program's spans ----------------------------------------------------

SPAN_CAPACITY = 65_536
STEP_SPAN = "scgib.step"
# the parts of a step call, in the order they run (``_CapturedSteps``)
STEP_PARTS = ("scgib.step.key", "scgib.step.inputs", "scgib.step.replay",
              "scgib.step.tally", "scgib.step.outputs")
SPAN_TRACK = "scgib_tpu_torch spans"


class Span(NamedTuple):
    """One span: ``start`` and ``end`` in ``time.time_ns()``'s ns;
    ``step`` the id of the step call it belongs to, which its children
    share; ``parent`` its parent's name (None for the call's own span);
    ``args`` the call's ``kind`` or the counts of the work done in it."""

    name: str
    start: int
    end: int
    step: int
    parent: Optional[str]
    args: Dict[str, Any]


class SpanBuffer:
    """The newest ``capacity`` spans, oldest first."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.spans: collections.deque = collections.deque(maxlen=capacity)
        self._ids = itertools.count(1)

    def step(self) -> "StepSpans":
        """The spans of a new step call, opened now."""
        return StepSpans(self, next(self._ids))

    def between(self, start: int, end: int) -> List[Span]:
        """The spans that lie within [start, end] (ns), in the order they
        were kept; the buffer keeps them."""
        return [s for s in list(self.spans)
                if start <= s.start and s.end <= end]


class StepSpans:
    """One step call's spans while they are open: the call's own,
    ``STEP_SPAN``, and its parts, which follow one another, each ending
    where the next begins.  Nothing is kept until ``end``."""

    __slots__ = ("buffer", "step", "start", "at", "parts")

    def __init__(self, buffer: SpanBuffer, step: int):
        self.buffer, self.step = buffer, step
        self.parts: list = []
        self.start = self.at = time.time_ns()

    def part(self, name: str) -> None:
        """Ends the part ``name``, begun where the last part ended (the
        call's start for the first)."""
        now = time.time_ns()
        self.parts.append((name, self.at, now))
        self.at = now

    def end(self, kind: str, counts: Optional[Dict[str, dict]] = None):
        """Ends the call, of ``kind`` ("eager", "capture" or "replay"),
        and keeps its spans; ``counts`` maps a part's name to its
        counts."""
        now = time.time_ns()
        counts = counts or {}
        keep = self.buffer.spans.append
        keep(Span(STEP_SPAN, self.start, now, self.step, None,
                  {"kind": kind}))
        for name, a, b in self.parts:
            keep(Span(name, a, b, self.step, STEP_SPAN,
                      dict(counts.get(name, ()))))


SPANS = SpanBuffer()


def step_spans() -> Optional[StepSpans]:
    """The spans of a new step call while a ``torch.profiler`` session is
    open; None, and nothing else done, while none is."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    return SPANS.step()


def spans_between(start: int, end: int) -> List[Span]:
    """The program's kept spans that lie within [start, end],
    ``time.time_ns()``'s ns."""
    return SPANS.between(start, end)


def _write_spans(path: str, spans: List[Span]) -> None:
    """Adds ``spans`` to the Chrome trace at ``path`` as complete events on
    a thread track of their own, on the trace's clock: its
    ``baseTimeNanoseconds`` (0 where it has none) subtracted, in us."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid, tid = os.getpid(), SPAN_TRACK
    events = trace["traceEvents"]
    events.append({"ph": "M", "name": "thread_name", "pid": pid,
                   "tid": tid, "args": {"name": SPAN_TRACK}})
    for s in spans:
        events.append({"ph": "X", "cat": "scgib_span", "name": s.name,
                       "pid": pid, "tid": tid, "ts": (s.start - base) / 1e3,
                       "dur": (s.end - s.start) / 1e3,
                       "args": {"step": s.step, "parent": s.parent,
                                **s.args}})
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` around a block, CPU and (where a card is
    present) CUDA activities; the trace is exported to
    ``<log_dir>/trace-<time>-<pid>.json`` (Chrome / Perfetto), with the
    program's spans of the block on their own track.  Yields the
    profiler, whose ``key_averages()`` sum the block by op and kernel.
    Raises where the profiler cannot start or the trace is not
    written."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(log_dir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}"
                                 f"-{os.getpid()}.json")
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    start = time.time_ns()
    try:
        yield prof
    finally:
        end = time.time_ns()
        prof.stop()
    prof.export_chrome_trace(path)
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        raise RuntimeError(f"the profiler wrote no trace to {path}")
    _write_spans(path, spans_between(start, end))


def make_run_logger(log_dir: str, run_name: str,
                    config: Optional[Dict[str, Any]] = None
                    ) -> logging.Logger:
    """File and console logger whose first record is the run's config
    (the reference's exp_logs, exp_pretraining.py:210-215), the epochs'
    records to follow."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"{run_name}-{time.strftime('%Y%m%d-%H%M%S')}.log")
    logger = logging.getLogger(f"scgib_tpu_torch.{run_name}")
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fh = logging.FileHandler(path)
    fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
    logger.addHandler(fh)
    sh = logging.StreamHandler()
    sh.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(sh)
    if config is not None:
        logger.info("config %s", json.dumps(config, default=str))
    return logger
