"""The device trace of a traced run, read from ``torch.profiler``'s events.

``record(fn)`` runs ``fn`` under the profiler and keeps, on the host's
wall clock (the trace's own), the span, every device operation (kernels,
copies, sets) and the harness's host ranges.  Nothing is written to disk.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, List, Tuple

import torch

STEP = "port_bench/step"
BETWEEN = "port_bench/between steps"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    span: Tuple[int, int]                    # ns
    device: List[Tuple[str, int, int]]       # (name, start, end) ns
    host: List[Tuple[str, int, int]]         # the span thread's ranges

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) * 1e-9

    def from_first(self, name: str) -> "Trace":
        """The same trace, its span starting where the first host range
        named ``name`` starts."""
        start = min(a for n, a, _ in self.host if n == name)
        return Trace((start, self.span[1]), self.device, self.host)

    def busy(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals inside the span,
        merged, in order."""
        lo, hi = self.span
        out: List[List[int]] = []
        for _, a, b in sorted(self.device, key=lambda t: t[1]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-9

    def seconds_of(self, match: Callable[[str], bool]) -> float:
        """Total duration of the device operations whose names match."""
        return sum(b - a for n, a, b in self.device if match(n)) * 1e-9

    def top_ops(self, count: int = 10):
        per = collections.Counter()
        for n, a, b in self.device:
            per[short(n)] += (b - a) * 1e-9
        return [[n, s] for n, s in per.most_common(count)]

    def idle_gaps(self, count: int = 10):
        """The device's idle time inside the span, by the innermost host
        range open at each gap's middle: the longest totals first."""
        busy = self.busy()
        edges = [self.span[0]] + [x for ab in busy for x in ab] + [
            self.span[1]]
        host = sorted(self.host, key=lambda t: t[1])
        per = collections.Counter()
        opened: List[Tuple[str, int, int]] = []   # nested ranges, a stack
        at = 0
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            while at < len(host) and host[at][1] <= mid:
                opened.append(host[at])
                at += 1
            while opened and opened[-1][2] <= mid:
                opened.pop()
            name = opened[-1][0] if opened else "host, outside any range"
            per[short(name)] += (b - a) * 1e-9
        return [[n, s] for n, s in per.most_common(count)]


def short(name: str) -> str:
    """A kernel's name without its namespaces' "(anonymous namespace)::",
    its argument list and its return type."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0]
    return head[5:] if head.startswith("void ") else head


def record(fn: Callable[[], None], device,
           host: Callable[[], List[Tuple[str, int, int]]] = list) -> Trace:
    """``fn()`` under the profiler, tracing the device's activity alone
    (recording every host operation as well doubled a streamed step's
    time); the span runs from the call to the device's last operation, and
    ``host()`` gives the host's ranges (the harness's own, on the same
    wall clock, ns).  On a CPU device (a rehearsal) nothing is traced and
    the trace holds no device operation."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=activities, record_shapes=False,
                 with_stack=False) as prof:
        start = time.time_ns()
        fn()
        if cuda:
            torch.cuda.synchronize(device)
        end = time.time_ns()
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    device_ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in events
                  if e.device_type() != cpu and _on_device(e)]
    inside = sum(start <= a and b <= end + 1_000_000
                 for _, a, b in device_ops)
    if device_ops and inside < len(device_ops) // 2:
        raise RuntimeError("the device trace's clock is not the host's "
                           "wall clock: its operations fall outside the "
                           "traced span")
    return Trace((start, end), device_ops, host())


def _on_device(event) -> bool:
    """A device operation, not a host range mirrored on the device's
    timeline."""
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_ACTIVITIES
    return not event.name().startswith(("port_bench/", "ProfilerStep"))
