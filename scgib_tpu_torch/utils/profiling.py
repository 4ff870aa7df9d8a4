"""Step timing with work counters: the edges/s of the pretraining log.

Counterpart of ``scgib_tpu/utils/profiling.py::StepTimer``.  A step's time
is the host clock around it; the caller ends the step with a value read
back from the device (the loss), so the time covers the device work.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator


class StepTimer:
    """Accumulates step wall-times and work counters; reports edges/s."""

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
