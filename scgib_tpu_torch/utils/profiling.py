"""Observability: step timers with edges/s counters, profiler traces and
run logs.

Counterpart of ``scgib_tpu/utils/profiling.py``.  ``StepTimer``'s time is
the host clock around a step; the caller ends the step with a value read
back from the device (the loss), so the time covers the device work.
``profile_trace`` is ``torch.profiler`` (the JAX package's XLA trace):
CPU and CUDA activities, one Chrome trace written into the directory.
Unlike the JAX function it raises where the profiler cannot start or
writes nothing, rather than passing silently.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Any, Dict, Iterator, Optional

import torch


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


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` around a block, CPU and (where a card is
    present) CUDA activities; the trace is exported to
    ``<log_dir>/trace-<time>-<pid>.json`` (Chrome / Perfetto).  Yields the
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
    try:
        yield prof
    finally:
        prof.stop()
    prof.export_chrome_trace(path)
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        raise RuntimeError(f"the profiler wrote no trace to {path}")


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
