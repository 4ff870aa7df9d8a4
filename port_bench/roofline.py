"""The arithmetic the per-layer readers share: a kernel family's share of
its roofline over a traced window, and the whole step's share of the
peak."""

from __future__ import annotations

import fnmatch
from typing import Optional

from . import counts
from .trace import short


def _peaks(run):
    p = run.peaks
    return p["flops_per_s"][run.cfg["precision"]], p["bytes_per_s"]


def kernel_seconds(run, family: str) -> float:
    pats = run.kernels[family]
    return run.trace.seconds_of(
        lambda name: any(fnmatch.fnmatch(short(name), p) for p in pats))


def gin_conv_least(run, st: counts.Stats) -> float:
    """Least seconds of the fused GIN convs of one pretraining step: each
    conv's forward and its backward (``gin_fused_bwd``'s share), in both
    encoders."""
    cfg = run.cfg
    flops, bw = _peaks(run)
    d, dt = cfg["hidden"], cfg["d_transfer"]
    total = 0.0
    for rows, edges in ((st.n, st.e), (st.s, st.q)):
        for i in range(cfg["num_layers"]):
            din = dt if i == 0 else d
            for kind in ("fwd", "bwd"):
                ops, nbytes = counts.gin_conv(kind, rows, edges, din, d, d)
                total += counts.least_seconds(ops, nbytes, flops, bw)[0]
    return total


def attention_least(run, st: counts.Stats) -> float:
    """Least seconds of the attention kernels of one pretraining step: the
    forward, the row pass and the column pass of every layer of both
    encoders (the two-pass backward)."""
    cfg = run.cfg
    flops, bw = _peaks(run)
    heads = cfg["num_heads"]
    hd = cfg["hidden"] // heads
    total = 0.0
    for rows, edges in ((st.n, st.e), (st.s, st.q)):
        for kind in ("fwd", "rows", "cols"):
            ops, nbytes = counts.attention(kind, rows, edges, heads, hd)
            total += (cfg["num_layers"] + 1) * counts.least_seconds(
                ops, nbytes, flops, bw)[0]
    return total


def share(run, family: str, least) -> Optional[float]:
    """100 x the least time of the traced steps over the device time of
    the family's kernels; None without a trace of pretraining steps or
    where no such kernel ran."""
    stats = getattr(run.driver, "traced_stats", None)
    if run.trace is None or not stats:
        return None
    spent = kernel_seconds(run, family)
    if spent <= 0:
        return None
    return 100.0 * sum(least(run, st) for st in stats) / spent


def step_mfu(run) -> Optional[float]:
    """The model's FLOPs of the untraced stretch's steps over its host
    seconds times the peak."""
    u = getattr(run.driver, "untraced", None)
    if run.trace is None or not u or "stats" not in u:
        return None
    flops, _ = _peaks(run)
    work = sum(counts.step_flops(run.cfg, st) for st in u["stats"])
    return 100.0 * work / (u["seconds"] * flops)


def idle_share(run, loop: str) -> Optional[float]:
    """100 x (1 - the device's busy seconds a unit (step or epoch) of the
    traced stretch x the units of the untraced stretch / its host
    seconds): the trace's device time against the untraced wall time,
    which the profiler's cost to the host does not stretch."""
    u = getattr(run.driver, "untraced", None)
    if run.trace is None or run.traffic["loop"] != loop or not u:
        return None
    traced = (len(run.driver.traced_stats) if loop == "pretrain"
              else run.traffic["trace_epochs"])
    busy = run.trace.busy_s() / traced * u["units"]
    return 100.0 * (1.0 - busy / u["seconds"])
