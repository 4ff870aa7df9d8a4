"""The banded SpMM kernel's work, for ``metrics/banded_spmm_roofline.py``.

``banded_spmm_kernel`` serves three wrappers of the port: the GIN
backward's ``spmm_self`` (g + A g, once a fused conv), the reconstruction's
``spmm`` (A im, and the same product in its backward) and the candidate
pooling's ``pool`` (each ego-net row summed into its center).  ``spmm``
gives (operations, bytes) of one call from the real rows and edges it
aggregates, as ``counts.gin_conv`` counts the fused conv: an add a real edge
and feature (and a row and feature for the row itself), every input row
read once, every output row written once, the adjacency as a CSR index
(``counts._csr``), whatever layout and band width implement it.

Which calls a step made is the program's to say: while a profiler session
is open each replayed step keeps, as the arguments of its
``scgib.step.tally`` span, the launches and branches of that replay and
the band width of each batch (``scgib_tpu_torch/train/trainer.py``).  A
program that keeps no such arguments gives None here.
"""

from __future__ import annotations

import fnmatch
from typing import Dict, List, Optional

from . import counts, spans
from .trace import short

TALLY = "scgib.step.tally"
PATTERNS = ("banded_spmm_kernel*",)
LAUNCHES = ("launch.spmm_self", "launch.spmm", "launch.pool")


def spmm(rows: int, edges: int, d: int, add_self: bool = False):
    """(operations, bytes) of A x (+ x) over ``rows`` real rows of width
    ``d`` and their ``edges``."""
    ops = edges * d + (rows * d if add_self else 0)
    nbytes = 2 * counts.F32 * rows * d + counts._csr(rows, edges)
    return float(ops), float(nbytes)


def pool(sub_rows: int, centers: int, d: int):
    """(operations, bytes) of the pooling: ``sub_rows`` rows of width ``d``
    summed into ``centers`` rows, one entry a sub-row."""
    ops = sub_rows * d
    nbytes = (counts.F32 * (sub_rows + centers) * d
              + counts._csr(centers, sub_rows))
    return float(ops), float(nbytes)


def tallies(run) -> Optional[List[Dict[str, object]]]:
    """The tally arguments of the run's replayed steps in the traced
    stretch, in order; None where there are none, or the program keeps no
    branch counts there."""
    found = spans.calls(run)
    if not found:
        return None
    out = [dict(p[TALLY].args) if TALLY in p else {} for _, p in found]
    if not all(any(k.startswith(("encoder.", "pool.", "recon."))
                   for k in t) for t in out):
        return None
    return out


def _calls(cfg: dict, st: counts.Stats, tally: Dict[str, object]):
    """The (operations, bytes) of each banded SpMM call of one GIN
    pretraining step, from its tally; None where the tally's launches are
    not the calls counted here."""
    d, dt, layers = cfg["hidden"], cfg["d_transfer"], cfg["num_layers"]
    widths = tuple(tally.get("band_widths", ()))
    banded = [rows_edges for w, rows_edges in
              zip(widths, ((st.n, st.e), (st.s, st.q))) if w]
    out = []
    fused = tally.get("encoder.band", 0)
    unfused = tally.get("encoder.band_spmm", 0)
    if fused + unfused != layers * len(banded):
        return None
    for rows, edges in banded:
        for i in range(layers):
            din = dt if i == 0 else d
            if fused:
                out.append(spmm(rows, edges, din, add_self=True))
            else:
                out += [spmm(rows, edges, din)] * 2
    out += [spmm(st.n, st.e, d)] * (2 * tally.get("recon.band", 0))
    out += [pool(st.s, st.n, d)] * tally.get("pool.banded", 0)
    if len(out) != sum(tally.get(k, 0) for k in LAUNCHES):
        return None
    return out


def roofline(run) -> Optional[float]:
    """100 x the least seconds of the traced steps' banded SpMM calls (at
    ``peaks.json``'s float32 rate and bandwidth) over the device seconds
    of ``banded_spmm_kernel``; None where the program keeps no tally, the
    tally is not a GIN step's or no such kernel ran."""
    found = tallies(run)
    stats = getattr(run.driver, "traced_stats", None)
    cfg = run.cfg
    if found is None or not stats or len(stats) != len(found) \
            or cfg["encoder"] != "GIN":
        return None
    flops = run.peaks["flops_per_s"][cfg["precision"]]
    bw = run.peaks["bytes_per_s"]
    least = 0.0
    for st, tally in zip(stats, found):
        calls = _calls(cfg, st, tally)
        if calls is None:
            return None
        least += sum(counts.least_seconds(o, b, flops, bw)[0]
                     for o, b in calls)
    spent = run.trace.seconds_of(
        lambda name: any(fnmatch.fnmatch(short(name), p) for p in PATTERNS))
    if spent <= 0:
        return None
    return 100.0 * least / spent
