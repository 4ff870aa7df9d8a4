"""``banded_spmm.py`` against hand counts on tiny shapes, and its reader on
hand-built spans: the tally's arguments read back (None where the program
keeps none, as a program before the band was sized from the data), the
calls a step's tally names, and the roofline's arithmetic."""

import types

import pytest

from port_bench import banded_spmm, trace
from port_bench.counts import Stats
from scgib_tpu_torch.utils import profiling
from scgib_tpu_torch.utils.profiling import STEP_PARTS, Span

MS = 1_000_000                                   # ns
CFG = {"encoder": "GIN", "hidden": 4, "d_transfer": 2, "num_layers": 2,
       "precision": "float32"}
WIDE = {"launch.gin_fwd": 4, "launch.gin_bwd": 4, "launch.spmm_self": 4,
        "launch.spmm": 2, "launch.pool": 1, "encoder.band": 4,
        "pool.banded": 1, "recon.band": 1, "band_widths": (512, 384)}
COO = {"encoder.coo": 4, "pool.banded": 1, "recon.coo": 1,
       "launch.pool": 1, "band_widths": (0, 0)}


def test_spmm_by_hand():
    # 3 rows, 4 edges, width 2: an add an edge and feature (+ the row's own)
    assert banded_spmm.spmm(3, 4, 2) == (4 * 2, 2 * 4 * 3 * 2
                                         + 4 * (4 + 3 + 1))
    assert banded_spmm.spmm(3, 4, 2, add_self=True) == (
        4 * 2 + 3 * 2, 2 * 4 * 3 * 2 + 4 * (4 + 3 + 1))
    # 5 sub-rows into 2 centers, width 3: one entry a sub-row
    assert banded_spmm.pool(5, 2, 3) == (5 * 3, 4 * (5 + 2) * 3
                                         + 4 * (5 + 2 + 1))


def test_a_steps_calls_from_its_tally():
    st = Stats(n=10, e=20, s=30, q=40, g=2)
    calls = banded_spmm._calls(CFG, st, WIDE)
    # the backward's x + A x of each conv (d_transfer, then hidden), on
    # the atoms then the ego-nets; the reconstruction's two; the pool
    assert calls == [banded_spmm.spmm(10, 20, 2, True),
                     banded_spmm.spmm(10, 20, 4, True),
                     banded_spmm.spmm(30, 40, 2, True),
                     banded_spmm.spmm(30, 40, 4, True),
                     banded_spmm.spmm(10, 20, 4), banded_spmm.spmm(10, 20, 4),
                     banded_spmm.pool(30, 10, 4)]
    # the ego-nets on COO: their two convs' products leave; the launches
    # then name more calls than the tally's branches do
    half = {**WIDE, "encoder.band": 2, "encoder.coo": 2,
            "band_widths": (512, 0)}
    assert banded_spmm._calls(CFG, st, half) is None
    assert len(banded_spmm._calls(
        CFG, st, {**half, "launch.spmm_self": 2})) == 5
    assert banded_spmm._calls(CFG, st, COO) == [banded_spmm.pool(30, 10, 4)]


def _call(step, start, tally):
    """A replayed step call's spans from ``start`` ms (6 ms in all), its
    tally part carrying ``tally``."""
    at = start * MS
    out = [Span("scgib.step", at, at + 6 * MS, step, None,
                {"kind": "replay"})]
    counts = {"scgib.step.inputs": {"copies": 15, "bytes": 4096},
              "scgib.step.tally": tally,
              "scgib.step.outputs": {"clones": 3}}
    for name, n in zip(STEP_PARTS, (1, 1, 2, 1, 1)):
        out.append(Span(name, at, at + n * MS, step, "scgib.step",
                        dict(counts.get(name, {}))))
        at += n * MS
    return out


def _run(monkeypatch, tallies, device=(), stats=None):
    spans = [s for i, t in enumerate(tallies)
             for s in _call(i + 1, 10 * (i + 1), t)]
    monkeypatch.setattr(profiling, "spans_between", lambda a, b: spans)
    tr = trace.Trace((0, 100 * MS), [(n, a * MS, b * MS)
                                     for n, a, b in device], [])
    return types.SimpleNamespace(
        trace=tr, cfg=CFG, peaks={"flops_per_s": {"float32": 1e6},
                                  "bytes_per_s": 1e6},
        driver=types.SimpleNamespace(traced_stats=stats))


def test_tallies_read_back(monkeypatch):
    # each replay's arguments, in order; 0 COO aggregations on the wide
    # band, the COO branches where a batch has no band (width 0)
    assert banded_spmm.tallies(_run(monkeypatch, [WIDE, COO])) == [WIDE,
                                                                   COO]
    # a program that keeps no such arguments, and no trace at all
    assert banded_spmm.tallies(_run(monkeypatch, [{}, {}])) is None
    assert banded_spmm.tallies(types.SimpleNamespace(trace=None)) is None


def test_roofline_of_the_named_calls(monkeypatch):
    st = Stats(n=10, e=20, s=30, q=40, g=2)
    device = [("banded_spmm_kernel<4>(...)", 11, 14),
              ("gin_fused_fwd_kernel<16, 32, 2>(...)", 20, 30),
              ("banded_spmm_kernel<1>(...)", 21, 22)]
    run = _run(monkeypatch, [WIDE, WIDE], device, [st, st])
    least = 2 * sum(max(o / 1e6, b / 1e6)
                    for o, b in banded_spmm._calls(CFG, st, WIDE))
    assert banded_spmm.roofline(run) == pytest.approx(
        100 * least / (4 * MS * 1e-9))
    # no tally (an older program), or steps that do not match the stats
    assert banded_spmm.roofline(
        _run(monkeypatch, [{}, {}], device, [st, st])) is None
    assert banded_spmm.roofline(
        _run(monkeypatch, [WIDE], device, [st, st])) is None
    # no such kernel in the trace
    assert banded_spmm.roofline(
        _run(monkeypatch, [WIDE, WIDE], device[1:2], [st, st])) is None
