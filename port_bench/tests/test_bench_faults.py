"""A whole run of each cell (the harness's look for a card skipped, on the
CPU at a small size) comes out correct, and with each fault planted under
the timed path comes out not correct: the optimizer's state left
unchanged, half of each batch left out, an answer altered where it is
produced.  The cells run on one chip, so no exchange between chips can be
left out."""

import json

import pytest

from port_bench import drivers, faults, run
from port_bench.tests.small import CELLS, small


def _run(cell, capsys, monkeypatch, fault=None):
    if fault:
        make = drivers.make

        def broken(*args, **kwargs):
            d = make(*args, **kwargs)
            faults.PLANTED[fault](d)
            return d
        monkeypatch.setattr(drivers, "make", broken)
    _, _, _, traffic = run.cell_spec(cell)
    over = {**small(traffic), "warmup_epochs": 1, "warmup_cycles": 1}
    code = run.main(["--workload", cell, "--seed", str(2 ** 31 + 77),
                     "--seconds", "0.5", "--trace", "0"], device="cpu",
                    traffic_overrides=over)
    assert code == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, capsys, monkeypatch):
    res = _run(cell, capsys, monkeypatch)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and "setup_s" in res["metrics"]


@pytest.mark.parametrize("fault", sorted(faults.PLANTED))
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault, capsys, monkeypatch):
    res = _run(cell, capsys, monkeypatch, fault)
    assert not res["correct"], res["checks"]
