"""The plain reference against the port's CPU path at a small size, both
configurations and fine-tuning: the first step's losses and gradient entry
by entry, the cells' numbers within their limits, and the first
evaluation's scores."""

import statistics

import pytest

from port_bench import check, drivers, run
from port_bench.tests.small import CELLS, LOOPS, load, small


def _driver(config, traffic, seed, **over):
    d = drivers.make(config, {**traffic, "warmup_epochs": 1,
                              "warmup_cycles": 1, **over}, seed, "cpu")
    d.warm_up()
    d.release()
    return d


@pytest.mark.parametrize("config,traffic", LOOPS)
def test_first_step_entry_by_entry(config, traffic):
    d = _driver(*load(config, traffic), 2 ** 31 + 101, checked_steps=1)
    prog, ref = check.program_record(d), check.reference_record(d)
    for p, r in zip(prog["losses"][0], ref["losses"][0]):
        assert abs(p - r) <= 2e-6 * abs(r)
    norms = {n: float(g.norm()) for n, g in ref["first_grad"].items()}
    med = statistics.median(norms.values())
    for n, g in ref["first_grad"].items():
        diff = float((prog["first_grad"][n].double() - g).norm())
        # float32 against float64: a BatchNorm over a feature of small
        # variance amplifies round-off (8e-4 of a leaf seen on the CPU)
        assert diff <= 5e-3 * max(norms[n], med), n


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [7, 2 ** 32 + 9])
def test_three_steps_within_the_cells_limits(cell, seed):
    _, _, config, traffic = run.cell_spec(cell)
    nums = check.numbers(_driver(config, small(traffic), seed))
    lim = check.limits(cell)
    assert set(nums) == set(lim)
    assert all(nums[k] <= lim[k] for k in lim), (nums, lim)


def test_first_evaluation_scores():
    d = _driver(*load("scgib-gin64", "bace-finetune"), 31)
    assert check.eval_gap(d) <= 1e-6
