"""The control: the reference in float32 with every product on TF32
operands, put in the program's place, is not correct under the cells'
limits (each cell's numbers against the float64 reference, at a small
size on the CPU)."""

import pytest

from port_bench import check, drivers, run
from port_bench.reference import model as M
from port_bench.tests.small import CELLS, small


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    _, _, config, traffic = run.cell_spec(cell)
    d = drivers.make(config, {**small(traffic), "warmup_epochs": 1,
                              "warmup_cycles": 1}, 2 ** 31 + 55, "cpu")
    d.warm_up()
    d.release()
    nums = check.gaps(check.reference_record(d, M.TF32),
                      check.reference_record(d), d.weights)
    lim = check.limits(cell)
    assert any(nums[k] > lim[k] for k in nums), (nums, lim)
