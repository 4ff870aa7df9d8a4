"""The fused GIN conv's plain version (what ``gin_fwd`` computes for a CPU
tensor) against the JAX package on the inputs of ``gin_cases.py``: ragged
widths (din, hid, dout), band widths 128, 256 and 1024, an empty tile and a
repeated edge.  ``banded.py::_kernel`` runs in Pallas TPU interpret mode;
``gin_banded_layer_reference`` is its XLA form.  The card tests hold the
CUDA kernel against the same plain version on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scgib_tpu.ops.pallas import banded as jkb
from scgib_tpu_torch.ops.kernels import banded as kb

from gin_cases import CASES, EMPTY_TILE, REPEATED, case_inputs

TOL = dict(rtol=1e-5, atol=1e-5)   # float32 on both sides; sums in another
                                   # order


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    """(JAX operands, the port's output through the CPU wrapper) of a case;
    the wrapper takes the plain version and counts no launch."""
    blocks, off, arrays = case_inputs(request.param)
    kb.reset_launch_counts()
    out = kb.gin_fwd(blocks, off, *map(torch.from_numpy, arrays))
    assert kb.launch_counts()["gin_fwd"] == 0
    jargs = (jnp.asarray(blocks.float().numpy()).astype(jnp.bfloat16),
             jnp.asarray(off.numpy().astype(np.int32)),
             *map(jnp.asarray, arrays))
    return jargs, out.numpy()


def test_gin_fwd_plain_matches_pallas_kernel(run):
    jargs, out = run
    with pltpu.force_tpu_interpret_mode():
        want = jkb.gin_banded_layer(*jargs)
    np.testing.assert_allclose(out, np.asarray(want), **TOL)


def test_gin_fwd_plain_matches_xla_reference(run):
    jargs, out = run
    np.testing.assert_allclose(
        out, np.asarray(jkb.gin_banded_layer_reference(*jargs)), **TOL)


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][5]])
def test_edge_cases_hold_what_they_claim(case):
    blocks, off, arrays = case_inputs(case)
    width = CASES[case][3]
    row, col = REPEATED
    assert float(blocks[EMPTY_TILE].abs().max()) == 0.0
    assert float(blocks[0, row, col]) == 2.0
    assert int(off.max()) + width <= arrays[0].shape[0]
    assert not bool((off % 64).any())
