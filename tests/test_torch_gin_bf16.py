"""The fused GIN conv's bf16 mode: its single-rounding controls against the
JAX kernel, and the route its wrapper takes.

``gin_rounding`` builds, for each rounding point of ``gin_fwd_bf16`` (z0
before the product with W1, relu(z1) before the product with W2), the plain
version with that rounding alone left out.  On ``separating_inputs`` each
control lies 1/32 of the largest entry from the plain version, and JAX's
``_kernel`` in its bf16 mode (Pallas TPU interpret mode) lies on the plain
version and past the card's gate (1e-3) from each control: the gate that
phase 13 (a) of ``chip_smoke.py`` and the card tests apply can fail a kernel
that skips either rounding.  ``gin_route`` is held to the widths alone.

Light on purpose: the whole file takes ~6 s on one CPU worker (the JAX
kernel's interpret-mode compile dominates); the heavier bf16 tests are in
``test_torch_bf16.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scgib_tpu.ops.pallas import banded as jkb

from scgib_tpu_torch.ops.kernels import banded as kb
from scgib_tpu_torch.utils import counters

import gin_rounding

GATE = 1e-3               # chip_smoke.py's BF16_RTOL
SAME_POINTS = 1e-5        # both sides round at the same points


def jax_kernel(blocks, off, h, w1, b1, w2, b2):
    """JAX's ``_kernel`` in its bf16 mode on the same values, interpret
    mode, as a float32 tensor."""
    bf = jnp.bfloat16

    def j(x, dtype=jnp.float32):
        return jnp.asarray(x.float().numpy()).astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        out = jkb.gin_banded_layer(
            j(blocks, bf), jnp.asarray(off.numpy().astype(np.int32)),
            j(h, bf), j(w1, bf), j(b1), j(w2, bf), j(b2))
    return torch.from_numpy(np.array(out))


@pytest.mark.parametrize("din", [9, 16])
def test_controls_separate_and_the_jax_kernel_rounds_at_both_points(din):
    """On the crafted inputs: the plain version is the JAX kernel (to
    1e-5), each control lies at least twice the gate from it, and the JAX
    kernel lies past the gate from each: it rounds at both points, as the
    port's kernels must.  ~2 s a width."""
    ins = gin_rounding.separating_inputs(din, 16, 16)
    plain = kb.gin_fwd_bf16_plain(*ins)
    want = jax_kernel(*ins)
    top = float(want.abs().max())
    assert float((plain - want).abs().max()) <= SAME_POINTS * top
    assert torch.equal(gin_rounding.forward_without(None, *ins), plain)
    records = gin_rounding.controls(want, ins, GATE)
    for point, (apart, kernel_apart, separated) in records.items():
        assert separated and apart == pytest.approx(1 / 32), (point, records)
        assert kernel_apart > GATE, (point, records)
    assert not gin_rounding.unseen(records, GATE)
    # the controls are the plain version without one rounding each: a
    # "kernel" that skips one is caught
    for point in gin_rounding.POINTS:
        skipped = gin_rounding.forward_without(point, *ins)
        assert gin_rounding.unseen(
            gin_rounding.controls(skipped, ins, GATE), GATE) == [point]


def test_controls_leave_random_inputs_at_the_plain_version():
    """On random inputs every control lies within a few bf16 half-steps of
    the plain version, and the sound "control" is the plain version bit for
    bit.  ~0.1 s."""
    rng = np.random.default_rng(3)
    blocks, off, *_ = gin_rounding.separating_inputs(9, 16, 16)
    h = torch.from_numpy(rng.normal(size=(256, 9)).astype(np.float32))
    w1 = torch.from_numpy(rng.normal(size=(9, 16)).astype(np.float32) / 3)
    w2 = torch.from_numpy(rng.normal(size=(16, 16)).astype(np.float32) / 4)
    b1, b2 = (torch.from_numpy(rng.normal(size=16).astype(np.float32) * 0.1)
              for _ in range(2))
    bf = torch.bfloat16
    ins = (blocks, off, h.to(bf), w1.to(bf), b1, w2.to(bf), b2)
    plain = kb.gin_fwd_bf16_plain(*ins)
    assert torch.equal(gin_rounding.forward_without(None, *ins), plain)
    records = gin_rounding.controls(plain, ins, GATE)
    for apart, kernel_apart, _ in records.values():
        assert 0 < apart == kernel_apart < 2 ** -6


# widths -> (VEC, NT) of the instantiation csrc/banded.cu's plan_fwd_bf16
# launches: 8 values a lane where din is a multiple of 8, 4 output tiles a
# warp past width 64
ROUTE_PLANS = {(1, 1, 1): (1, 2), (9, 64, 64): (1, 2), (16, 16, 16): (8, 2),
               (64, 64, 64): (8, 2), (128, 128, 128): (8, 4),
               (33, 33, 33): (1, 2), (9, 33, 128): (1, 4),
               (128, 1, 7): (8, 4), (8, 65, 8): (8, 4)}


@pytest.mark.parametrize("widths", list(ROUTE_PLANS))
def test_gin_route_takes_the_bf16_smem_kernel_at_every_width(widths):
    """Every width the conv takes, odd ones and the atoms' 9 among them, goes
    to an instantiation of ``gin_fused_fwd_bf16_kernel``, the one
    ``plan_fwd_bf16`` picks; the route is a function of the widths alone
    (the same in any order of calls, and for ints of any origin).  ~0.01
    s a case."""
    route = kb.gin_route(*widths)
    vec, nt = ROUTE_PLANS[widths]
    assert route == f"gin_fused_fwd_bf16_kernel<{vec}, 32, {nt}>"
    assert kb.gin_route(*(np.int64(w) for w in widths)) == route
    for other in ((1, 1, 1), (128, 128, 128), widths):
        kb.gin_route(*other)
        assert kb.gin_route(*widths) == route


@pytest.mark.parametrize("widths", [(0, 64, 64), (64, 129, 64),
                                    (64, 64, 256)])
def test_gin_route_refuses_widths_the_conv_does_not_take(widths):
    """No route for a width the fused conv does not take.  ~0.01 s."""
    with pytest.raises(ValueError, match="gin_route"):
        kb.gin_route(*widths)


def test_gin_fwd_bf16_on_cpu_counts_no_launch_on_any_route():
    """On a CPU tensor the wrapper is its plain version: no launch.  ~0.05
    s."""
    ins = gin_rounding.separating_inputs(16, 16, 16)
    counters.reset("launch")
    out = kb.gin_fwd_bf16(*ins)
    assert torch.equal(out, kb.gin_fwd_bf16_plain(*ins))
    assert counters.of("launch", kb.KERNELS) == dict.fromkeys(kb.KERNELS, 0)
