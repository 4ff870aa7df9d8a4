"""The rounding points of the fused GIN conv's bf16 mode, and one control for
each: the plain forward with that single rounding left out.

``gin_fwd_bf16`` rounds two intermediates to bf16 before a product, as the
JAX package's ``_kernel`` does in its bf16 mode: z0 = h + A h before the
product with W1, and relu(z0 W1 + b1) before the product with W2.  A gate
that holds the kernel to its plain version catches a kernel that skips one
of them only where that rounding moves the output by more than the gate.
For each point ``controls`` gives the control's distance from the sound
plain version and the kernel's distance from the control; where the first
is at least twice the gate, the kernel must lie past the gate from the
control (``separated``), as in ``gt_rounding``.  Shared by the CPU tests
against the JAX kernel (``test_torch_gin_bf16.py``), the card tests
(``test_torch_cuda.py``) and ``chip_smoke.py``: torch and the port only.

On random inputs a rounding moves an entry by at most half a bf16 step
(2^-9 relative) of the terms it enters, and those mostly cancel in the
next product, so such inputs may leave a control within the gate of 1e-3.
``separating_inputs`` builds inputs where each control lies far from the
plain version: each output entry is one or two exact terms, and each
rounded value a quarter step from a rounding midpoint.
"""

import numpy as np
import torch

from scgib_tpu_torch.graph import banded
from scgib_tpu_torch.ops.spmm_banded import _banded_spmm_impl

POINTS = ("z0", "relu(z1)")
ULP = 2.0 ** -7               # bf16's step at 1


def forward_without(point, blocks, col_off, h, w1, b1, w2, b2):
    """The bf16 conv's output, rounded where ``gin_fwd_bf16_plain`` rounds
    but at ``point`` (one of ``POINTS``; None: every rounding, the plain
    version's own result).  h, w1 and w2 bfloat16 (or already rounded),
    the sums in b1's dtype."""
    def rnd(x, name):
        return x if name == point else x.to(torch.bfloat16).to(x.dtype)

    ct = b1.dtype
    h, w1, w2 = h.to(ct), w1.to(ct), w2.to(ct)
    z0 = _banded_spmm_impl(blocks, col_off, h) + h
    return rnd(torch.relu(rnd(z0, "z0") @ w1 + b1), "relu(z1)") @ w2 + b2


def controls(got, inputs, gate):
    """{point: (control's distance from the sound plain version, the kernel
    output ``got``'s distance from the control, whether the point is
    separated)}, every distance relative to the sound plain version's
    largest entry.  ``inputs``: (blocks, col_off, h, w1, b1, w2, b2)."""
    sound = forward_without(None, *inputs)
    top = float(sound.abs().max())
    out = {}
    for point in POINTS:
        ctl = forward_without(point, *inputs)
        apart = float((ctl - sound).abs().max()) / top
        kernel_apart = float((got.to(ctl.dtype) - ctl).abs().max()) / top
        out[point] = (apart, kernel_apart, apart >= 2 * gate)
    return out


def unseen(records, gate):
    """The separated points whose control the kernel is within ``gate``
    of: a kernel that skipped that rounding would pass."""
    return [p for p, (_, kernel_apart, sep) in records.items()
            if sep and not kernel_apart > gate]


def separating_inputs(din, hid, dout, n=256):
    """(blocks, col_off, h, w1, b1, w2, b2) at which both controls lie far
    from the plain version: h, w1 and w2 bfloat16, b1 and b2 float32, on
    the CPU.  Row i's only neighbour is i ^ 1 (tiles of 128, band 256), and
    h_a = (1, 1, 0, ...) on even rows, (2^-9, 0, ...) on odd ones, so z0 =
    (1 + 2^-9, 1, 0, ...) on every row: z0's first entry a quarter step
    above 1, rounded to 1.  z1 = (z0_0 - z0_1, z0_1 + 2^-9, z0_1, 0, ...)
    (b1 = 2^-9 on unit 1): its first entry 0 where z0 was rounded and 2^-9
    where not, its second 1 + 2^-9, rounded to 1.  out = (r_0, r_1 - r_2,
    0, ...) + 1/16 for r = relu(z1): 1/16 where both roundings were made,
    2^-9 more where one was not, 1/32 of the largest entry.  Every sum is
    exact in float32.  Needs din >= 2, hid >= 3, dout >= 2."""
    if din < 2 or hid < 3 or dout < 2:
        raise ValueError("separating_inputs needs din >= 2, hid >= 3 and "
                         "dout >= 2")
    rows = np.arange(n, dtype=np.int32)
    b = banded.pack_banded(rows ^ 1, rows, None, n, tile=128, band=256,
                           align=64)
    h = np.zeros((n, din), np.float32)
    h[0::2, :2] = 1.0
    h[1::2, 0] = ULP / 4
    w1 = np.zeros((din, hid), np.float32)
    w1[0, 0], w1[1, 0] = 1.0, -1.0
    w1[1, 1] = w1[1, 2] = 1.0
    b1 = np.zeros(hid, np.float32)
    b1[1] = ULP / 4
    w2 = np.zeros((hid, dout), np.float32)
    w2[0, 0] = w2[1, 1] = 1.0
    w2[2, 1] = -1.0
    b2 = np.full(dout, 1.0 / 16, np.float32)
    bf = torch.bfloat16
    return (torch.from_numpy(b.blocks).to(bf),
            torch.from_numpy(b.col_off.astype(np.int64)),
            torch.from_numpy(h).to(bf), torch.from_numpy(w1).to(bf),
            torch.from_numpy(b1), torch.from_numpy(w2).to(bf),
            torch.from_numpy(b2))
