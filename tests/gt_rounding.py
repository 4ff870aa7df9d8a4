"""The rounding points of the attention's bf16-dot backward, and one control
for each: the plain backward with that single rounding left out.

A gate that holds a bf16 kernel to its plain version can only catch a
kernel that skips one rounding if that rounding moves the outputs by more
than the gate.  The whole float32 form is one control; these are the finer
ones.  For each rounding point of a kernel, ``controls`` gives the
control's distance from the sound plain version and the kernel's distance
from the control; where the first is at least twice the gate, the kernel
must lie past the gate from the control (``separated``).  Shared by the
CPU tests against the JAX kernels (``test_torch_bf16.py``), the card tests
(``test_torch_cuda.py``) and ``chip_smoke.py``: torch and the port only.
"""

import torch

from scgib_tpu_torch.ops.spmm_banded import gt_scores, gt_windows

# every rounding of the bf16-dot backward: the operands loaded (each
# rounded once, in every product it takes part in), and the three
# intermediates rounded before a product
POINTS = ("q", "k", "v", "g", "dS before dq", "dS before dk", "w before dv")
# each backward kernel's outputs and its rounding points
KERNELS = {"rows": (("dq", "rho"), ("q", "k", "v", "g", "dS before dq")),
           "cols": (("dk", "dv"),
                    ("q", "k", "v", "g", "dS before dk", "w before dv")),
           "merged": (("dq", "dk", "dv"), POINTS)}


def backward_without(point, blocks, col_off, q, k, v, g, z, rho=None,
                     clamp=5.0, eps=1e-6):
    """{"dq", "rho", "dk", "dv"} of the bf16-dot backward, rounded where
    ``gt_bwd_rows_plain`` and ``gt_bwd_cols_plain`` round but at ``point``
    (one of ``POINTS``; None: every rounding, the plain versions' own
    results).  ``rho``: the column pass's input, else the row sums of this
    backward's G * W."""
    def rnd(x, name):
        return x if name == point else x.to(torch.bfloat16).to(x.dtype)

    n_tiles, tile, band = blocks.shape
    n, heads, hd = q.shape
    scale = 1.0 / float(hd) ** 0.5
    qr, kr, vr, gr = rnd(q, "q"), rnd(k, "k"), rnd(v, "v"), rnd(g, "g")
    s, e = gt_scores(blocks, col_off, qr, kr, clamp, scale)
    inv = (1.0 / (z.reshape(n_tiles, tile, heads).permute(0, 2, 1) + eps)
           )[..., None]
    w = e * inv
    G = torch.einsum("tihd,tjhd->thij", gr.reshape(n_tiles, tile, heads, hd),
                     gt_windows(col_off, band, vr))
    rows_rho = (G * w).sum(-1)
    r = (rows_rho if rho is None
         else rho.reshape(n_tiles, tile, heads).permute(0, 2, 1))
    inside = ((s >= -clamp) & (s <= clamp)).to(s.dtype)
    ds = e * inside * (G - r[..., None]) * inv
    dq = torch.einsum("thij,tjhd->tihd", rnd(ds, "dS before dq"),
                      gt_windows(col_off, band, kr)).reshape(q.shape) * scale
    idx = (col_off[:, None] + torch.arange(band, device=q.device)).reshape(-1)

    def add_windows(win):
        out = torch.zeros_like(q)
        return out.index_add_(0, idx, win.flatten(0, 1))
    dk = add_windows(torch.einsum(
        "thij,tihd->tjhd", rnd(ds, "dS before dk"),
        qr.reshape(n_tiles, tile, heads, hd))) * scale
    dv = add_windows(torch.einsum(
        "thij,tihd->tjhd", rnd(w, "w before dv"),
        gr.reshape(n_tiles, tile, heads, hd)))
    return {"dq": dq, "rho": rows_rho.permute(0, 2, 1).reshape(n, heads),
            "dk": dk, "dv": dv}


def rel_gap(got, want):
    """The largest error over outputs, each relative to its largest entry
    in ``want``."""
    return max(float((a - b).abs().max()) / float(b.abs().max())
               for a, b in zip(got, want))


def controls(kernel, got, inputs, gate, rho=None):
    """{point: (control's distance from the sound plain version, the
    kernel outputs' ``got`` distance from the control, whether the point
    is separated)} over ``kernel``'s rounding points (``KERNELS``), every
    distance relative to the sound plain version's largest entries, over
    the first ``len(got)`` of the kernel's outputs.
    ``inputs``: (blocks, col_off, q, k, v, g, z); ``rho``: the column
    pass's input."""
    names, points = KERNELS[kernel]
    names = names[:len(got)]          # a kernel checked on its first outputs
    sound = backward_without(None, *inputs, rho=rho)
    out = {}
    for point in points:
        ctl = backward_without(point, *inputs, rho=rho)
        scale = [float(sound[x].abs().max()) for x in names]
        apart = max(float((ctl[x] - sound[x]).abs().max()) / m
                    for x, m in zip(names, scale))
        kernel_apart = max(float((a - ctl[x]).abs().max()) / m
                           for a, x, m in zip(got, names, scale))
        out[point] = (apart, kernel_apart, apart >= 2 * gate)
    return out


def unseen(records, gate):
    """The separated points whose control the kernel is within ``gate``
    of: a kernel that skipped that rounding would pass."""
    return [p for p, (_, kernel_apart, sep) in records.items()
            if sep and not kernel_apart > gate]
