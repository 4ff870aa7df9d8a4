"""The rounding points of the attention's bf16-dot kernels, and one control
for each: the plain forward or backward with that single rounding left out.

A gate that holds a bf16 kernel to its plain version can only catch a
kernel that skips one rounding if that rounding moves the outputs by more
than the gate.  The whole float32 form is one control; these are the finer
ones.  For each rounding point of a kernel, ``controls`` gives the
control's distance from the sound plain version and the kernel's distance
from the control; where the first is at least twice the gate, the kernel
must lie past the gate from the control (``separated``).  Shared by the
CPU tests against the JAX kernels (``test_torch_bf16.py``), the card tests
(``test_torch_cuda.py``) and ``chip_smoke.py``: torch and the port only.

On random inputs a rounding of an operand moves an output by at most one
bf16 half-step (2^-9) of the terms it enters, so at a gate of 1e-3 no such
input separates v and w before out (forward), nor w before dv; dS before
dk not at one head of 64.  ``separating_inputs`` builds inputs where those
controls lie far from the plain version: each row attends to itself and
one partner, each output entry is the difference of two near-equal exact
terms, and the operands whose rounding is held sit a quarter step or more
from a rounding midpoint.
"""

import math

import numpy as np
import torch

from scgib_tpu_torch.graph import banded
from scgib_tpu_torch.ops.spmm_banded import gt_scores, gt_windows

# every rounding of the bf16-dot backward: the operands loaded (each
# rounded once, in every product it takes part in), and the three
# intermediates rounded before a product
POINTS = ("q", "k", "v", "g", "dS before dq", "dS before dk", "w before dv")
# the forward's: q, k and v, and w = e / (z + eps) before its product with v
FWD_POINTS = ("q", "k", "v", "w before out")
# each kernel's outputs and its rounding points
KERNELS = {"fwd": (("out", "z"), FWD_POINTS),
           "rows": (("dq", "rho"), ("q", "k", "v", "g", "dS before dq")),
           "cols": (("dk", "dv"),
                    ("q", "k", "v", "g", "dS before dk", "w before dv")),
           "merged": (("dq", "dk", "dv"), POINTS)}


def _rounder(point):
    def rnd(x, name):
        return x if name == point else x.to(torch.bfloat16).to(x.dtype)
    return rnd


def forward_without(point, blocks, col_off, q, k, v, clamp=5.0, eps=1e-6):
    """{"out", "z"} of the bf16-dot forward, rounded where ``gt_fwd_plain``
    rounds but at ``point`` (one of ``FWD_POINTS``; None: every rounding,
    the plain version's own results)."""
    rnd = _rounder(point)
    n_tiles, tile, band = blocks.shape
    n, heads, hd = q.shape
    _, e = gt_scores(blocks, col_off, rnd(q, "q"), rnd(k, "k"), clamp)
    z = e.sum(-1)
    w = rnd(e * (1.0 / (z + eps))[..., None], "w before out")
    out = torch.einsum("thij,tjhd->tihd", w,
                       gt_windows(col_off, band, rnd(v, "v")))
    return {"out": out.reshape(q.shape),
            "z": z.permute(0, 2, 1).reshape(n, heads)}


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
    ``inputs``: (blocks, col_off, q, k, v) for the forward, (blocks,
    col_off, q, k, v, g, z) for a backward kernel; ``rho``: the column
    pass's input."""
    names, points = KERNELS[kernel]
    names = names[:len(got)]          # a kernel checked on its first outputs

    def without(point):
        if kernel == "fwd":
            return forward_without(point, *inputs)
        return backward_without(point, *inputs, rho=rho)
    sound = without(None)
    out = {}
    for point in points:
        ctl = without(point)
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


# separating_inputs: the score of a row with itself, SIGMA, puts w = e / (z +
# eps) of the row's two entries at about 0.5015 and 0.4985, each well
# inside one bf16 step (0.5015 rounds down to 0.5, 0.4985 to 0.498047);
# ULP is bf16's step at 1.
SIGMA = 0.006
ULP = 2.0 ** -7


def pairs_gate(n=256, tile=64, band=128):
    """(blocks, col_off) of n rows in the geometry (tile, band), row i
    attending to itself and to its partner i ^ 1."""
    rows = np.arange(n, dtype=np.int32)
    send = np.concatenate([rows, rows ^ 1]).astype(np.int32)
    recv = np.concatenate([rows, rows]).astype(np.int32)
    b = banded.pack_banded(send, recv, None, n, tile=tile, band=band,
                           align=8)
    return (torch.from_numpy(b.blocks).to(torch.bfloat16),
            torch.from_numpy(b.col_off.astype(np.int64)))


def _dS_payload():
    """G_aa = g_a . v_a, which sets the dS entries that column a's dk sums,
    dS_aa = w1 (1 - w1) G_aa and dS_ba = -(1 + ULP) w2 (1 - w2) G_aa (w1,
    w2 the self and partner entries' w, taken in float64): about 1.5 + ULP
    / 4 and -(1.5 + 1.75 ULP), a quarter step from a bf16 value on either
    side, so that rounding them moves their sum by half a step."""
    e = math.exp(SIGMA)
    w1 = e / (e + 1.0 + 1e-6)
    return (1.5 + ULP / 4) / (w1 * (1.0 - w1))


def separating_inputs(kernel, heads, hd, n=256):
    """Inputs at which the controls that random inputs leave unseparated lie
    far from the plain version: for ``kernel`` "fwd" (blocks, col_off, q,
    k, v) separating v and w before out, else (blocks, col_off, q, k, v, g)
    separating w before dv and dS before dk.  On ``pairs_gate``, per head:
    q_a = x e0, k_a = e0 and q_b = x e1, k_b = e1 for a row a and its
    partner b (x = SIGMA sqrt(hd), so s_aa = s_bb = SIGMA and s_ab = s_ba =
    0); every other operand exact in bf16 but the forward's v: v_a = 1 + 0.3
    ULP, v_b = -(1 + 0.7 ULP) (rounded to 1 and -(1 + ULP)), so out_a is a
    difference of two near-equal terms.  Backward: g_a = 1, g_b = -(1 +
    ULP) for dv; v_a on features 2 and 3 sets dS (``_dS_payload``) and q's
    features 2 .. hd - 1 are 1, where k is 0, so dk_a there is the
    difference of the pair's two dS entries.  Needs hd >= 4.  float32,
    on the CPU."""
    if hd < 4:
        raise ValueError("separating_inputs needs a head width of 4 or more")
    blocks, col_off = pairs_gate(n)
    q = np.zeros((n, heads, hd), np.float32)
    k = np.zeros((n, heads, hd), np.float32)
    v = np.zeros((n, heads, hd), np.float32)
    g = np.zeros((n, heads, hd), np.float32)
    a, b = slice(0, n, 2), slice(1, n, 2)
    x = SIGMA * math.sqrt(hd)
    q[a, :, 0] = q[b, :, 1] = x
    k[a, :, 0] = k[b, :, 1] = 1.0
    if kernel == "fwd":
        v[a] = 1.0 + 0.3 * ULP
        v[b] = -(1.0 + 0.7 * ULP)
        return blocks, col_off, *(torch.from_numpy(t) for t in (q, k, v))
    g[a] = 1.0
    g[b] = -(1.0 + ULP)
    # G_aa as the sum of two bf16 values on features 2 and 3
    pay = _dS_payload()
    v[a, :, 2] = float(torch.tensor(pay).to(torch.bfloat16))
    v[a, :, 3] = float(torch.tensor(pay - v[0, 0, 2]).to(torch.bfloat16))
    q[:, :, 2:] = 1.0
    return blocks, col_off, *(torch.from_numpy(t) for t in (q, k, v, g))


# A float32 value rounded to bf16 lies this close (relative) to a midpoint
# between two bf16 values: two float32 computations of it that sum the same
# terms in another order may round it apart, one bf16 step.
TIE = 2.0 ** -14


def _tie_step(x):
    """Per entry of the unrounded float32 ``x``, the distance between the
    two bf16 values it may round to where it lies within ``TIE`` of their
    midpoint, else 0."""
    r = x.to(torch.bfloat16)
    mag = r.abs().view(torch.int16).to(torch.int32)
    up = x.abs() > r.to(x.dtype).abs()            # the other neighbour's side
    other = torch.where(up, mag + 1, mag - 1).clamp(min=0)
    other = other.to(torch.int16).view(torch.bfloat16).to(x.dtype)
    here = r.to(x.dtype).abs()
    mid = (here + other) / 2
    near = ((x.abs() - mid).abs() <= TIE * x.abs()) & (x != r.to(x.dtype))
    return torch.where(near, (other - here).abs(), torch.zeros_like(x))


def tie_slack(kernel, inputs, rho=None, clamp=5.0, eps=1e-6):
    """Per output of ``kernel`` (``KERNELS``' names and order), the most a
    kernel that rounds where the plain bf16 version rounds but sums in
    another float32 order may lie from it: one bf16 step of every term
    whose rounded factor (w, or dS) ties (``_tie_step``), times the term's
    other factor.  Zero where no term ties; the operands q, k, v, g are the
    same float32 values on both sides and round alike.  ``inputs`` as in
    ``controls``."""
    blocks, col_off, q, k, v = inputs[:5]
    n_tiles, tile, band = blocks.shape
    n, heads, hd = q.shape
    scale = 1.0 / float(hd) ** 0.5

    def rnd(x):
        return x.to(torch.bfloat16).to(x.dtype)

    def win(x):                 # the other factor's magnitude, by window
        return gt_windows(col_off, band, rnd(x).abs())

    def tile_rows(x):
        return rnd(x).abs().reshape(n_tiles, tile, heads, hd)

    def add_windows(w):
        idx = (col_off[:, None] + torch.arange(band, device=q.device))
        return torch.zeros_like(q).index_add_(0, idx.reshape(-1),
                                              w.flatten(0, 1))
    _, e = gt_scores(blocks, col_off, rnd(q), rnd(k), clamp)
    if kernel == "fwd":
        z = e.sum(-1)
        step = _tie_step(e * (1.0 / (z + eps))[..., None])
        out = torch.einsum("thij,tjhd->tihd", step, win(v))
        return out.reshape(q.shape), torch.zeros(n, heads, device=q.device)
    g, zin = inputs[5:7]
    inv = (1.0 / (zin.reshape(n_tiles, tile, heads).permute(0, 2, 1) + eps)
           )[..., None]
    s, _ = gt_scores(blocks, col_off, rnd(q), rnd(k), clamp)
    w = e * inv
    G = torch.einsum("tihd,tjhd->thij", rnd(g).reshape(n_tiles, tile, heads,
                                                      hd),
                     gt_windows(col_off, band, rnd(v)))
    r = ((G * w).sum(-1) if rho is None
         else rho.reshape(n_tiles, tile, heads).permute(0, 2, 1))
    inside = ((s >= -clamp) & (s <= clamp)).to(s.dtype)
    step_ds = _tie_step(e * inside * (G - r[..., None]) * inv)
    dq = torch.einsum("thij,tjhd->tihd", step_ds, win(k)).reshape(
        q.shape) * scale
    dk = add_windows(torch.einsum("thij,tihd->tjhd", step_ds,
                                  tile_rows(q))) * scale
    dv = add_windows(torch.einsum("thij,tihd->tjhd", _tie_step(w),
                                  tile_rows(g)))
    return {"rows": (dq, torch.zeros(n, heads, device=q.device)),
            "cols": (dk, dv), "merged": (dq, dk, dv)}[kernel]


def beyond_ties(got, want, slack):
    """The largest error over outputs past each entry's ``slack``, relative
    to the output's largest entry in ``want``; and the entries whose error
    needed their slack (past 1e-7 of the largest entry)."""
    worst, used = 0.0, 0
    for a, b, t in zip(got, want, slack):
        top = float(b.abs().max())
        d = (a - b).abs()
        worst = max(worst, float((d - t).clamp(min=0).max()) / top)
        used += int(((d > 1e-7 * top) & (t > 0) & (d > t * 0.5)).sum())
    return worst, used
