"""The GIN layer's masked BatchNorm -> ReLU -> row mask as one operation,
``masked_bn_relu``: CUDA wrappers, plain versions, autograd.

No Pallas kernel stands behind it: on the TPU, XLA fused the JAX package's
``MaskedBatchNorm`` and the relu and row mask after it.  In the port the
composed code (``models/layers.py::MaskedBatchNorm.forward``, then relu and
``_mask_rows``) dispatched ~60 kernels a call, forward and backward, which
is what a GIN step's CUDA graph was mostly made of.  Four CUDA kernels in
``csrc/batchnorm.cu`` take their place:

  wrapper         what it computes
  bn_stats        S1 = sum x, S2 = sum x^2 over the kept rows, and their
                  count: totals [S1 | S2 | count], float64 [2F + 1]
  bn_apply        y = relu(x a + c) m, with a = scale rsqrt(var + eps),
                  c = bias - mean a from the totals (train) or the running
                  statistics (eval); the running statistics moved unless
                  ``update`` is off; stats [a, c, mean, rsqrt, clamp passed]
  bn_grad_stats   g = dy m [x a + c > 0]: dscale, dbias, and dS1, dS2, the
                  per-column terms of dx
  bn_grad_apply   dx = g a + m (dS1 + 2 x dS2)

Each wrapper takes its plain PyTorch version (``*_plain``: the same
formulas, sums in float64) for a CPU tensor and launches its kernel for a
CUDA tensor, counting each launch that succeeded (kind ``launch`` in
``utils/counters.py``); anything else raises, a feature tensor that is not
float32 included.  The kernels are built from ``csrc/batchnorm.cu`` with
``nvcc`` at first use (``build.py``) and loaded with ``ctypes``.

``masked_bn_relu`` is the autograd function over the four.  With a sync-BN
``group`` the totals are all-reduced between ``bn_stats`` and
``bn_apply``, and dS1 and dS2 between ``bn_grad_stats`` and
``bn_grad_apply``: what autograd all-reduces through the composed code's
``all_reduce_sum``; dscale and dbias stay the rank's own.  The statistics
are exactly the composed code's one-pass moments, taken in float64; padding
rows come out 0, and a non-finite value in a padding row stays out of the
sums (the composed code's ``x * m`` would carry a NaN into them).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...parallel.collectives import all_reduce_sum
from ...utils import counters
from .build import library, on_card, ptr, raise_on, stream

KERNELS = ("bn_stats", "bn_apply", "bn_grad_stats", "bn_grad_apply")
STATS = ("a", "c", "mean", "rsqrt", "passed")   # rows of ``stats``


def build() -> ctypes.CDLL:
    """Compile ``csrc/batchnorm.cu`` for sm_90a (once per source hash, see
    ``build.py``) and load it."""
    return library("batchnorm", bind)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Give a library built from ``csrc/batchnorm.cu`` its entries'
    argument and return types."""
    P, I, L, D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_double)
    lib.scgib_bn_partials.argtypes = [L, I, P]
    lib.scgib_bn_stats.argtypes = [P, P, L, I, P, P, P]
    lib.scgib_bn_apply.argtypes = [P, P, L, I, P, P, P, P, P, I, D, D, P, P,
                                   P]
    lib.scgib_bn_grad_stats.argtypes = [P, P, P, L, I, P, P, P, P, P, P, P,
                                        P]
    lib.scgib_bn_grad_apply.argtypes = [P, P, P, L, I, P, P, P, P]
    lib.scgib_bn_kernel_info.argtypes = [I, L, I, P]
    for fn in (lib.scgib_bn_partials, lib.scgib_bn_stats, lib.scgib_bn_apply,
               lib.scgib_bn_grad_stats, lib.scgib_bn_grad_apply,
               lib.scgib_bn_kernel_info):
        fn.restype = ctypes.c_int
    return lib


def _rows(x: torch.Tensor, name: str) -> torch.Tensor:
    """x as the kernels read it: float32 [n, F] rows, contiguous, 16-byte
    aligned (copied where a view starts off the boundary)."""
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"{name}: features must be [n, F], got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: features must be float32, got {x.dtype}")
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _mask(mask, x, name):
    """The row mask as one byte a row (None: every row kept)."""
    if mask is None:
        return None
    if mask.shape != (x.shape[0],) or mask.device != x.device:
        raise ValueError(f"{name}: mask must be [n] on the features' device")
    return (mask if mask.dtype == torch.bool else mask != 0).contiguous()


def _vector(t, f, name, what):
    if t.shape != (f,) or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous float32 [{f}]")
    return t


@functools.lru_cache(maxsize=None)
def _partials(n: int, f: int) -> int:
    doubles = ctypes.c_longlong(0)
    raise_on(build().scgib_bn_partials(n, f, ctypes.byref(doubles)),
             "bn_partials")
    return doubles.value


# --- plain versions (the kernels' formulas; sums in float64) ----------------

def _kept(x, mask):
    return (torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
            if mask is None else mask.to(torch.bool))


def bn_stats_plain(x, mask):
    keep = _kept(x, mask)[:, None]
    xd = torch.where(keep, x.double(), 0.0)
    return torch.cat([xd.sum(0), (xd * xd).sum(0),
                      keep.sum().double()[None]])


def bn_apply_plain(x, mask, totals, scale, bias, run_mean, run_var,
                   update=False, momentum=0.1, eps=1e-5):
    """(y, stats): y in x's dtype; a and c rounded to x's dtype, as the
    kernel keeps them, the rest of ``stats`` from float64."""
    f = x.shape[1]
    if totals is not None:
        count = totals[2 * f].clamp_min(1.0)
        mean = totals[:f] / count
        v0 = totals[f:2 * f] / count - mean * mean
        passed = (v0 >= 0).double()
        var = v0.clamp_min(0.0)
        if update:
            with torch.no_grad():
                unbiased = var * count / (count - 1.0).clamp_min(1.0)
                run_mean.copy_((1 - momentum) * run_mean.double()
                               + momentum * mean)
                run_var.copy_((1 - momentum) * run_var.double()
                              + momentum * unbiased)
    else:
        mean, var = run_mean.double(), run_var.double()
        passed = torch.ones_like(mean)
    r = 1.0 / torch.sqrt(var + eps)
    a = scale.double() * r
    c = bias.double() - mean * a
    a, c = a.to(x.dtype), c.to(x.dtype)
    z = x * a + c
    y = torch.where(_kept(x, mask)[:, None] & (z > 0), z, 0.0)
    return y, torch.stack([a, c, mean.to(x.dtype), r.to(x.dtype),
                           passed.to(x.dtype)])


def _gated(dy, x, mask, stats):
    a, c = stats[0], stats[1]
    return torch.where(_kept(x, mask)[:, None] & (x * a + c > 0), dy, 0.0)


def bn_grad_stats_plain(dy, x, mask, stats, totals, scale):
    """(dscale, dbias, terms [dS1 | dS2]) in x's dtype."""
    f = x.shape[1]
    g = _gated(dy, x, mask, stats).double()
    sg, sgx = g.sum(0), (g * x.double()).sum(0)
    a, _, mean, r, passed = stats.double()
    da = sgx - mean * sg
    terms = torch.zeros(2 * f, dtype=torch.float64, device=x.device)
    if totals is not None:
        count = totals[2 * f].clamp_min(1.0)
        dvar = torch.where(passed != 0, -0.5 * da * scale.double() * r ** 3,
                           0.0)
        terms = torch.cat([(-a * sg - 2.0 * mean * dvar) / count,
                           dvar / count])
    return tuple(t.to(x.dtype) for t in (da * r, sg, terms))


def bn_grad_apply_plain(dy, x, mask, stats, terms):
    f = x.shape[1]
    keep = _kept(x, mask)[:, None]
    g = _gated(dy, x, mask, stats)
    return g * stats[0] + torch.where(keep, terms[:f] + 2 * x * terms[f:],
                                      0.0)


# --- the kernels ------------------------------------------------------------

def bn_stats(x, mask):
    """Kernel 1: totals [S1 | S2 | count], float64 [2F + 1]."""
    if not on_card("bn_stats", x):
        return bn_stats_plain(x, mask)
    x = _rows(x, "bn_stats")
    mask = _mask(mask, x, "bn_stats")
    n, f = x.shape
    part = torch.empty(_partials(n, f), dtype=torch.float64, device=x.device)
    totals = torch.empty(2 * f + 1, dtype=torch.float64, device=x.device)
    raise_on(build().scgib_bn_stats(ptr(x), ptr(mask), n, f, ptr(part),
                                    ptr(totals), stream()), "bn_stats")
    counters.tick("launch", "bn_stats")
    return totals


def bn_apply(x, mask, totals, scale, bias, run_mean, run_var, update=False,
             momentum=0.1, eps=1e-5):
    """Kernel 2: (y, stats [5, F]); ``totals`` None is eval mode.  With
    ``update`` the running statistics move in place."""
    if not on_card("bn_apply", x):
        return bn_apply_plain(x, mask, totals, scale, bias, run_mean,
                              run_var, update, momentum, eps)
    x = _rows(x, "bn_apply")
    mask = _mask(mask, x, "bn_apply")
    n, f = x.shape
    for t, what in ((scale, "scale"), (bias, "bias"), (run_mean, "mean"),
                    (run_var, "var")):
        _vector(t, f, "bn_apply", what)
    if totals is not None and totals.shape != (2 * f + 1,):
        raise ValueError(f"bn_apply: totals must be [{2 * f + 1}]")
    y = torch.empty_like(x)
    stats = torch.empty((len(STATS), f), dtype=torch.float32,
                        device=x.device)
    update = int(bool(update and totals is not None))
    raise_on(build().scgib_bn_apply(
        ptr(x), ptr(mask), n, f, ptr(totals), ptr(scale), ptr(bias),
        ptr(run_mean), ptr(run_var), update, momentum, eps, ptr(y),
        ptr(stats), stream()), "bn_apply")
    counters.tick("launch", "bn_apply")
    return y, stats


def bn_grad_stats(dy, x, mask, stats, totals, scale):
    """Kernel 3: (dscale, dbias, terms [dS1 | dS2]); ``totals`` None is
    eval mode (terms 0)."""
    if not on_card("bn_grad_stats", x):
        return bn_grad_stats_plain(dy, x, mask, stats, totals, scale)
    x, dy = _rows(x, "bn_grad_stats"), _rows(dy, "bn_grad_stats")
    mask = _mask(mask, x, "bn_grad_stats")
    n, f = x.shape
    part = torch.empty(_partials(n, f), dtype=torch.float64, device=x.device)
    out = torch.empty(4 * f, dtype=torch.float32, device=x.device)
    dscale, dbias, terms = out.split((f, f, 2 * f))
    raise_on(build().scgib_bn_grad_stats(
        ptr(dy), ptr(x), ptr(mask), n, f, ptr(stats), ptr(totals),
        ptr(scale), ptr(part), ptr(dscale), ptr(dbias), ptr(terms),
        stream()), "bn_grad_stats")
    counters.tick("launch", "bn_grad_stats")
    return dscale, dbias, terms


def bn_grad_apply(dy, x, mask, stats, terms):
    """Kernel 4: dx."""
    if not on_card("bn_grad_apply", x):
        return bn_grad_apply_plain(dy, x, mask, stats, terms)
    x, dy = _rows(x, "bn_grad_apply"), _rows(dy, "bn_grad_apply")
    mask = _mask(mask, x, "bn_grad_apply")
    n, f = x.shape
    terms = terms.contiguous()
    dx = torch.empty_like(x)
    raise_on(build().scgib_bn_grad_apply(
        ptr(dy), ptr(x), ptr(mask), n, f, ptr(stats), ptr(terms),
        ptr(dx), stream()), "bn_grad_apply")
    counters.tick("launch", "bn_grad_apply")
    return dx


def kernel_info(kernel: str, n: int, f: int) -> dict:
    """Registers a thread, static shared memory a block, blocks an SM and
    the grid of the kernel (one of ``KERNELS``) at n rows of width f."""
    info = (ctypes.c_int * 5)()
    raise_on(build().scgib_bn_kernel_info(KERNELS.index(kernel), n, f,
                                          info), kernel)
    return {"registers": info[0], "smem_bytes": info[1],
            "blocks_per_sm": info[2], "grid": [info[3], info[4]]}


# --- autograd ---------------------------------------------------------------

class _MaskedBnRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, scale, bias, run_mean, run_var, training,
                update, momentum, eps, group):
        totals = None
        if training:
            totals = bn_stats(x, mask)
            if group is not None:
                totals = all_reduce_sum(totals, group)
        y, stats = bn_apply(x, mask, totals, scale, bias, run_mean, run_var,
                            update, momentum, eps)
        ctx.save_for_backward(x, mask, scale, stats, totals)
        ctx.group = group
        return y

    @staticmethod
    def backward(ctx, dy):
        """The composed code's gradient: dscale and dbias the rank's own;
        dx's column terms summed over the group, as the backward of its
        ``all_reduce_sum`` sums them (where x takes a gradient, as
        there)."""
        x, mask, scale, stats, totals = ctx.saved_tensors
        dscale, dbias, terms = bn_grad_stats(dy, x, mask, stats, totals,
                                             scale)
        dx = None
        if ctx.needs_input_grad[0]:
            if ctx.group is not None and totals is not None:
                terms = all_reduce_sum(terms, ctx.group)
            dx = bn_grad_apply(dy, x, mask, stats, terms)
        return (dx, None, dscale if ctx.needs_input_grad[2] else None,
                dbias if ctx.needs_input_grad[3] else None,
                None, None, None, None, None, None, None)


def masked_bn_relu(x, mask, scale, bias, run_mean, run_var, *,
                   training: bool, update: bool = True,
                   momentum: float = 0.1, eps: float = 1e-5, group=None):
    """relu(BatchNorm(x) over the rows ``mask`` keeps) with those rows
    zeroed, as ``MaskedBatchNorm.forward`` then relu and the row mask:
    ``training`` takes the batch's statistics (moving the running ones in
    place where ``update``), else the running ones; ``group`` is sync-BN's
    process group."""
    return _MaskedBnRelu.apply(x, mask, scale, bias, run_mean, run_var,
                               training, update and training, momentum,
                               eps, group)
