"""Graph-transformer banded attention: CUDA wrappers, plain versions, autograd.

Counterpart of ``scgib_tpu/ops/pallas/gt_flash.py``.  Four wrappers stand
for its four Pallas kernels, each served by its own CUDA kernel in
``csrc/gt_flash.cu``:

  wrapper        TPU kernel it replaces    computes
  gt_fwd         _fwd_kernel               out, z
  gt_bwd_rows    _bwd_rows_kernel          dq, rho        (two-pass, rows)
  gt_bwd_cols    _bwd_cols_kernel          dk, dv         (two-pass, columns)
  gt_bwd_merged  _bwd_merged_kernel        dq, dk, dv     (one pass, atomics)

Each wrapper takes its plain PyTorch version (``*_plain``) for a CPU tensor and
launches its kernel for a CUDA tensor, counting each launch that succeeded on
its ``launches`` attribute; anything else raises.  The kernels compute in
float32 and take any banded geometry [T, tile, band] with band a multiple of 32
up to 256 (the narrow (64, 128) and the wide (128, 256) ones) and a head width
hd in ``HEAD_WIDTHS`` (powers of two up to 512) or a multiple of ``SWEEP``
(512) past it, swept 512 features at a time (``takes_head_width``).  The plain
versions compute in their inputs' dtype.  Each takes the score scale, 1 /
sqrt(hd) by default.

Every kernel reads a row's features as 16-byte vectors, a group of lanes
per row with all its heads, and finds the gate's nonzeros by warp ballot.
So they do not take H * hd that is not a multiple of 4, nor blocks that do
not start on a 16-byte boundary: both raise.  A feature operand off a
16-byte boundary (a slice of a fused qkv, say) is copied first.

``gt_flash_attention`` is the autograd function: the forward, then the
two-pass backward (rows, then columns; no atomics, so bitwise the same in
every run) or, with ``bwd="merged"``, the single pass (the JAX package's
default, selected there by ``SCGIB_GT_BWD_TWOPASS``).  It takes any head
width with either backward, as the JAX package does: a width the kernels
do not take is
zero-padded up to ``served_head_width``, with the scale kept at 1 /
sqrt(hd), which changes no score and no gradient.  See
``csrc/gt_flash.cu`` for what bounds the kernels on an H100 and how the
design answers it.
"""

from __future__ import annotations

import ctypes
import re

import torch

from ..spmm_banded import gt_scores, gt_windows
from .banded import ALIGN, _dispatch, _ptr, _raise_on, _stream
from .build import load, ptxas_report as _ptxas_report

KERNELS = ("gt_fwd", "gt_bwd_rows", "gt_bwd_cols", "gt_bwd_merged")
HEAD_WIDTHS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
# Past the widest of HEAD_WIDTHS the kernels take every multiple of SWEEP,
# a head swept SWEEP features at a time (csrc/gt_flash.cu's WIDE).
SWEEP = 512
MAX_BAND = 256
BWD = ("twopass", "merged")

_lib = None


def build() -> ctypes.CDLL:
    """Compile ``csrc/gt_flash.cu`` for sm_90a (once per source hash, see
    ``build.py``) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib, = load("gt_flash")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    geo = [P, P, I, I, I]                   # blocks, col_off, T, tile, band
    lib.scgib_gt_fwd.argtypes = geo + [P, P, P, I, I, F, F, F, P, P, P]
    lib.scgib_gt_bwd_rows.argtypes = geo + [P, P, P, P, P, I, I, F, F, F,
                                            P, P, P]
    lib.scgib_gt_bwd_cols.argtypes = geo + [P, P, P, P, P, P, I, I, F, F,
                                            F, P, P, P]
    lib.scgib_gt_bwd_merged.argtypes = geo + [P, P, P, P, P, I, I, F, F, F,
                                              P, P, P, P]
    lib.scgib_gt_kernel_info.argtypes = [I, I, P]
    for fn in (lib.scgib_gt_fwd, lib.scgib_gt_bwd_rows,
               lib.scgib_gt_bwd_cols, lib.scgib_gt_bwd_merged,
               lib.scgib_gt_kernel_info):
        fn.restype = ctypes.c_int
    _check_head_widths(lib)
    _lib = lib
    return lib


def takes_head_width(hd: int) -> bool:
    """Whether the kernels take head width ``hd`` as it is: one of
    ``HEAD_WIDTHS``, or a multiple of ``SWEEP`` past it."""
    return hd in HEAD_WIDTHS or (hd > SWEEP and hd % SWEEP == 0)


def _check_head_widths(lib):
    """``takes_head_width`` must say what the source's dispatch
    (``SCGIB_DISPATCH_HD``) takes, up to 4 sweeps: ``scgib_gt_kernel_info``
    fails for any other width."""
    info = (ctypes.c_int * 3)()
    widths = range(1, 4 * SWEEP + 1)
    want = tuple(hd for hd in widths if takes_head_width(hd))
    for which in range(4):
        taken = tuple(hd for hd in widths
                      if lib.scgib_gt_kernel_info(which, hd, info) == 0)
        if taken != want:
            raise RuntimeError(f"csrc/gt_flash.cu takes head widths {taken}, "
                               f"the wrapper states {want}")


def _scale(hd: int) -> float:
    return 1.0 / float(hd) ** 0.5


def served_head_width(num_heads: int, hd: int) -> int:
    """The head width the kernels run a head of width ``hd`` at: the
    smallest they take that is at least ``hd`` and gives a multiple of 4
    features a row (past ``SWEEP``, the next multiple of ``SWEEP``)."""
    for width in HEAD_WIDTHS:
        if width >= hd and (num_heads * width) % 4 == 0:
            return width
    return -(-hd // SWEEP) * SWEEP


# --- plain versions ----------------------------------------------------------

def _per_tile(x, n_tiles, tile):
    """[N, H] -> [T, H, tile]."""
    return x.reshape(n_tiles, tile, -1).permute(0, 2, 1)


def _per_row(x):
    """[T, H, tile] -> [N, H]."""
    return x.permute(0, 2, 1).reshape(-1, x.shape[1])


def _backward_entries(blocks, col_off, q, k, v, g, z, rho, clamp, eps,
                      scale):
    """(W, dS, rho) per entry; rho [T, H, tile] is the row sums of G * W,
    computed when ``rho`` is None."""
    n_tiles, tile, band = blocks.shape
    _, num_heads, hd = q.shape
    s, e = gt_scores(blocks, col_off, q, k, clamp, scale)
    inv = (1.0 / (_per_tile(z, n_tiles, tile) + eps))[..., None]
    w = e * inv
    G = torch.einsum("tihd,tjhd->thij",
                     g.reshape(n_tiles, tile, num_heads, hd),
                     gt_windows(col_off, band, v))
    rho = (G * w).sum(-1) if rho is None else _per_tile(rho, n_tiles, tile)
    inside = ((s >= -clamp) & (s <= clamp)).to(s.dtype)
    ds = e * inside * (G - rho[..., None]) * inv
    return w, ds, rho


def _add_windows(col_off, win, n):
    """Sum [T, band, H, hd] window contributions into [N, H, hd]."""
    idx = col_off[:, None] + torch.arange(win.shape[1], device=win.device)
    out = torch.zeros((n,) + tuple(win.shape[2:]), dtype=win.dtype,
                      device=win.device)
    return out.index_add_(0, idx.reshape(-1), win.flatten(0, 1))


def gt_fwd_plain(blocks, col_off, q, k, v, clamp=5.0, eps=1e-6,
                 scale=None):
    """(out [N, H, hd], z [N, H])."""
    band = blocks.shape[2]
    _, e = gt_scores(blocks, col_off, q, k, clamp, scale)
    z = e.sum(-1)                                        # [T, H, tile]
    w = e / (z + eps)[..., None]
    out = torch.einsum("thij,tjhd->tihd", w, gt_windows(col_off, band, v))
    return out.reshape(q.shape), _per_row(z)


def gt_bwd_rows_plain(blocks, col_off, q, k, v, g, z, clamp=5.0, eps=1e-6,
                      scale=None):
    """(dq [N, H, hd], rho [N, H])."""
    band = blocks.shape[2]
    scale = _scale(q.shape[2]) if scale is None else scale
    _, ds, rho = _backward_entries(blocks, col_off, q, k, v, g, z, None,
                                   clamp, eps, scale)
    dq = torch.einsum("thij,tjhd->tihd", ds, gt_windows(col_off, band, k))
    return dq.reshape(q.shape) * scale, _per_row(rho)


def gt_bwd_cols_plain(blocks, col_off, q, k, v, g, z, rho, clamp=5.0,
                      eps=1e-6, scale=None):
    """(dk, dv) [N, H, hd] from the row pass's z and rho."""
    n_tiles, tile, _ = blocks.shape
    n, num_heads, hd = q.shape
    scale = _scale(hd) if scale is None else scale
    w, ds, _ = _backward_entries(blocks, col_off, q, k, v, g, z, rho, clamp,
                                 eps, scale)
    q_t = q.reshape(n_tiles, tile, num_heads, hd)
    g_t = g.reshape(n_tiles, tile, num_heads, hd)
    dk = _add_windows(col_off, torch.einsum("thij,tihd->tjhd", ds, q_t), n)
    dv = _add_windows(col_off, torch.einsum("thij,tihd->tjhd", w, g_t), n)
    return dk * scale, dv


def gt_bwd_merged_plain(blocks, col_off, q, k, v, g, z, clamp=5.0, eps=1e-6,
                        scale=None):
    """(dq, dk, dv) [N, H, hd] in one pass."""
    dq, rho = gt_bwd_rows_plain(blocks, col_off, q, k, v, g, z, clamp, eps,
                                scale)
    return (dq,) + gt_bwd_cols_plain(blocks, col_off, q, k, v, g, z, rho,
                                     clamp, eps, scale)


# --- wrappers ----------------------------------------------------------------

def _gt_args(name, blocks, col_off, q, *others):
    """Validate the operands; returns (blocks, col_off int64, (T, tile,
    band), H, hd, [q, *others]), all contiguous.  ``others`` are [N, H, hd]
    or [N, H] float32; hd one ``takes_head_width``.  The kernels read blocks
    and the feature rows in 16-byte vectors, so H * hd must be a multiple
    of 4 and blocks 16-byte aligned; a feature operand that is not is
    copied."""
    if blocks.dim() != 3 or blocks.dtype != torch.bfloat16:
        raise TypeError(f"{name}: blocks must be bfloat16 [T, tile, band]")
    n_tiles, tile, band = blocks.shape
    if band % 32 != 0 or band > MAX_BAND:
        raise ValueError(f"{name}: band must be a multiple of 32 up to "
                         f"{MAX_BAND}, got {band}")
    if q.dim() != 3 or q.shape[0] != n_tiles * tile or q.shape[0] < band:
        raise ValueError(f"{name}: q must be [T*tile >= band, H, hd], got "
                         f"{tuple(q.shape)} for blocks {tuple(blocks.shape)}")
    n, num_heads, hd = q.shape
    if not takes_head_width(hd):
        raise ValueError(f"{name}: head width {hd} is neither in "
                         f"{HEAD_WIDTHS} nor a multiple of {SWEEP}")
    if col_off.shape != (n_tiles,):
        raise ValueError(f"{name}: col_off must be [T]")
    for t in (q,) + others:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: features must be float32")
        if t.shape not in ((n, num_heads, hd), (n, num_heads)):
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} "
                             f"does not match q {tuple(q.shape)}")
    for t in (blocks, col_off, q) + others:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: operands must share one CUDA device")
    blocks = blocks.contiguous()
    if (num_heads * hd) % 4:
        raise ValueError(f"{name}: H * hd = {num_heads * hd} features a "
                         "row must be a multiple of 4")
    if blocks.data_ptr() % ALIGN:
        raise ValueError(f"{name}: blocks must be {ALIGN}-byte aligned")
    feats = [t.clone() if t.dim() == 3 and t.data_ptr() % ALIGN else t
             for t in (t.contiguous() for t in (q,) + others)]
    return (blocks, col_off.to(torch.int64).contiguous(),
            (n_tiles, tile, band), num_heads, hd, feats)


def _launch(fn, name, blocks, col_off, geo, tensors, num_heads, hd, clamp,
            eps, scale, outs):
    scale = _scale(hd) if scale is None else scale
    _raise_on(fn(_ptr(blocks), _ptr(col_off), *geo,
                 *(_ptr(t) for t in tensors), num_heads, hd, scale, clamp,
                 eps, *(_ptr(t) for t in outs), _stream()), name)


def gt_fwd(blocks, col_off, q, k, v, clamp=5.0, eps=1e-6, scale=None):
    """(out, z) (replaces ``_fwd_kernel``)."""
    if not _dispatch("gt_fwd", q):
        return gt_fwd_plain(blocks, col_off, q, k, v, clamp, eps, scale)
    blocks, col_off, geo, num_heads, hd, ts = _gt_args(
        "gt_fwd", blocks, col_off, q, k, v)
    out = torch.empty_like(ts[0])
    z = torch.empty(ts[0].shape[:2], dtype=torch.float32, device=q.device)
    _launch(build().scgib_gt_fwd, "gt_fwd", blocks, col_off, geo, ts,
            num_heads, hd, clamp, eps, scale, (out, z))
    gt_fwd.launches += 1
    return out, z


def gt_bwd_rows(blocks, col_off, q, k, v, g, z, clamp=5.0, eps=1e-6,
                scale=None):
    """(dq, rho) (replaces ``_bwd_rows_kernel``)."""
    if not _dispatch("gt_bwd_rows", q):
        return gt_bwd_rows_plain(blocks, col_off, q, k, v, g, z, clamp, eps,
                                 scale)
    blocks, col_off, geo, num_heads, hd, ts = _gt_args(
        "gt_bwd_rows", blocks, col_off, q, k, v, g, z)
    dq = torch.empty_like(ts[0])
    rho = torch.empty_like(ts[4])
    _launch(build().scgib_gt_bwd_rows, "gt_bwd_rows", blocks, col_off, geo,
            ts, num_heads, hd, clamp, eps, scale, (dq, rho))
    gt_bwd_rows.launches += 1
    return dq, rho


def gt_bwd_cols(blocks, col_off, q, k, v, g, z, rho, clamp=5.0, eps=1e-6,
                scale=None):
    """(dk, dv) (replaces ``_bwd_cols_kernel``).  Needs a symmetric A."""
    if not _dispatch("gt_bwd_cols", q):
        return gt_bwd_cols_plain(blocks, col_off, q, k, v, g, z, rho, clamp,
                                 eps, scale)
    blocks, col_off, geo, num_heads, hd, ts = _gt_args(
        "gt_bwd_cols", blocks, col_off, q, k, v, g, z, rho)
    dk = torch.empty_like(ts[0])
    dv = torch.empty_like(ts[0])
    _launch(build().scgib_gt_bwd_cols, "gt_bwd_cols", blocks, col_off, geo,
            ts, num_heads, hd, clamp, eps, scale, (dk, dv))
    gt_bwd_cols.launches += 1
    return dk, dv


def gt_bwd_merged(blocks, col_off, q, k, v, g, z, clamp=5.0, eps=1e-6,
                  scale=None):
    """(dq, dk, dv) in one pass (replaces ``_bwd_merged_kernel``); dk and
    dv are summed with atomics, so their last bits vary between runs."""
    if not _dispatch("gt_bwd_merged", q):
        return gt_bwd_merged_plain(blocks, col_off, q, k, v, g, z, clamp,
                                   eps, scale)
    blocks, col_off, geo, num_heads, hd, ts = _gt_args(
        "gt_bwd_merged", blocks, col_off, q, k, v, g, z)
    dq = torch.empty_like(ts[0])
    dk = torch.zeros_like(ts[0])
    dv = torch.zeros_like(ts[0])
    _launch(build().scgib_gt_bwd_merged, "gt_bwd_merged", blocks, col_off,
            geo, ts, num_heads, hd, clamp, eps, scale, (dq, dk, dv))
    gt_bwd_merged.launches += 1
    return dq, dk, dv


def kernel_info(kernel: str, hd: int) -> dict:
    """Registers a thread, shared memory a block and blocks an SM of the
    kernel that ``gt_bwd_rows``, ``gt_bwd_cols``, ``gt_fwd`` or
    ``gt_bwd_merged`` launches at head width ``hd``."""
    info = (ctypes.c_int * 3)()
    _raise_on(build().scgib_gt_kernel_info(
        {"gt_bwd_rows": 0, "gt_bwd_cols": 1, "gt_fwd": 2,
         "gt_bwd_merged": 3}[kernel], hd, info), kernel)
    return {"registers": info[0], "smem_bytes": info[1],
            "blocks_per_sm": info[2]}


def ptxas_report() -> dict:
    """ptxas's ``registers``, ``spill_stores`` and ``spill_loads`` (bytes)
    of every instantiation, by (wrapper, head width); head width 0 is the
    WIDE instantiation, which every multiple of ``SWEEP`` past it runs."""
    build()
    out = {}
    for entry, rec in _ptxas_report("gt_flash").items():
        m = re.search(r"(gt_fwd|gt_row_pass|gt_bwd_cols)_kernelILi(\d+)E"
                      r"(Lb1E)?", entry)
        if m:
            name = {"gt_fwd": "gt_fwd", "gt_bwd_cols": "gt_bwd_cols",
                    "gt_row_pass": "gt_bwd_merged" if m.group(3)
                    else "gt_bwd_rows"}[m.group(1)]
            out[name, int(m.group(2))] = rec
    return out


def launch_counts() -> dict:
    return {name: globals()[name].launches for name in KERNELS}


def reset_launch_counts():
    for name in KERNELS:
        globals()[name].launches = 0


reset_launch_counts()


# --- autograd ---------------------------------------------------------------

class _GtFlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blocks, col_off, q, k, v, clamp, eps, bwd, scale):
        out, z = gt_fwd(blocks, col_off, q, k, v, clamp, eps, scale)
        ctx.save_for_backward(blocks, col_off, q, k, v, z)
        ctx.clamp, ctx.eps, ctx.bwd, ctx.scale = clamp, eps, bwd, scale
        return out

    @staticmethod
    def backward(ctx, g):
        blocks, col_off, q, k, v, z = ctx.saved_tensors
        args = (blocks, col_off, q, k, v, g.contiguous(), z)
        consts = (ctx.clamp, ctx.eps, ctx.scale)
        if ctx.bwd == "merged":
            dq, dk, dv = gt_bwd_merged(*args, *consts)
        else:
            dq, rho = gt_bwd_rows(*args, *consts)
            dk, dv = gt_bwd_cols(*args, rho, *consts)
        return None, None, dq, dk, dv, None, None, None, None


def gt_flash_attention(blocks, col_off, q, k, v, clamp: float = 5.0,
                       eps: float = 1e-6, bwd: str = "twopass"):
    """Graph-transformer banded attention, q/k/v [N, H, hd] -> [N, H, hd]
    (the semantics of ``spmm_banded.gt_banded_attention``) with the kernel
    backward: ``bwd`` is "twopass" (rows then columns) or "merged".  The
    column pass and the merged pass need a symmetric A.  A head width the
    kernels do not take runs zero-padded to ``served_head_width``: the zero
    features add nothing to a score, their outputs are dropped, and the
    scale stays 1 / sqrt(hd)."""
    if bwd not in BWD:
        raise ValueError(f"bwd must be one of {BWD}, got {bwd!r}")
    num_heads, hd = q.shape[1:]
    width = served_head_width(num_heads, hd)
    if width == hd:
        return _GtFlashAttention.apply(blocks, col_off, q, k, v, clamp, eps,
                                       bwd, None)
    q, k, v = (torch.nn.functional.pad(t, (0, width - hd)) for t in (q, k, v))
    out = _GtFlashAttention.apply(blocks, col_off, q, k, v, clamp, eps, bwd,
                                  _scale(hd))
    return out[..., :hd]
