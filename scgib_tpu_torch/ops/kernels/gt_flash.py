"""Graph-transformer banded attention: CUDA wrappers, plain versions, autograd.

Counterpart of ``scgib_tpu/ops/pallas/gt_flash.py``.  Four wrappers stand
for its four Pallas kernels, each served by its own CUDA kernel in
``csrc/gt_flash.cu``:

  wrapper        TPU kernel it replaces    computes
  gt_fwd         _fwd_kernel               out, z
  gt_bwd_rows    _bwd_rows_kernel          dq, rho        (two-pass, rows)
  gt_bwd_cols    _bwd_cols_kernel          dk, dv         (two-pass, columns)
  gt_bwd_merged  _bwd_merged_kernel        dq, dk, dv     (one pass, atomics)

``bf16_dots`` (the JAX package's argument of that name, its default on a
TPU; here False by default): every wrapper then launches its kernel's
bf16-dot instantiation, which rounds both operands of every product to
bfloat16 and accumulates in float32 (the TPU's bf16 multiplicands), and
counts those launches as ``gt_fwd_bf16``, ``gt_bwd_rows_bf16``,
``gt_bwd_cols_bf16`` and ``gt_bwd_merged_bf16`` (kind ``launch`` in
``utils/counters.py``).
``gt_flash_attention(bwd="merged", bf16_dots=True)`` is the JAX package's
own configuration on a TPU (``_bwd_merged_kernel`` with ``bf16=True``).

Routes.  ``gt_fwd_bf16`` and ``gt_bwd_merged_bf16`` (rows 6b and 9b) have
two CUDA kernels each, and ``gt_route`` picks one from the shape before the
launch: the staged kernel (``gt_fwd_staged_bf16_kernel``,
``gt_bwd_merged_staged_bf16_kernel``: a block a row tile, or a part of its
heads, with the tile's window of k and v, its q (and g) rows and its gate
rows copied into shared memory) wherever a block's staged bytes fit its
shared memory, and the lane-group kernel of every other wrapper elsewhere
(wide heads, or the wide geometry at large widths).  Both routes count
their launches under the wrapper's name, and kind ``route`` splits them by
route, as (wrapper, route).  A launch failure on either raises.

Each wrapper takes its plain PyTorch version (``*_plain``) for a CPU tensor and
launches its kernel for a CUDA tensor, counting each launch that succeeded
(kind ``launch``); anything else raises.  The kernels compute in
float32 and take any banded geometry [T, tile, band] with band a multiple of 32
up to 256 (the narrow (64, 128) and the wide (128, 256) ones) and a head width
hd in ``HEAD_WIDTHS`` (powers of two up to 512) or a multiple of ``SWEEP``
(512) past it, swept 512 features at a time (``takes_head_width``).  The plain
versions compute in their inputs' dtype, rounding where the kernels round
with ``bf16_dots``.  Each takes the score scale, 1 / sqrt(hd) by default.

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
from typing import NamedTuple

import torch

from ...utils import counters
from ..spmm_banded import gt_scores, gt_windows
from .banded import ALIGN, _bf16
from .build import library, on_card, ptr, raise_on, stream
from .build import ptxas_report as _ptxas_report

# the wrappers, and their bf16-dot modes, by their launch counts' names
KERNELS = ("gt_fwd", "gt_bwd_rows", "gt_bwd_cols", "gt_bwd_merged",
           "gt_fwd_bf16", "gt_bwd_rows_bf16", "gt_bwd_cols_bf16",
           "gt_bwd_merged_bf16")
# kernel_info's and scgib_gt_kernel_info's index of each wrapper's kernel
_INFO = {"gt_bwd_rows": 0, "gt_bwd_cols": 1, "gt_fwd": 2, "gt_bwd_merged": 3,
         "gt_bwd_rows_bf16": 4, "gt_bwd_cols_bf16": 5, "gt_fwd_bf16": 6,
         "gt_bwd_merged_bf16": 7}
HEAD_WIDTHS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
# the wrappers with a staged route, scgib_gt_staged_info's index of each
STAGED = {"gt_fwd_bf16": 0, "gt_bwd_merged_bf16": 1}
STAGED_HEAD_WIDTHS = (1, 2, 4, 8, 16, 32, 64, 128)
ROUTES = ("staged", "lane_group")
# csrc/gt_flash.cu's STAGED_MAX_FEATURES, KEEP, SMEM_LIMIT; and how many
# parts a staged route splits a tile's heads into, at most
STAGED_MAX_FEATURES = 128
STAGED_MIN_FEATURES = 16
STAGED_MAX_SPLIT = 4
KEEP = 8
SMEM_LIMIT = 232448        # bytes of shared memory one block may take
SM_SMEM = 233472           # bytes of shared memory an SM has for blocks
BLOCK_RESERVE = 1024       # bytes the card reserves a block
# Past the widest of HEAD_WIDTHS the kernels take every multiple of SWEEP,
# a head swept SWEEP features at a time (csrc/gt_flash.cu's WIDE).
SWEEP = 512
MAX_BAND = 256
BWD = ("twopass", "merged")

def build() -> ctypes.CDLL:
    """Compile ``csrc/gt_flash.cu`` for sm_90a (once per source hash, see
    ``build.py``) and load it."""
    return library("gt_flash", bind)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Give a library built from ``csrc/gt_flash.cu`` its entries' argument
    and return types, and check its head widths against the wrapper's."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    geo = [P, P, I, I, I]                   # blocks, col_off, T, tile, band
    # ..., eps, bf16 (an int), outputs, stream
    lib.scgib_gt_fwd.argtypes = geo + [P, P, P, I, I, F, F, F, I, P, P, P]
    lib.scgib_gt_bwd_rows.argtypes = geo + [P, P, P, P, P, I, I, F, F, F, I,
                                            P, P, P]
    lib.scgib_gt_bwd_cols.argtypes = geo + [P, P, P, P, P, P, I, I, F, F,
                                            F, I, P, P, P]
    lib.scgib_gt_bwd_merged.argtypes = geo + [P, P, P, P, P, I, I, F, F, F,
                                              I, P, P, P, P]
    lib.scgib_gt_kernel_info.argtypes = [I, I, P]
    # ..., H, hd, split, threads, scale, clamp, eps, outputs (and the
    # forward's spill), stream
    lib.scgib_gt_fwd_staged.argtypes = geo + [P, P, P, I, I, I, I, F, F, F,
                                              P, P, P, P]
    lib.scgib_gt_bwd_merged_staged.argtypes = geo + [P, P, P, P, P, I, I, I,
                                                     I, F, F, F, P, P, P, P]
    lib.scgib_gt_staged_info.argtypes = [I, I, I, I, I, I, I, P]
    for fn in (lib.scgib_gt_fwd, lib.scgib_gt_bwd_rows,
               lib.scgib_gt_bwd_cols, lib.scgib_gt_bwd_merged,
               lib.scgib_gt_kernel_info, lib.scgib_gt_fwd_staged,
               lib.scgib_gt_bwd_merged_staged, lib.scgib_gt_staged_info):
        fn.restype = ctypes.c_int
    _check_head_widths(lib)
    return lib


def takes_head_width(hd: int) -> bool:
    """Whether the kernels take head width ``hd`` as it is: one of
    ``HEAD_WIDTHS``, or a multiple of ``SWEEP`` past it."""
    return hd in HEAD_WIDTHS or (hd > SWEEP and hd % SWEEP == 0)


def _check_head_widths(lib):
    """``takes_head_width`` must say what the source's dispatch
    (``SCGIB_DISPATCH_HD``) takes, up to 4 sweeps: ``scgib_gt_kernel_info``
    fails for any other width; and ``STAGED_HEAD_WIDTHS`` what the staged
    kernels' (``SCGIB_DISPATCH_STAGED_HD``) take, at the narrowest tile
    whose staged bytes fit at every one of them."""
    info = (ctypes.c_int * 3)()
    widths = range(1, 4 * SWEEP + 1)
    want = tuple(hd for hd in widths if takes_head_width(hd))
    for which in range(len(_INFO)):
        taken = tuple(hd for hd in widths
                      if lib.scgib_gt_kernel_info(which, hd, info) == 0)
        if taken != want:
            raise RuntimeError(f"csrc/gt_flash.cu takes head widths {taken}, "
                               f"the wrapper states {want}")
    for name, which in STAGED.items():
        taken = tuple(hd for hd in widths if lib.scgib_gt_staged_info(
            which, hd, max(1, 4 // hd), 64, 32, 1, 128, info) == 0)
        if taken != STAGED_HEAD_WIDTHS:
            raise RuntimeError(f"csrc/gt_flash.cu stages {name} at head "
                               f"widths {taken}, the wrapper states "
                               f"{STAGED_HEAD_WIDTHS}")


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


# --- routes ------------------------------------------------------------------

class Route(NamedTuple):
    """How a wrapper runs at a shape: ``name`` one of ``ROUTES``; for the
    staged route ``split`` blocks a row tile (each on H / split whole
    heads) of ``threads`` threads and ``smem_bytes`` of dynamic shared
    memory."""
    name: str
    split: int = 1
    threads: int = 0
    smem_bytes: int = 0


def _lanes_per_row(features: int) -> int:
    """csrc/gt_flash.cu's lanes_per_row at 4 features a lane."""
    lpr = 4
    while lpr < 32 and 4 * lpr < features:
        lpr *= 2
    return lpr


def staged_smem(kernel: str, tile: int, band: int, features: int,
                heads: int) -> int:
    """csrc/gt_flash.cu's staged_smem: bytes of dynamic shared memory of a
    staged block of ``kernel`` (one of ``STAGED``) over ``features``
    features in ``heads`` heads: the k and v windows and the q rows in
    float32, the gate rows in bf16; the merged pass also the g rows, 1 /
    (z + eps) and rho, and a 64-bit mask of the tile's rows a column (per
    64 rows)."""
    gate = 2 * tile * band
    if kernel == "gt_fwd_bf16":
        return 4 * (2 * band + tile) * features + gate
    return (4 * ((2 * band + 2 * tile) * features + 2 * tile * heads) + gate
            + 8 * band * -(-tile // 64))


def _blocks_per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes of shared memory that fit on an SM."""
    return SM_SMEM // (smem + BLOCK_RESERVE)


def gt_route(kernel: str, num_heads: int, hd: int, tile: int = 64,
             band: int = 128) -> Route:
    """The route of ``kernel`` (one of ``KERNELS``) at ``num_heads`` heads
    of width ``hd`` in the geometry (``tile``, ``band``).  Staged where
    ``kernel`` has a staged kernel, ``hd`` is one of
    ``STAGED_HEAD_WIDTHS`` and a block fits ``SMEM_LIMIT``: split into the
    most parts of whole heads, up to ``STAGED_MAX_SPLIT``, of at least
    ``STAGED_MIN_FEATURES`` features (and at most ``STAGED_MAX_FEATURES``)
    whose block fits; blocks of 128 threads where four or more such blocks
    fit an SM's shared memory, 256 where two or three do and 512 where one
    does, twice that (up to 512) for the merged pass, whose ~97 registers
    a thread (the forward's ~60) leave fewer blocks resident; measured on
    the card (PERF.md).  Else the lane-group kernel.
    Deterministic in the shape alone."""
    if kernel in STAGED and hd in STAGED_HEAD_WIDTHS and tile % 32 == 0:
        width = num_heads * hd
        for split in range(min(STAGED_MAX_SPLIT, num_heads), 0, -1):
            features = width // split
            if num_heads % split or features % 4 or (
                    split > 1 and features < STAGED_MIN_FEATURES) or (
                    features > STAGED_MAX_FEATURES):
                continue
            smem = staged_smem(kernel, tile, band, features,
                               num_heads // split)
            if smem > SMEM_LIMIT:
                continue
            per_sm = _blocks_per_sm(smem)
            threads = 128 if per_sm >= 4 else 256 if per_sm >= 2 else 512
            if kernel == "gt_bwd_merged_bf16":
                threads = min(2 * threads, 512)
            return Route("staged", split, threads, smem)
    return Route("lane_group")


# --- plain versions ----------------------------------------------------------

def _per_tile(x, n_tiles, tile):
    """[N, H] -> [T, H, tile]."""
    return x.reshape(n_tiles, tile, -1).permute(0, 2, 1)


def _per_row(x):
    """[T, H, tile] -> [N, H]."""
    return x.permute(0, 2, 1).reshape(-1, x.shape[1])


def _backward_entries(blocks, col_off, q, k, v, g, z, rho, clamp, eps,
                      scale, bf16_dots=False):
    """(W, dS, rho) per entry; rho [T, H, tile] is the row sums of G * W,
    computed when ``rho`` is None.  ``bf16_dots``: the scores from q and k,
    and G from g and v, rounded to bf16."""
    n_tiles, tile, band = blocks.shape
    _, num_heads, hd = q.shape
    s, e = gt_scores(blocks, col_off, _bf16(q, bf16_dots),
                     _bf16(k, bf16_dots), clamp, scale)
    inv = (1.0 / (_per_tile(z, n_tiles, tile) + eps))[..., None]
    w = e * inv
    G = torch.einsum("tihd,tjhd->thij",
                     _bf16(g, bf16_dots).reshape(n_tiles, tile, num_heads,
                                                 hd),
                     gt_windows(col_off, band, _bf16(v, bf16_dots)))
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
                 scale=None, bf16_dots=False):
    """(out [N, H, hd], z [N, H]).  ``bf16_dots``: q, k, v and w = e / (z +
    eps) rounded to bf16 before their products (``_fwd_kernel``)."""
    band = blocks.shape[2]
    _, e = gt_scores(blocks, col_off, _bf16(q, bf16_dots),
                     _bf16(k, bf16_dots), clamp, scale)
    z = e.sum(-1)                                        # [T, H, tile]
    if bf16_dots:
        w = _bf16(e * (1.0 / (z + eps))[..., None])
    else:
        w = e / (z + eps)[..., None]
    out = torch.einsum("thij,tjhd->tihd", w,
                       gt_windows(col_off, band, _bf16(v, bf16_dots)))
    return out.reshape(q.shape), _per_row(z)


def gt_bwd_rows_plain(blocks, col_off, q, k, v, g, z, clamp=5.0, eps=1e-6,
                      scale=None, bf16_dots=False):
    """(dq [N, H, hd], rho [N, H]).  ``bf16_dots``: every product's operands
    rounded to bf16 (``_bwd_rows_kernel``), dS and k for dq among them."""
    band = blocks.shape[2]
    scale = _scale(q.shape[2]) if scale is None else scale
    _, ds, rho = _backward_entries(blocks, col_off, q, k, v, g, z, None,
                                   clamp, eps, scale, bf16_dots)
    dq = torch.einsum("thij,tjhd->tihd", _bf16(ds, bf16_dots),
                      gt_windows(col_off, band, _bf16(k, bf16_dots)))
    return dq.reshape(q.shape) * scale, _per_row(rho)


def gt_bwd_cols_plain(blocks, col_off, q, k, v, g, z, rho, clamp=5.0,
                      eps=1e-6, scale=None, bf16_dots=False):
    """(dk, dv) [N, H, hd] from the row pass's z and rho.  ``bf16_dots``:
    every product's operands rounded to bf16 (``_bwd_cols_kernel``), dS
    and q for dk, W and g for dv among them."""
    n_tiles, tile, _ = blocks.shape
    n, num_heads, hd = q.shape
    scale = _scale(hd) if scale is None else scale
    w, ds, _ = _backward_entries(blocks, col_off, q, k, v, g, z, rho, clamp,
                                 eps, scale, bf16_dots)
    q_t = _bf16(q, bf16_dots).reshape(n_tiles, tile, num_heads, hd)
    g_t = _bf16(g, bf16_dots).reshape(n_tiles, tile, num_heads, hd)
    dk = _add_windows(col_off, torch.einsum(
        "thij,tihd->tjhd", _bf16(ds, bf16_dots), q_t), n)
    dv = _add_windows(col_off, torch.einsum(
        "thij,tihd->tjhd", _bf16(w, bf16_dots), g_t), n)
    return dk * scale, dv


def gt_bwd_merged_plain(blocks, col_off, q, k, v, g, z, clamp=5.0, eps=1e-6,
                        scale=None, bf16_dots=False):
    """(dq, dk, dv) [N, H, hd] in one pass.  ``bf16_dots``: rounded where
    ``_bwd_merged_kernel`` rounds with ``bf16=True``, which are the row and
    column passes' rounding points (dS before dq and before dk, W before
    dv, and q, k, v, g)."""
    dq, rho = gt_bwd_rows_plain(blocks, col_off, q, k, v, g, z, clamp, eps,
                                scale, bf16_dots)
    return (dq,) + gt_bwd_cols_plain(blocks, col_off, q, k, v, g, z, rho,
                                     clamp, eps, scale, bf16_dots)


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
            eps, scale, outs, *flags):
    """``hd``: the head width, or (head width, split, threads) for a
    staged kernel."""
    widths = hd if isinstance(hd, tuple) else (hd,)
    scale = _scale(widths[0]) if scale is None else scale
    raise_on(fn(ptr(blocks), ptr(col_off), *geo,
                *(ptr(t) for t in tensors), num_heads, *widths, scale,
                clamp, eps, *flags, *(ptr(t) for t in outs), stream()),
             name)


def gt_fwd(blocks, col_off, q, k, v, clamp=5.0, eps=1e-6, scale=None,
           bf16_dots=False):
    """(out, z) (replaces ``_fwd_kernel``; with ``bf16_dots`` its bf16
    mode, counted on ``gt_fwd_bf16``)."""
    if not on_card("gt_fwd", q):
        return gt_fwd_plain(blocks, col_off, q, k, v, clamp, eps, scale,
                            bf16_dots)
    blocks, col_off, geo, num_heads, hd, ts = _gt_args(
        "gt_fwd", blocks, col_off, q, k, v)
    out = torch.empty_like(ts[0])
    z = torch.empty(ts[0].shape[:2], dtype=torch.float32, device=q.device)
    name = "gt_fwd_bf16" if bf16_dots else "gt_fwd"
    route = gt_route(name, num_heads, hd, *geo[1:])
    if route.name == "staged":
        # the exponentials past a row's first KEEP nonzeros: a row slot
        # of band - KEEP a head for each group of lanes
        groups = geo[0] * route.split * route.threads // _lanes_per_row(
            num_heads * hd // route.split)
        spill = torch.empty(groups * (geo[2] - KEEP) * num_heads
                            // route.split, dtype=torch.float32,
                            device=q.device)
        _launch(build().scgib_gt_fwd_staged, "gt_fwd", blocks, col_off, geo,
                ts, num_heads, (hd, route.split, route.threads), clamp, eps,
                scale, (out, z, spill))
    else:
        _launch(build().scgib_gt_fwd, "gt_fwd", blocks, col_off, geo, ts,
                num_heads, hd, clamp, eps, scale, (out, z), int(bf16_dots))
    counters.tick("launch", name)
    if bf16_dots:
        counters.tick("route", (name, route.name))
    return out, z


def gt_bwd_rows(blocks, col_off, q, k, v, g, z, clamp=5.0, eps=1e-6,
                scale=None, bf16_dots=False):
    """(dq, rho) (replaces ``_bwd_rows_kernel``; with ``bf16_dots`` its
    bf16 mode, counted on ``gt_bwd_rows_bf16``)."""
    if not on_card("gt_bwd_rows", q):
        return gt_bwd_rows_plain(blocks, col_off, q, k, v, g, z, clamp, eps,
                                 scale, bf16_dots)
    blocks, col_off, geo, num_heads, hd, ts = _gt_args(
        "gt_bwd_rows", blocks, col_off, q, k, v, g, z)
    dq = torch.empty_like(ts[0])
    rho = torch.empty_like(ts[4])
    _launch(build().scgib_gt_bwd_rows, "gt_bwd_rows", blocks, col_off, geo,
            ts, num_heads, hd, clamp, eps, scale, (dq, rho), int(bf16_dots))
    counters.tick("launch",
                  "gt_bwd_rows_bf16" if bf16_dots else "gt_bwd_rows")
    return dq, rho


def gt_bwd_cols(blocks, col_off, q, k, v, g, z, rho, clamp=5.0, eps=1e-6,
                scale=None, bf16_dots=False):
    """(dk, dv) (replaces ``_bwd_cols_kernel``; with ``bf16_dots`` its
    bf16 mode, counted on ``gt_bwd_cols_bf16``).  Needs a symmetric A."""
    if not on_card("gt_bwd_cols", q):
        return gt_bwd_cols_plain(blocks, col_off, q, k, v, g, z, rho, clamp,
                                 eps, scale, bf16_dots)
    blocks, col_off, geo, num_heads, hd, ts = _gt_args(
        "gt_bwd_cols", blocks, col_off, q, k, v, g, z, rho)
    dk = torch.empty_like(ts[0])
    dv = torch.empty_like(ts[0])
    _launch(build().scgib_gt_bwd_cols, "gt_bwd_cols", blocks, col_off, geo,
            ts, num_heads, hd, clamp, eps, scale, (dk, dv), int(bf16_dots))
    counters.tick("launch",
                  "gt_bwd_cols_bf16" if bf16_dots else "gt_bwd_cols")
    return dk, dv


def gt_bwd_merged(blocks, col_off, q, k, v, g, z, clamp=5.0, eps=1e-6,
                  scale=None, bf16_dots=False):
    """(dq, dk, dv) in one pass (replaces ``_bwd_merged_kernel``; with
    ``bf16_dots`` its bf16 mode, counted on ``gt_bwd_merged_bf16``); dk and
    dv are summed with atomics, so their last bits vary between runs."""
    if not on_card("gt_bwd_merged", q):
        return gt_bwd_merged_plain(blocks, col_off, q, k, v, g, z, clamp,
                                   eps, scale, bf16_dots)
    blocks, col_off, geo, num_heads, hd, ts = _gt_args(
        "gt_bwd_merged", blocks, col_off, q, k, v, g, z)
    dq = torch.empty_like(ts[0])
    dk = torch.zeros_like(ts[0])
    dv = torch.zeros_like(ts[0])
    name = "gt_bwd_merged_bf16" if bf16_dots else "gt_bwd_merged"
    route = gt_route(name, num_heads, hd, *geo[1:])
    if route.name == "staged":
        _launch(build().scgib_gt_bwd_merged_staged, "gt_bwd_merged", blocks,
                col_off, geo, ts, num_heads, (hd, route.split, route.threads),
                clamp, eps, scale, (dq, dk, dv))
    else:
        _launch(build().scgib_gt_bwd_merged, "gt_bwd_merged", blocks,
                col_off, geo, ts, num_heads, hd, clamp, eps, scale,
                (dq, dk, dv), int(bf16_dots))
    counters.tick("launch", name)
    if bf16_dots:
        counters.tick("route", (name, route.name))
    return dq, dk, dv


def kernel_info(kernel: str, hd: int, num_heads=None, tile: int = 64,
                band: int = 128) -> dict:
    """Registers a thread, shared memory a block and blocks an SM of the
    kernel that ``kernel`` (one of ``KERNELS``: a wrapper, or the bf16 mode
    of one) launches at head width ``hd``, with its ``route``.  Given
    ``num_heads`` (and the geometry ``tile``, ``band``), the kernel of the
    route ``gt_route`` picks at that shape, and for the staged route its
    ``blocks_per_tile`` and dynamic shared memory among ``smem_bytes``;
    else the lane-group kernel."""
    info = (ctypes.c_int * 3)()
    route = (gt_route(kernel, num_heads, hd, tile, band)
             if num_heads is not None else Route("lane_group"))
    if route.name == "staged":
        raise_on(build().scgib_gt_staged_info(
            STAGED[kernel], hd, num_heads, tile, band, route.split,
            route.threads, info), kernel)
    else:
        raise_on(build().scgib_gt_kernel_info(_INFO[kernel], hd, info),
                 kernel)
    staged = route.name == "staged"
    return {"route": route.name,
            "blocks_per_tile": route.split if staged else None,
            "threads": route.threads if staged else None,
            "registers": info[0], "smem_bytes": info[1],
            "blocks_per_sm": info[2]}


def ptxas_key(kernel: str, route: str = "lane_group") -> str:
    """``ptxas_report``'s name of the instantiations of ``kernel``'s
    ``route``: the wrapper's name, and " staged" after it for a staged
    kernel."""
    return kernel + (" staged" if route == "staged" else "")


def ptxas_report() -> dict:
    """ptxas's ``registers``, ``spill_stores`` and ``spill_loads`` (bytes)
    of every instantiation, by (``ptxas_key``, head width); head width 0
    is the WIDE instantiation, which every multiple of ``SWEEP`` past it
    runs."""
    build()
    out = {}
    for entry, rec in _ptxas_report("gt_flash").items():
        m = re.search(r"(gt_fwd|gt_bwd_merged)_staged_bf16_kernelILi(\d+)EE",
                      entry)
        if m:
            out[ptxas_key(m.group(1) + "_bf16", "staged"),
                int(m.group(2))] = rec
            continue
        # the template's int, then its bools: [MERGED,] BF16
        m = re.search(r"(gt_fwd|gt_row_pass|gt_bwd_cols)_kernelILi(\d+)E"
                      r"((?:Lb[01]E)+)E", entry)
        if m:
            flags = [f == "1" for f in re.findall(r"Lb([01])E", m.group(3))]
            name = {"gt_fwd": "gt_fwd", "gt_bwd_cols": "gt_bwd_cols",
                    "gt_row_pass": "gt_bwd_merged" if flags[0]
                    else "gt_bwd_rows"}[m.group(1)]
            out[name + ("_bf16" if flags[-1] else ""), int(m.group(2))] = rec
    return out


# --- autograd ---------------------------------------------------------------

class _GtFlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blocks, col_off, q, k, v, clamp, eps, bwd, scale,
                bf16_dots):
        out, z = gt_fwd(blocks, col_off, q, k, v, clamp, eps, scale,
                        bf16_dots)
        ctx.save_for_backward(blocks, col_off, q, k, v, z)
        ctx.clamp, ctx.eps, ctx.bwd, ctx.scale = clamp, eps, bwd, scale
        ctx.bf16_dots = bf16_dots
        return out

    @staticmethod
    def backward(ctx, g):
        blocks, col_off, q, k, v, z = ctx.saved_tensors
        args = (blocks, col_off, q, k, v, g.contiguous(), z)
        consts = (ctx.clamp, ctx.eps, ctx.scale)
        if ctx.bwd == "merged":
            dq, dk, dv = gt_bwd_merged(*args, *consts, ctx.bf16_dots)
        else:
            dq, rho = gt_bwd_rows(*args, *consts, ctx.bf16_dots)
            dk, dv = gt_bwd_cols(*args, rho, *consts, ctx.bf16_dots)
        return None, None, dq, dk, dv, None, None, None, None, None


def check_bwd(bwd: str):
    """Raise unless ``bwd`` names a backward."""
    if bwd not in BWD:
        raise ValueError(f"bwd must be one of {BWD}, got {bwd!r}")


def gt_flash_attention(blocks, col_off, q, k, v, clamp: float = 5.0,
                       eps: float = 1e-6, bwd: str = "twopass",
                       bf16_dots: bool = False):
    """Graph-transformer banded attention, q/k/v [N, H, hd] -> [N, H, hd]
    (the semantics of ``spmm_banded.gt_banded_attention``) with the kernel
    backward: ``bwd`` is "twopass" (rows then columns) or "merged".  The
    column pass and the merged pass need a symmetric A.  A head width the
    kernels do not take runs zero-padded to ``served_head_width``: the zero
    features add nothing to a score, their outputs are dropped, and the
    scale stays 1 / sqrt(hd).  ``bf16_dots``: every product on bf16
    operands, with either backward.  bfloat16 q, k and v (a transformer
    whose dense tail runs in bf16) are cast to float32 for the kernels, and
    the output and the gradients go back in bfloat16, as the JAX function
    casts them."""
    check_bwd(bwd)
    dtype = q.dtype
    if dtype == torch.bfloat16:
        q, k, v = q.float(), k.float(), v.float()
    num_heads, hd = q.shape[1:]
    width = served_head_width(num_heads, hd)
    if width == hd:
        out = _GtFlashAttention.apply(blocks, col_off, q, k, v, clamp, eps,
                                      bwd, None, bf16_dots)
    else:
        q, k, v = (torch.nn.functional.pad(t, (0, width - hd))
                   for t in (q, k, v))
        out = _GtFlashAttention.apply(blocks, col_off, q, k, v, clamp, eps,
                                      bwd, _scale(hd), bf16_dots)[..., :hd]
    return out.to(dtype)
