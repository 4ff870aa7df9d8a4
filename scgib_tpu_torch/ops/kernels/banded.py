"""Banded-adjacency kernels: CUDA wrappers, plain versions, autograd.

Counterpart of ``scgib_tpu/ops/pallas/banded.py``.  Five wrappers stand for
the five Pallas kernels there, and a sixth for the fused conv's bf16 mode;
four CUDA kernels in ``csrc/banded.cu`` serve them (the SpMM kernel serves
three):

  wrapper       TPU kernel it replaces                  CUDA kernel
  gin_fwd       _kernel            (fused GIN conv)     gin_fused_fwd
  gin_fwd_bf16  _kernel, bf16 operands                  gin_fused_fwd_bf16
  gin_bwd       _bwd_kernel        (GIN bwd stage 1)    gin_fused_bwd
  spmm_self     _spmm_self_kernel  (GIN bwd stage 2)    banded_spmm, +x
  spmm          _spmm_kernel       (recon cross term)   banded_spmm
  pool          _pool_kernel       (candidate pooling)  banded_spmm, W=1024

A seventh, ``blocks``, builds the 0/1 blocks the others read, from index
arrays (``models/scgib.py::_resolve_band``, ``ops/pool.py::pool_blocks``),
with two kernels, ``blocks_zero`` and ``blocks_scatter``; it replaces no
Pallas kernel (the JAX package builds the blocks with XLA scatters), so it
is not one of ``KERNELS``, which are the Pallas kernels' counterparts.  It
counts its launches as ``BLOCKS`` (kind ``launch``) and the entries it
writes (kind ``blocks``, name ``entries``).

The band width W is the blocks' last dimension, any multiple of
``BAND_MULTIPLE``: the packers size it from the data (``graph/banded.py::
band_width``: 256 up to 64-node graphs and ego-nets, 384 and 512 at
Peptides-func's), the pool's window is 1024 or more, and the gather walks
the W-wide row in segments whatever W is.

Each wrapper takes its plain PyTorch version (``*_plain``) for a CPU tensor
and launches its kernel for a CUDA tensor, counting each launch that
succeeded (kind ``launch`` in ``utils/counters.py``); anything else
raises, a blocks tensor that is not 16-byte aligned included, and for
``spmm``, ``spmm_self``, ``pool`` and ``gin_bwd`` a feature tensor that
is not (``gin_fwd`` copies it).  The kernels are built from the repo's sources
with ``nvcc`` into ``scgib_tpu_torch/_build/`` at first use and loaded
with ``ctypes``.

``banded_spmm`` gathers only the x rows where A is nonzero: a group of
lanes per row reads the row's slab in 16-byte vectors, finds its nonzeros
with warp ballots and keeps several gathers in flight, summing in fp32 in
a fixed order.  ``gin_fused_fwd`` gathers a row tile's h + A h the same
way into shared memory and runs both products on the tensor cores in
3xTF32.  ``gin_fused_bwd`` is a persistent grid of one block per SM that
stages the weights once and loops over row tiles as a pipeline: two
warpgroups of producers gather the next tile's z0 and copy its rows of g
into a two-stage ring in shared memory while two warpgroups of consumers
run this tile's five products the same way; each block writes one
weight-gradient partial, which ``gin_bwd`` sums with one ``torch.sum``: no
atomics, so all three are bitwise reproducible on one card.
``count_bwd_tiles`` counts the backward's row tiles (``tiles``) and those
whose gather ran under the products of the tile before (``overlapped``),
from the launch's shapes (``bwd_tiles``).

``gin_fwd_bf16`` is the JAX package's ``compute_dtype="bfloat16"`` conv:
h, W1 and W2 arrive in bfloat16 (its GIN casts them), every product takes
bf16 operands with float32 accumulation, z0 and relu(z1) are rounded to
bf16 before their products, the biases and the output stay float32.  Its
kernel, ``gin_fused_fwd_bf16``, keeps the operands in bf16 in shared
memory, each rounded once, and copies the weights asynchronously while the
gather runs; ``gin_route`` names the instantiation it launches at given
widths.
``gin_banded_layer`` takes that path when h is bfloat16; its backward is
JAX's ``_bwd``: ``gin_bwd`` and ``spmm_self`` on the rounded operands in
float32, dh, dW1 and dW2 rounded to bf16 on the way out.  The source note in
``csrc/banded.cu`` says what bounds each kernel on an H100 and how the
design answers it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...utils import counters
from ..spmm_banded import _banded_spmm_impl
from .build import library, on_card, ptr, raise_on, stream

TILE = 128
BAND_MULTIPLE = 32   # band widths the kernels take
MAX_FUSED_DIM = 128
ALIGN = 16           # bytes: the kernels read blocks and x in 16-byte
                     # vectors

KERNELS = ("gin_fwd", "gin_fwd_bf16", "gin_bwd", "spmm_self", "spmm",
           "pool")
BLOCKS = "blocks"    # the block build's launch count (not a Pallas kernel's)


def build() -> ctypes.CDLL:
    """Compile ``csrc/banded.cu`` for sm_90a (once per source hash, see
    ``build.py``) and load it."""
    return library("banded", bind)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Give a library built from ``csrc/banded.cu`` its entries' argument
    and return types."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.scgib_banded_spmm.argtypes = [P, P, I, I, P, L, I, P, I, P]
    lib.scgib_gin_fused_fwd.argtypes = [P, P, I, I, P, L, I, P, P, I, P, P,
                                        I, P, P]
    lib.scgib_gin_fused_fwd_bf16.argtypes = lib.scgib_gin_fused_fwd.argtypes
    lib.scgib_gin_fused_bwd_grid.argtypes = [L, I, I, I, P]
    lib.scgib_gin_fused_bwd.argtypes = [P, P, I, P, L, I, P, P, P, I, P, I,
                                        P, P, I, P]
    lib.scgib_kernel_info.argtypes = [I, I, I, I, P]
    lib.scgib_blocks.argtypes = [P, P, P, P, L, I, I, I, P, P]
    for fn in (lib.scgib_banded_spmm, lib.scgib_blocks,
               lib.scgib_gin_fused_fwd,
               lib.scgib_gin_fused_fwd_bf16, lib.scgib_gin_fused_bwd_grid,
               lib.scgib_gin_fused_bwd, lib.scgib_kernel_info):
        fn.restype = ctypes.c_int
    return lib


def _band_args(blocks, col_off, x, name, copy=False, dtype=torch.float32):
    """Validate the banded operands; returns (blocks, col_off, x)
    contiguous.  x must be ``dtype`` (float32; bfloat16 for
    ``gin_fwd_bf16``).  The kernels read blocks and x in 16-byte vectors,
    so both must start on a 16-byte boundary: a misaligned operand raises
    or, for x with ``copy``, is copied."""
    if blocks.dim() != 3 or blocks.shape[1] != TILE:
        raise ValueError(f"{name}: blocks must be [T, {TILE}, W], got "
                         f"{tuple(blocks.shape)}")
    if blocks.shape[2] % BAND_MULTIPLE != 0:
        raise ValueError(f"{name}: band width must be a multiple of "
                         f"{BAND_MULTIPLE}")
    if blocks.dtype != torch.bfloat16:
        raise TypeError(f"{name}: blocks must be bfloat16")
    if x.dtype != dtype:
        raise TypeError(f"{name}: features must be {str(dtype)[6:]}")
    if col_off.shape != (blocks.shape[0],):
        raise ValueError(f"{name}: col_off must be [T]")
    for t in (blocks, col_off, x):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name}: operands must share one CUDA device")
    blocks, x = blocks.contiguous(), x.contiguous()
    if copy and x.data_ptr() % ALIGN:
        x = x.clone()
    for t, what in ((blocks, "blocks"), (x, "features")):
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name}: {what} must be {ALIGN}-byte aligned")
    return blocks, col_off.to(torch.int64).contiguous(), x


# --- the blocks ------------------------------------------------------------

def _blocks_args(rows, src, mask, off, n_tiles):
    """Validate ``blocks``' index operands (on either device)."""
    if rows.dim() != 1 or rows.dtype != torch.int64:
        raise TypeError("blocks: rows must be a 1-D int64 tensor")
    if src is not None and (src.dtype != torch.int64
                            or src.shape != rows.shape):
        raise TypeError("blocks: src must be int64, shaped as rows")
    if mask is not None and (mask.dtype != torch.bool
                             or mask.shape != rows.shape):
        raise TypeError("blocks: mask must be bool, shaped as rows")
    if off.dtype != torch.int64:
        raise TypeError("blocks: off must be int64")
    if off.shape != (n_tiles,):
        raise ValueError(f"blocks: off must be [T] = [{n_tiles}], got "
                         f"{tuple(off.shape)}")
    for t in (src, mask, off):
        if t is not None and t.device != rows.device:
            raise ValueError("blocks: operands must share one device")


def blocks_plain(rows, src, mask, off, n_tiles, tile, width):
    """The counts as a float32 ``index_add_`` cast to bf16 once (exact for
    counts up to 256); dropped items go to a spare slot past the end, cut
    off (``index_add_`` raises on an index out of range)."""
    size = n_tiles * tile * width
    t_idx = rows // tile
    cols = src if src is not None else torch.arange(rows.shape[0],
                                                    device=rows.device)
    col = cols - off[t_idx.clamp(0, n_tiles - 1)]
    keep = (rows >= 0) & (t_idx < n_tiles) & (col >= 0) & (col < width)
    if mask is not None:
        keep = keep & mask
    lin = torch.where(keep, rows * width + col, torch.full_like(rows, size))
    flat = torch.zeros(size + 1, dtype=torch.float32, device=rows.device)
    flat.index_add_(0, lin, torch.ones(lin.shape, dtype=torch.float32,
                                       device=rows.device))
    return flat[:size].view(n_tiles, tile, width).to(torch.bfloat16)


def blocks(rows, src, mask, off, n_tiles, tile, width):
    """[n_tiles, tile, width] bf16 counts of items: item i adds 1 at
    [t, r - t tile, c - off[t]], with r = rows[i], c = src[i] (i where
    ``src`` is None) and t = r // tile, where ``mask[i]`` (or no mask),
    0 <= r, t < n_tiles and 0 <= c - off[t] < width; any other item is
    dropped.  rows, src and off int64, mask bool, off [n_tiles]."""
    _blocks_args(rows, src, mask, off, n_tiles)
    if not on_card("blocks", rows):
        return blocks_plain(rows, src, mask, off, n_tiles, tile, width)
    out = torch.empty((n_tiles, tile, width), dtype=torch.bfloat16,
                      device=rows.device)    # the allocator aligns to 512
    src, mask = (None if t is None else t.contiguous() for t in (src, mask))
    rows, off = rows.contiguous(), off.contiguous()
    raise_on(build().scgib_blocks(
        ptr(rows), ptr(src), ptr(mask), ptr(off), rows.shape[0], n_tiles,
        tile, width, ptr(out), stream()), "blocks")
    counters.tick("launch", BLOCKS)
    counters.tick("blocks", "entries", out.numel())
    return out


# --- banded SpMM: wrappers #3, #4, #5 ---------------------------------------

def _launch_spmm(blocks, col_off, x, add_self: bool, name: str):
    blocks, col_off, x = _band_args(blocks, col_off, x, name)
    n_tiles, _, width = blocks.shape
    if add_self and x.shape[0] != n_tiles * TILE:
        raise ValueError(f"{name}: x + A x needs T*{TILE} rows")
    out = torch.empty((n_tiles * TILE, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    raise_on(build().scgib_banded_spmm(
        ptr(blocks), ptr(col_off), n_tiles, width, ptr(x), x.shape[0],
        x.shape[1], ptr(out), int(add_self), stream()), name)
    return out


def spmm_plain(blocks, col_off, x):
    return _banded_spmm_impl(blocks, col_off, x)


def spmm_self_plain(blocks, col_off, x):
    return x + _banded_spmm_impl(blocks, col_off, x)


def spmm(blocks, col_off, x):
    """``A x`` (replaces ``_spmm_kernel``)."""
    if not on_card("spmm", x):
        return spmm_plain(blocks, col_off, x)
    out = _launch_spmm(blocks, col_off, x, False, "spmm")
    counters.tick("launch", "spmm")
    return out


def spmm_self(blocks, col_off, x):
    """``x + A x`` (replaces ``_spmm_self_kernel``)."""
    if not on_card("spmm_self", x):
        return spmm_self_plain(blocks, col_off, x)
    out = _launch_spmm(blocks, col_off, x, True, "spmm_self")
    counters.tick("launch", "spmm_self")
    return out


def pool(blocks, col_off, data):
    """[T, 128, W] 0/1 blocks x windows of [S, d] -> [T*128, d] (replaces
    ``_pool_kernel``; fp32 FMA on the 0/1 operand is the exact sum that the
    TPU reached with a hi/lo bf16 split)."""
    if not on_card("pool", data):
        return spmm_plain(blocks, col_off, data)
    out = _launch_spmm(blocks, col_off, data, False, "pool")
    counters.tick("launch", "pool")
    return out


# --- fused GIN conv: wrappers #1, #2 ----------------------------------------

def gin_fwd_plain(blocks, col_off, h, w1, b1, w2, b2):
    """``gin_banded_layer_reference``: relu((h + A h) W1 + b1) W2 + b2."""
    z0 = _banded_spmm_impl(blocks, col_off, h) + h
    return torch.relu(z0 @ w1 + b1) @ w2 + b2


def _bf16(x, on=True):
    """x rounded to bfloat16, in its own dtype, where ``on``: an operand of
    a product of the bf16 kernels."""
    return x.to(torch.bfloat16).to(x.dtype) if on else x


def gin_fwd_bf16_plain(blocks, col_off, h, w1, b1, w2, b2):
    """``_kernel`` on bf16 operands: h, w1 and w2 bfloat16 (or already
    rounded), the sums in b1's dtype, z0 and relu(z1) rounded to bf16 before
    their products, the biases added after them."""
    ct = b1.dtype
    h, w1, w2 = h.to(ct), w1.to(ct), w2.to(ct)
    z0 = _banded_spmm_impl(blocks, col_off, h) + h
    return _bf16(torch.relu(_bf16(z0) @ w1 + b1)) @ w2 + b2


def gin_bwd_plain(blocks, col_off, h, g, w1, b1, w2):
    """Stage 1 of ``_bwd``'s XLA branch: (gz0, dW1, db1, dW2, db2)."""
    z0 = _banded_spmm_impl(blocks, col_off, h) + h
    z1 = z0 @ w1 + b1
    dw2 = torch.relu(z1).T @ g
    db2 = g.sum(0)
    gz1 = (g @ w2.T) * (z1 > 0).to(g.dtype)
    db1 = gz1.sum(0)
    dw1 = z0.T @ gz1
    return gz1 @ w1.T, dw1, db1, dw2, db2


def _fused_dims(h, w1, w2, name):
    din, hid, dout = h.shape[1], w1.shape[1], w2.shape[1]
    if w1.shape[0] != din or w2.shape[0] != hid:
        raise ValueError(f"{name}: weight shapes do not chain")
    if max(din, hid, dout) > MAX_FUSED_DIM:
        raise ValueError(f"{name}: widths above {MAX_FUSED_DIM} are not "
                         "supported by the fused kernel")
    return din, hid, dout


def gin_fwd(blocks, col_off, h, w1, b1, w2, b2):
    """Fused pre-BN GIN conv (replaces ``_kernel``).  w1 [d_in, H],
    w2 [H, d_out] as in the JAX package."""
    if not on_card("gin_fwd", h):
        return gin_fwd_plain(blocks, col_off, h, w1, b1, w2, b2)
    blocks, col_off, h = _band_args(blocks, col_off, h, "gin_fwd",
                                    copy=True)
    din, hid, dout = _fused_dims(h, w1, w2, "gin_fwd")
    n_tiles, _, width = blocks.shape
    if h.shape[0] != n_tiles * TILE:
        raise ValueError(f"gin_fwd: h needs T*{TILE} rows")
    w1, b1, w2, b2 = (t.float().contiguous() for t in (w1, b1, w2, b2))
    out = torch.empty((h.shape[0], dout), dtype=torch.float32,
                      device=h.device)
    raise_on(build().scgib_gin_fused_fwd(
        ptr(blocks), ptr(col_off), n_tiles, width, ptr(h), h.shape[0],
        din, ptr(w1), ptr(b1), hid, ptr(w2), ptr(b2), dout, ptr(out),
        stream()), "gin_fwd")
    counters.tick("launch", "gin_fwd")
    return out


def gin_route(din: int, hid: int, dout: int) -> str:
    """The instantiation of ``gin_fused_fwd_bf16_kernel<VEC, MT, NT>`` that
    ``gin_fwd_bf16`` launches at these widths, as ``plan_fwd_bf16`` in
    ``csrc/banded.cu`` picks it: row tiles of MT = 32; VEC = 8 (one
    16-byte load of h a lane) where din is a multiple of 8, else 1 (two
    pieces a lane); NT = 2 output tiles a warp up to width 64, 4 past it.
    Every width from 1 to ``MAX_FUSED_DIM`` (the block's bf16 shared
    memory is 28 KB at width 64 and 88 KB at 128, inside a block's 227
    KB); raises past them.  Deterministic in the widths alone."""
    if not all(1 <= w <= MAX_FUSED_DIM for w in (din, hid, dout)):
        raise ValueError(f"gin_route: widths ({din}, {hid}, {dout}) outside "
                         f"1 .. {MAX_FUSED_DIM}")
    vec = 8 if din % 8 == 0 else 1
    nt = 2 if max(din, hid, dout) <= 64 else 4
    return f"gin_fused_fwd_bf16_kernel<{vec}, 32, {nt}>"


def gin_fwd_bf16(blocks, col_off, h, w1, b1, w2, b2):
    """The fused conv with bf16 operands (replaces ``_kernel`` in its bf16
    mode): h, w1 and w2 bfloat16, b1 and b2 float32; the output float32."""
    if not on_card("gin_fwd_bf16", h):
        return gin_fwd_bf16_plain(blocks, col_off, h, w1, b1, w2, b2)
    blocks, col_off, h = _band_args(blocks, col_off, h, "gin_fwd_bf16",
                                    copy=True, dtype=torch.bfloat16)
    din, hid, dout = _fused_dims(h, w1, w2, "gin_fwd_bf16")
    n_tiles, _, width = blocks.shape
    if h.shape[0] != n_tiles * TILE:
        raise ValueError(f"gin_fwd_bf16: h needs T*{TILE} rows")
    if w1.dtype != torch.bfloat16 or w2.dtype != torch.bfloat16:
        raise TypeError("gin_fwd_bf16: w1 and w2 must be bfloat16")
    w1, w2 = w1.contiguous(), w2.contiguous()
    b1, b2 = (t.float().contiguous() for t in (b1, b2))
    out = torch.empty((h.shape[0], dout), dtype=torch.float32,
                      device=h.device)
    raise_on(build().scgib_gin_fused_fwd_bf16(
        ptr(blocks), ptr(col_off), n_tiles, width, ptr(h), h.shape[0],
        din, ptr(w1), ptr(b1), hid, ptr(w2), ptr(b2), dout, ptr(out),
        stream()), "gin_fwd_bf16")
    counters.tick("launch", "gin_fwd_bf16")
    return out


def bwd_tile_rows(din: int, hid: int, dout: int) -> int:
    """Rows of a ``gin_fused_bwd`` row tile at these widths, as
    ``plan_bwd`` in ``csrc/banded.cu`` picks them: two stages of z0 and g
    in shared memory at every width, so 64 where every width is at most 64
    and 16 above (up to ``MAX_FUSED_DIM``), where two stages of 32 rows
    would not fit beside the float weights."""
    return 64 if max(din, hid, dout) <= 64 else 16


def bwd_smem_bytes(din: int, hid: int, dout: int) -> int:
    """Shared memory of a ``gin_fused_bwd`` block at these widths, as
    ``bwd_smem_floats`` in ``csrc/banded.cu`` counts it: W1, W2 and b1,
    two stages of z0 and g, and z1 and gz1, rows padded by 4 floats."""
    def pow2(v):
        return next(p for p in (16, 32, 64, 128) if v <= p)
    dp, hp, op = pow2(din), pow2(hid), -(-dout // 16) * 16
    mt = bwd_tile_rows(din, hid, dout)
    return 4 * (dp * (hp + 4) + hp * (op + 4) + hp
                + mt * (2 * (dp + 4) + 2 * (op + 4) + 2 * (hp + 4)))


def bwd_tiles(n: int, din: int, hid: int, dout: int, grid: int):
    """(tiles, overlapped) of a ``gin_fused_bwd`` launch over ``n`` rows
    with ``grid`` blocks: its row tiles, and those that had an earlier tile
    in the same block (every tile but each block's first), whose gather
    therefore ran under the products of the tile before."""
    tiles = n // bwd_tile_rows(din, hid, dout)
    return tiles, tiles - min(grid, tiles)


def count_bwd_tiles(n: int, din: int, hid: int, dout: int, grid: int):
    """Count a ``gin_fused_bwd`` launch's ``bwd_tiles`` (kind
    ``gin_bwd``)."""
    tiles, overlapped = bwd_tiles(n, din, hid, dout, grid)
    counters.tick("gin_bwd", "tiles", tiles)
    counters.tick("gin_bwd", "overlapped", overlapped)


@functools.lru_cache(maxsize=None)
def _bwd_grid(n, din, hid, dout, device_index):
    """Blocks (and so weight-gradient partials) of ``gin_fused_bwd`` for
    these shapes on the current device."""
    grid = ctypes.c_int(0)
    raise_on(build().scgib_gin_fused_bwd_grid(n, din, hid, dout,
                                              ctypes.byref(grid)), "gin_bwd")
    return grid.value


def gin_bwd(blocks, col_off, h, g, w1, b1, w2):
    """Backward stage 1 (replaces ``_bwd_kernel``): recompute z0, z1 and
    return (gz0, dW1, db1, dW2, db2).  The kernel writes one weight-gradient
    partial per block (a few hundred at most); one ``torch.sum`` adds them
    in a fixed order."""
    if not on_card("gin_bwd", h):
        return gin_bwd_plain(blocks, col_off, h, g, w1, b1, w2)
    blocks, col_off, h = _band_args(blocks, col_off, h, "gin_bwd")
    din, hid, dout = _fused_dims(h, w1, w2, "gin_bwd")
    n_tiles, _, width = blocks.shape
    n = h.shape[0]
    if n != n_tiles * TILE or g.shape != (n, dout):
        raise ValueError(f"gin_bwd: h and g need T*{TILE} rows")
    g = g.float().contiguous()
    w1, b1, w2 = (t.float().contiguous() for t in (w1, b1, w2))
    grid = _bwd_grid(n, din, hid, dout, h.device.index)
    sizes = (din * hid, hid, hid * dout, dout)
    gz0 = torch.empty((n, din), dtype=torch.float32, device=h.device)
    part = torch.empty((grid, sum(sizes)), dtype=torch.float32,
                       device=h.device)
    raise_on(build().scgib_gin_fused_bwd(
        ptr(blocks), ptr(col_off), width, ptr(h), n, din, ptr(g),
        ptr(w1), ptr(b1), hid, ptr(w2), dout, ptr(gz0), ptr(part),
        grid, stream()), "gin_bwd")
    counters.tick("launch", "gin_bwd")
    count_bwd_tiles(n, din, hid, dout, grid)
    dw1, db1, dw2, db2 = part.sum(0).split(sizes)
    return gz0, dw1.view(din, hid), db1, dw2.view(hid, dout), db2


def kernel_info(kernel: str, din: int, hid: int = 0, dout: int = 0) -> dict:
    """Registers a thread, shared memory a block, blocks an SM, threads a
    block and rows a tile (0 for ``banded_spmm``) of the kernel that
    ``spmm`` (width ``din``), ``gin_bwd``, ``gin_fwd`` or ``gin_fwd_bf16``
    (``gin_fused_fwd_bf16``) launches; for the last also its ``route``, the
    instantiation ``gin_route`` names."""
    info = (ctypes.c_int * 5)()
    raise_on(build().scgib_kernel_info(
        {"banded_spmm": 0, "gin_fused_bwd": 1, "gin_fused_fwd": 2,
         "gin_fused_fwd_bf16": 3}[kernel],
        din, hid, dout, info), kernel)
    route = ({"route": gin_route(din, hid, dout)}
             if kernel == "gin_fused_fwd_bf16" else {})
    return {**route, "registers": info[0], "smem_bytes": info[1],
            "blocks_per_sm": info[2], "threads": info[3],
            "tile_rows": info[4]}


# --- autograd ---------------------------------------------------------------

class _GinBandedLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blocks, col_off, h, w1, b1, w2, b2):
        ctx.save_for_backward(blocks, col_off, h, w1, b1, w2)
        fwd = gin_fwd_bf16 if h.dtype == torch.bfloat16 else gin_fwd
        return fwd(blocks, col_off, h, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        """A == A^T (the packers symmetrize every edge list), so d/dh of
        h + A h applied to gz0 is the same banded product plus gz0.  In the
        bf16 mode the float32 kernels run on the bf16 operands, and dh, dW1
        and dW2 go back in their operands' bf16 (JAX's ``_bwd``)."""
        blocks, col_off, h, w1, b1, w2 = ctx.saved_tensors
        ct = b1.dtype            # the compute dtype of the bf16 mode's sums
        gz0, dw1, db1, dw2, db2 = gin_bwd(blocks, col_off, h.to(ct), g,
                                          w1.to(ct), b1, w2.to(ct))
        dh = spmm_self(blocks, col_off, gz0)
        return (None, None, dh.to(h.dtype), dw1.to(w1.dtype), db1,
                dw2.to(w2.dtype), db2)


def gin_banded_layer(blocks, col_off, h, w1, b1, w2, b2):
    """Fused pre-BN GIN conv relu((h + A h) W1 + b1) W2 + b2, with the
    kernel backward.  h, w1 and w2 in bfloat16 (b1, b2 float32) run the
    bf16 mode (``gin_fwd_bf16``), the JAX package's
    ``compute_dtype="bfloat16"``; the output is float32 in either."""
    return _GinBandedLayer.apply(blocks, col_off, h, w1, b1, w2, b2)


class _SpmmBandedFast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blocks, col_off, x):
        ctx.save_for_backward(blocks, col_off)
        return spmm(blocks, col_off, x)

    @staticmethod
    def backward(ctx, g):
        blocks, col_off = ctx.saved_tensors
        return None, None, spmm(blocks, col_off, g.contiguous())


def spmm_banded_fast(blocks, col_off, x):
    """``A x`` over the banded layout for a symmetric A; the backward is
    the same product."""
    return _SpmmBandedFast.apply(blocks, col_off, x)
