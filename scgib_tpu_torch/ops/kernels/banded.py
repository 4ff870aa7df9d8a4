"""Banded-adjacency kernels: CUDA wrappers, plain versions, autograd.

Counterpart of ``scgib_tpu/ops/pallas/banded.py``.  Five wrappers stand for
the five Pallas kernels there; three CUDA kernels in ``csrc/banded.cu``
serve them (the SpMM kernel serves three):

  wrapper     TPU kernel it replaces                    CUDA kernel
  gin_fwd     _kernel            (fused GIN conv)       gin_fused_fwd
  gin_bwd     _bwd_kernel        (GIN bwd stage 1)      gin_fused_bwd
  spmm_self   _spmm_self_kernel  (GIN bwd stage 2)      banded_spmm, +x
  spmm        _spmm_kernel       (recon cross term)     banded_spmm
  pool        _pool_kernel       (candidate pooling)    banded_spmm, W=1024

Each wrapper takes its plain PyTorch version (``*_plain``) for a CPU tensor
and launches its kernel for a CUDA tensor, counting each launch that
succeeded on its ``launches`` attribute; anything else raises, a blocks
tensor that is not 16-byte aligned included, and for ``spmm``,
``spmm_self``, ``pool`` and ``gin_bwd`` a feature tensor that is not
(``gin_fwd`` copies it).  The kernels are built from the repo's sources
with ``nvcc`` into ``scgib_tpu_torch/_build/`` at first use and loaded
with ``ctypes``.

``banded_spmm`` gathers only the x rows where A is nonzero: a group of
lanes per row reads the row's slab in 16-byte vectors, finds its nonzeros
with warp ballots and keeps several gathers in flight, summing in fp32 in
a fixed order.  ``gin_fused_fwd`` gathers a row tile's h + A h the same
way into shared memory and runs both products on the tensor cores in
3xTF32.  ``gin_fused_bwd`` is a persistent grid of one block per SM that
stages the weights once, loops over row tiles, runs its products the same
way and writes one weight-gradient partial per block, which ``gin_bwd``
sums with one ``torch.sum``: no atomics, so all three are bitwise
reproducible on one card.  The source note in
``csrc/banded.cu`` says what bounds each kernel on an H100 and how the
design answers it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..spmm_banded import _banded_spmm_impl
from .build import load

TILE = 128
BAND_MULTIPLE = 32   # band widths the kernels take
MAX_FUSED_DIM = 128
ALIGN = 16           # bytes: the kernels read blocks and x in 16-byte
                     # vectors

KERNELS = ("gin_fwd", "gin_bwd", "spmm_self", "spmm", "pool")

_lib = None


def build() -> ctypes.CDLL:
    """Compile ``csrc/banded.cu`` for sm_90a (once per source hash, see
    ``build.py``) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib, = load("banded")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.scgib_banded_spmm.argtypes = [P, P, I, I, P, L, I, P, I, P]
    lib.scgib_gin_fused_fwd.argtypes = [P, P, I, I, P, L, I, P, P, I, P, P,
                                        I, P, P]
    lib.scgib_gin_fused_bwd_grid.argtypes = [L, I, I, I, P]
    lib.scgib_gin_fused_bwd.argtypes = [P, P, I, P, L, I, P, P, P, I, P, I,
                                        P, P, I, P]
    lib.scgib_kernel_info.argtypes = [I, I, I, I, P]
    for fn in (lib.scgib_banded_spmm, lib.scgib_gin_fused_fwd,
               lib.scgib_gin_fused_bwd_grid, lib.scgib_gin_fused_bwd,
               lib.scgib_kernel_info):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _band_args(blocks, col_off, x, name, copy=False):
    """Validate the banded operands; returns (blocks, col_off, x)
    contiguous.  The kernels read blocks and x in 16-byte vectors, so both
    must start on a 16-byte boundary: a misaligned operand raises or, for
    x with ``copy``, is copied."""
    if blocks.dim() != 3 or blocks.shape[1] != TILE:
        raise ValueError(f"{name}: blocks must be [T, {TILE}, W], got "
                         f"{tuple(blocks.shape)}")
    if blocks.shape[2] % BAND_MULTIPLE != 0:
        raise ValueError(f"{name}: band width must be a multiple of "
                         f"{BAND_MULTIPLE}")
    if blocks.dtype != torch.bfloat16:
        raise TypeError(f"{name}: blocks must be bfloat16")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: features must be float32")
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


def _dispatch(name: str, x: torch.Tensor) -> bool:
    """True: launch the kernel (CUDA tensor).  False: plain version (CPU
    tensor).  Raises for any other device."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


# --- banded SpMM: wrappers #3, #4, #5 ---------------------------------------

def _launch_spmm(blocks, col_off, x, add_self: bool, name: str):
    blocks, col_off, x = _band_args(blocks, col_off, x, name)
    n_tiles, _, width = blocks.shape
    if add_self and x.shape[0] != n_tiles * TILE:
        raise ValueError(f"{name}: x + A x needs T*{TILE} rows")
    out = torch.empty((n_tiles * TILE, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    _raise_on(build().scgib_banded_spmm(
        _ptr(blocks), _ptr(col_off), n_tiles, width, _ptr(x), x.shape[0],
        x.shape[1], _ptr(out), int(add_self), _stream()), name)
    return out


def spmm_plain(blocks, col_off, x):
    return _banded_spmm_impl(blocks, col_off, x)


def spmm_self_plain(blocks, col_off, x):
    return x + _banded_spmm_impl(blocks, col_off, x)


def spmm(blocks, col_off, x):
    """``A x`` (replaces ``_spmm_kernel``)."""
    if not _dispatch("spmm", x):
        return spmm_plain(blocks, col_off, x)
    out = _launch_spmm(blocks, col_off, x, False, "spmm")
    spmm.launches += 1
    return out


def spmm_self(blocks, col_off, x):
    """``x + A x`` (replaces ``_spmm_self_kernel``)."""
    if not _dispatch("spmm_self", x):
        return spmm_self_plain(blocks, col_off, x)
    out = _launch_spmm(blocks, col_off, x, True, "spmm_self")
    spmm_self.launches += 1
    return out


def pool(blocks, col_off, data):
    """[T, 128, W] 0/1 blocks x windows of [S, d] -> [T*128, d] (replaces
    ``_pool_kernel``; fp32 FMA on the 0/1 operand is the exact sum that the
    TPU reached with a hi/lo bf16 split)."""
    if not _dispatch("pool", data):
        return spmm_plain(blocks, col_off, data)
    out = _launch_spmm(blocks, col_off, data, False, "pool")
    pool.launches += 1
    return out


# --- fused GIN conv: wrappers #1, #2 ----------------------------------------

def gin_fwd_plain(blocks, col_off, h, w1, b1, w2, b2):
    """``gin_banded_layer_reference``: relu((h + A h) W1 + b1) W2 + b2."""
    z0 = _banded_spmm_impl(blocks, col_off, h) + h
    return torch.relu(z0 @ w1 + b1) @ w2 + b2


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
    if not _dispatch("gin_fwd", h):
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
    _raise_on(build().scgib_gin_fused_fwd(
        _ptr(blocks), _ptr(col_off), n_tiles, width, _ptr(h), h.shape[0],
        din, _ptr(w1), _ptr(b1), hid, _ptr(w2), _ptr(b2), dout, _ptr(out),
        _stream()), "gin_fwd")
    gin_fwd.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _bwd_grid(n, din, hid, dout, device_index):
    """Blocks (and so weight-gradient partials) of ``gin_fused_bwd`` for
    these shapes on the current device."""
    grid = ctypes.c_int(0)
    _raise_on(build().scgib_gin_fused_bwd_grid(n, din, hid, dout,
                                               ctypes.byref(grid)), "gin_bwd")
    return grid.value


def gin_bwd(blocks, col_off, h, g, w1, b1, w2):
    """Backward stage 1 (replaces ``_bwd_kernel``): recompute z0, z1 and
    return (gz0, dW1, db1, dW2, db2).  The kernel writes one weight-gradient
    partial per block (a few hundred at most); one ``torch.sum`` adds them
    in a fixed order."""
    if not _dispatch("gin_bwd", h):
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
    _raise_on(build().scgib_gin_fused_bwd(
        _ptr(blocks), _ptr(col_off), width, _ptr(h), n, din, _ptr(g),
        _ptr(w1), _ptr(b1), hid, _ptr(w2), dout, _ptr(gz0), _ptr(part),
        grid, _stream()), "gin_bwd")
    gin_bwd.launches += 1
    dw1, db1, dw2, db2 = part.sum(0).split(sizes)
    return gz0, dw1.view(din, hid), db1, dw2.view(hid, dout), db2


def kernel_info(kernel: str, din: int, hid: int = 0, dout: int = 0) -> dict:
    """Registers a thread, shared memory a block and blocks an SM of the
    kernel that ``spmm`` (width ``din``), ``gin_bwd`` or ``gin_fwd``
    launches."""
    info = (ctypes.c_int * 3)()
    _raise_on(build().scgib_kernel_info(
        {"banded_spmm": 0, "gin_fused_bwd": 1, "gin_fused_fwd": 2}[kernel],
        din, hid, dout, info), kernel)
    return {"registers": info[0], "smem_bytes": info[1],
            "blocks_per_sm": info[2]}


def launch_counts() -> dict:
    return {name: globals()[name].launches for name in KERNELS}


def reset_launch_counts():
    for name in KERNELS:
        globals()[name].launches = 0


reset_launch_counts()


# --- autograd ---------------------------------------------------------------

class _GinBandedLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blocks, col_off, h, w1, b1, w2, b2):
        ctx.save_for_backward(blocks, col_off, h, w1, b1, w2)
        return gin_fwd(blocks, col_off, h, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        """A == A^T (the packers symmetrize every edge list), so d/dh of
        h + A h applied to gz0 is the same banded product plus gz0."""
        blocks, col_off, h, w1, b1, w2 = ctx.saved_tensors
        gz0, dw1, db1, dw2, db2 = gin_bwd(blocks, col_off, h, g, w1, b1, w2)
        dh = spmm_self(blocks, col_off, gz0)
        return None, None, dh, dw1, db1, dw2, db2


def gin_banded_layer(blocks, col_off, h, w1, b1, w2, b2):
    """Fused pre-BN GIN conv relu((h + A h) W1 + b1) W2 + b2, with the
    kernel backward."""
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
