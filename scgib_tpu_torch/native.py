"""ctypes binding of the port's native host library
(``csrc/scgib_native.cc``): threaded k-hop ego-net extraction
(``extract_egonets_batch``), the flat batch packer (``pack_batch_native``,
``data/flat.py``) and a row gather (``gather_rows``).

Counterpart of ``scgib_tpu/native.py``, with two departures.  The library
is built with ``g++`` at first use into ``_build/`` (one file per hash of
the source), under an ``fcntl`` lock, to a temporary name that is renamed
into place: processes that load it at once (test workers, a data loader's
threads) wait for one build and never see half a library.  And nothing
falls back quietly: where the library cannot be built, ``load`` raises
``NativeCompileError`` with the compiler's output.  The NumPy path is the
caller's to ask for (``use_flat=False`` in ``data/loader.py``).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from .graph.batching import EgoNets, GraphData

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "scgib_native.cc"
BUILD_DIR = _PKG / "_build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeCompileError(RuntimeError):
    """``g++`` could not build the native library."""


def so_path() -> Path:
    """The library's path, keyed by the source's hash."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libscgib_native_{digest}.so"


def _build(so: Path) -> None:
    """Compile to a temporary name and rename it into place, under an
    exclusive lock on ``_build/scgib_native.lock`` (another process may be
    building the same library; it is not rebuilt once it exists)."""
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / "scgib_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o",
               str(tmp), str(SOURCE), "-lpthread"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except OSError as e:
            raise NativeCompileError(f"cannot run g++: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeCompileError(
                f"g++ failed ({proc.returncode}) on {SOURCE}:\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    lib.scgib_egonet_sizes.argtypes = [
        ctypes.c_int32, i64p, i64p, i32p, i32p, ctypes.c_int32,
        i32p, i32p, ctypes.c_int32]
    lib.scgib_egonet_sizes.restype = None
    lib.scgib_egonet_fill.argtypes = [
        ctypes.c_int32, i64p, i64p, i32p, i32p, ctypes.c_int32,
        i64p, i64p, i32p, i32p, i32p, ctypes.c_int32]
    lib.scgib_egonet_fill.restype = None
    lib.scgib_gather_rows.argtypes = [
        f32p, ctypes.c_int32, i32p, ctypes.c_int64, f32p]
    lib.scgib_gather_rows.restype = None
    lib.scgib_pack_batch.argtypes = [
        ctypes.c_int32, i64p, i64p, i64p, i64p, i64p,
        f32p, ctypes.c_int32, i32p, i32p, i32p, i32p, i32p, i32p,
        f32p, i32p, i8p, i32p, i32p, i8p,
        i32p, i32p, i8p, i32p, i32p, i8p,
        i64p, ctypes.c_int32]
    lib.scgib_pack_batch.restype = None
    lib.scgib_version.argtypes = []
    lib.scgib_version.restype = ctypes.c_int32
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first where it is not on disk yet.
    Raises ``NativeCompileError`` where it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            so = so_path()
            if not so.exists():
                _build(so)
            _lib = _bind(ctypes.CDLL(str(so)))
        return _lib


def _threads(cap: int) -> int:
    return min(os.cpu_count() or 1, cap)


def extract_egonets_batch(graphs: Sequence[GraphData], k: int,
                          n_threads: Optional[int] = None
                          ) -> List[EgoNets]:
    """Threaded C++ k-hop ego-net extraction: the output of
    ``[egonet.extract_egonets(g, k) for g in graphs]`` (center-first
    ascending node lists, induced edges in original edge order)."""
    lib = load()
    n_threads = _threads(16) if n_threads is None else n_threads
    n_graphs = len(graphs)
    node_off = np.zeros(n_graphs + 1, np.int64)
    edge_off = np.zeros(n_graphs + 1, np.int64)
    for i, g in enumerate(graphs):
        node_off[i + 1] = node_off[i] + g.num_nodes
        edge_off[i + 1] = edge_off[i] + g.num_edges
    senders = np.ascontiguousarray(
        np.concatenate([g.senders for g in graphs]) if n_graphs else
        np.zeros(0), dtype=np.int32)
    receivers = np.ascontiguousarray(
        np.concatenate([g.receivers for g in graphs]) if n_graphs else
        np.zeros(0), dtype=np.int32)

    total_nodes = int(node_off[-1])
    node_counts = np.zeros(total_nodes, np.int32)
    edge_counts = np.zeros(total_nodes, np.int32)
    lib.scgib_egonet_sizes(n_graphs, node_off, edge_off, senders,
                           receivers, k, node_counts, edge_counts,
                           n_threads)
    node_out_off = np.zeros(total_nodes, np.int64)
    edge_out_off = np.zeros(total_nodes, np.int64)
    if total_nodes:
        np.cumsum(node_counts[:-1], out=node_out_off[1:])
        np.cumsum(edge_counts[:-1], out=edge_out_off[1:])
    out_nodes = np.zeros(int(node_counts.sum()), np.int32)
    out_src = np.zeros(int(edge_counts.sum()), np.int32)
    out_dst = np.zeros(int(edge_counts.sum()), np.int32)
    lib.scgib_egonet_fill(n_graphs, node_off, edge_off, senders, receivers,
                          k, node_out_off, edge_out_off, out_nodes,
                          out_src, out_dst, n_threads)

    result: List[EgoNets] = []
    c = 0
    for g in graphs:
        node_lists, edge_lists = [], []
        for _v in range(g.num_nodes):
            s0 = node_out_off[c]
            q0 = edge_out_off[c]
            node_lists.append(out_nodes[s0:s0 + node_counts[c]])
            edge_lists.append((out_src[q0:q0 + edge_counts[c]],
                               out_dst[q0:q0 + edge_counts[c]]))
            c += 1
        result.append(EgoNets(node_lists=node_lists, edge_lists=edge_lists))
    return result


def pack_batch_native(fd, sel: np.ndarray, caps) -> tuple:
    """The threaded C++ batch packer over a ``FlatDataset``
    (``scgib_pack_batch``): the padded arrays of a batch and the real
    counts (nodes, edges, sub-nodes, sub-edges), the tuple the JAX
    package's ``data/flat.py::_pack_numpy`` returns, bit for bit."""
    lib = load()
    sel = np.ascontiguousarray(sel, np.int64)
    F = fd.feat.shape[1]
    node_feat = np.zeros((caps.nodes, F), np.float32)
    node_graph = np.zeros(caps.nodes, np.int32)
    node_mask = np.zeros(caps.nodes, bool)
    senders = np.zeros(caps.edges, np.int32)
    receivers = np.zeros(caps.edges, np.int32)
    edge_mask = np.zeros(caps.edges, bool)
    node_center = np.zeros(caps.sub_nodes, np.int32)
    node_orig = np.zeros(caps.sub_nodes, np.int32)
    sub_node_mask = np.zeros(caps.sub_nodes, bool)
    sub_s = np.zeros(caps.sub_edges, np.int32)
    sub_r = np.zeros(caps.sub_edges, np.int32)
    sub_edge_mask = np.zeros(caps.sub_edges, bool)
    used = np.zeros(4, np.int64)
    lib.scgib_pack_batch(
        len(sel), sel, fd.node_off, fd.edge_off, fd.ego_node_off,
        fd.ego_edge_off, fd.feat, F, fd.senders, fd.receivers,
        fd.ego_nodes, fd.ego_center, fd.ego_senders, fd.ego_receivers,
        node_feat, node_graph, node_mask.view(np.int8),
        senders, receivers, edge_mask.view(np.int8),
        node_center, node_orig, sub_node_mask.view(np.int8),
        sub_s, sub_r, sub_edge_mask.view(np.int8), used, _threads(8))
    return (node_feat, node_graph, node_mask, senders, receivers,
            edge_mask, node_center, node_orig, sub_node_mask, sub_s,
            sub_r, sub_edge_mask, int(used[0]), int(used[1]),
            int(used[2]), int(used[3]))


def gather_rows(feat: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``feat[idx]`` by one ``memcpy`` a row."""
    lib = load()
    feat = np.ascontiguousarray(feat, dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    if idx.size and (idx.min() < 0 or idx.max() >= feat.shape[0]):
        raise IndexError(f"row index out of range [0, {feat.shape[0]})")
    out = np.empty((idx.shape[0], feat.shape[1]), np.float32)
    lib.scgib_gather_rows(feat, feat.shape[1], idx, idx.shape[0], out)
    return out
