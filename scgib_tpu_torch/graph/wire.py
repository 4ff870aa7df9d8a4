"""Compact wire format for the host-to-device copy of packed batches.

Counterpart of ``scgib_tpu/graph/wire.py``.  A padded batch is mostly
int32 index arrays, bool masks and float32 categorical features, all
compressible without loss:

  * index arrays become int16 where the capacity allows;
  * masks become counts: the packers write real entries as a prefix, so
    ``arange(cap) < count`` rebuilds them on the device;
  * float32 features become int8 where every value is an integer in
    [-127, 127] (atom features are small categorical codes);
  * ``compact=True``: sorted receivers (and sub-node centers) become uint8
    deltas and senders (and original nodes) int8 offsets from them, 2
    bytes an edge instead of 4.  Padding decodes as self-loops on the last
    real receiver with mask 0; the device's band build is a scatter-add
    that routes masked edges nowhere, and every other consumer weights
    edges by the mask.

``to_wire_graph`` and ``to_wire_sub`` run in NumPy on the host;
``from_wire_graph`` and ``from_wire_sub`` in torch on the device, giving
the dtypes ``GraphBatch.to`` gives (int64 indices, bool masks, float32
features) and reading no count back to the host (a CUDA graph captures
them).  ``WireGraph`` and ``WireSub`` hold arrays or tensors.

One superbatch, K wire pairs stacked on a leading axis, travels as ONE
uint8 buffer: ``byte_spec_of`` lays out its leaves (the flatten order of
the JAX package's flax dataclasses: fields in order, ``None`` leaves and
static fields left out; offsets 4-byte aligned), ``pack_bytes`` /
``pack_bytes_grouped`` write it on the host, and ``unpack_bytes`` returns
typed views into the one device tensor, with no copy a leaf.  The bytes
are the JAX package's.  Static fields are ``num_graphs_cap``, ``gt_fits``
(in the spec, as in the JAX treedef), ``band_width`` (the band's width, in
the spec; the JAX package has only 256) and ``WireSub.pool_fits``,
the pooling's branch flag the port's packers set: it is never a leaf, so
the layout stays the JAX one, and a superbatch carries one flag for its K
batches beside its buffer (``data/loader.py::wire_superbatches``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .banded import BAND
from .container import GraphBatch, SubgraphBatch


@dataclasses.dataclass
class WireGraph:
    node_feat: object             # [N, F] int8 | float32
    node_graph: object            # [N] int16 | int32
    senders: Optional[object]     # [E] (absolute mode; None if compact)
    receivers: Optional[object]   # [E]
    n_nodes: object               # [] int32 real-node count
    n_edges: object               # [] int32
    n_graphs: object              # [] int32
    num_graphs_cap: int = 0       # static
    labels: Optional[object] = None
    label_mask: Optional[object] = None
    band_col_off: Optional[object] = None
    edge_rdelta: Optional[object] = None   # [E] uint8 (compact)
    edge_soff: Optional[object] = None     # [E] int8 (compact)
    gt_fits: bool = False         # static
    band_width: int = BAND        # static


@dataclasses.dataclass
class WireSub:
    node_center: Optional[object]   # [S] (absolute mode)
    node_orig: Optional[object]     # [S]
    n_nodes: object                 # [] int32
    senders: Optional[object]       # [Q]
    receivers: Optional[object]     # [Q]
    n_edges: object                 # [] int32
    band_col_off: Optional[object] = None
    center_delta: Optional[object] = None  # [S] uint8 (compact)
    orig_off: Optional[object] = None      # [S] int8 (compact)
    edge_rdelta: Optional[object] = None   # [Q] uint8 (compact)
    edge_soff: Optional[object] = None     # [Q] int8 (compact)
    gt_fits: bool = False           # static
    pool_fits: Optional[bool] = None   # static, never serialized
    band_width: int = BAND          # static


STATIC = {WireGraph: ("num_graphs_cap", "gt_fits", "band_width"),
          WireSub: ("gt_fits", "pool_fits", "band_width")}


class CompactOverflow(ValueError):
    """A value did not fit the compact encoding (a graph too large for
    int8 sender offsets or uint8 receiver deltas): use compact=False."""


def _delta_u8(sorted_vals: np.ndarray, n_real: int, what: str) -> np.ndarray:
    """uint8 deltas of an array sorted over its real prefix; the padding
    tail repeats the last real value (delta 0)."""
    v = _compact_base(sorted_vals, n_real)
    d = np.diff(v, prepend=0)
    if len(d) and (d.min() < 0 or d.max() > 255):
        raise CompactOverflow(
            f"{what}: delta range [{d.min()}, {d.max()}] outside uint8 "
            "(is the array sorted with a real prefix?)")
    return d.astype(np.uint8)


def _off_i8(vals: np.ndarray, base: np.ndarray, n_real: int,
            what: str) -> np.ndarray:
    """int8 offsets ``vals - base``; the padding tail's offsets are 0."""
    v = np.asarray(vals, np.int64).copy()
    b = np.asarray(base, np.int64)
    if n_real < len(v):
        v[n_real:] = b[n_real:]
    o = v - b
    if len(o) and (o.min() < -128 or o.max() > 127):
        raise CompactOverflow(
            f"{what}: offset range [{o.min()}, {o.max()}] outside int8 "
            "(graph larger than the compact wire supports)")
    return o.astype(np.int8)


def _compact_base(sorted_vals: np.ndarray, n_real: int) -> np.ndarray:
    """The sorted array with its padding tail rewritten to the last real
    value: what the deltas rebuild."""
    v = np.asarray(sorted_vals, np.int64).copy()
    if n_real < len(v):
        v[n_real:] = v[n_real - 1] if n_real > 0 else 0
    return v


def _shrink_idx(a: np.ndarray, cap: int) -> np.ndarray:
    return np.asarray(a).astype(np.int16 if cap < 2 ** 15 else np.int32)


def _shrink_feat(feat: np.ndarray) -> np.ndarray:
    f = np.asarray(feat)
    if (f.dtype == np.float32 and np.all(f == np.round(f))
            and np.all(np.abs(f) <= 127)):
        return f.astype(np.int8)
    return f


def _count(mask) -> np.int32:
    return np.int32(np.asarray(mask).sum())


def _host(a):
    return None if a is None else np.asarray(a)


def to_wire_graph(g: GraphBatch, compact: bool = False) -> WireGraph:
    """The wire form of a host (NumPy) GraphBatch.  ``compact=True``
    delta-encodes the edges (2 bytes an edge); raises ``CompactOverflow``
    where a graph is too large for it."""
    n_cap = g.node_feat.shape[0]
    n_edges = _count(g.edge_mask)
    senders = receivers = rdelta = soff = None
    if compact:
        rdelta = _delta_u8(g.receivers, int(n_edges), "graph receivers")
        soff = _off_i8(g.senders, _compact_base(g.receivers, int(n_edges)),
                       int(n_edges), "graph senders")
    else:
        senders = _shrink_idx(g.senders, n_cap)
        receivers = _shrink_idx(g.receivers, n_cap)
    return WireGraph(
        node_feat=_shrink_feat(g.node_feat),
        node_graph=_shrink_idx(g.node_graph, g.graph_mask.shape[0]),
        senders=senders, receivers=receivers,
        n_nodes=_count(g.node_mask), n_edges=n_edges,
        n_graphs=_count(g.graph_mask),
        num_graphs_cap=int(g.graph_mask.shape[0]),
        labels=_host(g.labels), label_mask=_host(g.label_mask),
        band_col_off=_host(g.band_col_off),
        edge_rdelta=rdelta, edge_soff=soff, gt_fits=g.gt_fits,
        band_width=g.band_width)


def to_wire_sub(sub: SubgraphBatch, compact: bool = False) -> WireSub:
    """The wire form of a host (NumPy) SubgraphBatch, whose sub-node
    features are gathered on the device (``node_feat`` None)."""
    if sub.node_feat is not None:
        raise ValueError("wire format expects the node_feat=None "
                         "(derive-on-device) SubgraphBatch layout")
    s_cap = sub.node_center.shape[0]
    n_nodes = _count(sub.node_mask)
    n_edges = _count(sub.edge_mask)
    col_off = _host(sub.band_col_off)
    if compact:
        return WireSub(
            node_center=None, node_orig=None, n_nodes=n_nodes,
            senders=None, receivers=None, n_edges=n_edges,
            band_col_off=col_off,
            center_delta=_delta_u8(sub.node_center, int(n_nodes),
                                   "sub centers"),
            orig_off=_off_i8(sub.node_orig,
                             _compact_base(sub.node_center, int(n_nodes)),
                             int(n_nodes), "sub node_orig"),
            edge_rdelta=_delta_u8(sub.receivers, int(n_edges),
                                  "sub receivers"),
            edge_soff=_off_i8(sub.senders,
                              _compact_base(sub.receivers, int(n_edges)),
                              int(n_edges), "sub senders"),
            gt_fits=sub.gt_fits, pool_fits=sub.pool_fits,
            band_width=sub.band_width)
    # node_center / node_orig index the owning batch's nodes, whose
    # capacity is not at hand: the dtype follows the largest value
    c_max = int(np.asarray(sub.node_center).max(initial=0))
    o_max = int(np.asarray(sub.node_orig).max(initial=0))
    return WireSub(
        node_center=_shrink_idx(sub.node_center, c_max + 1),
        node_orig=_shrink_idx(sub.node_orig, o_max + 1),
        n_nodes=n_nodes,
        senders=_shrink_idx(sub.senders, s_cap),
        receivers=_shrink_idx(sub.receivers, s_cap),
        n_edges=n_edges, band_col_off=col_off,
        gt_fits=sub.gt_fits, pool_fits=sub.pool_fits,
        band_width=sub.band_width)


# --- the device side -----------------------------------------------------------

def _index(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64)


def _decode_delta(rdelta: torch.Tensor, soff: torch.Tensor):
    """(receivers, senders) from the compact encoding.  The cumulative sum
    names its dtype: int64, the index dtype of the port's batches (the
    JAX package casts to int32, its own)."""
    r = torch.cumsum(rdelta, 0, dtype=torch.int64)
    return r, r + soff.to(torch.int64)


def _prefix_mask(cap: int, count: torch.Tensor) -> torch.Tensor:
    """``arange(cap) < count`` with ``count`` a 0-d device tensor: no
    host read."""
    return torch.arange(cap, device=count.device) < count


def _opt(t, fn):
    return None if t is None else fn(t)


def from_wire_graph(w: WireGraph) -> GraphBatch:
    """The GraphBatch of a wire graph of device tensors."""
    if w.edge_rdelta is not None:
        receivers, senders = _decode_delta(w.edge_rdelta, w.edge_soff)
    else:
        senders, receivers = _index(w.senders), _index(w.receivers)
    return GraphBatch(
        node_feat=w.node_feat.to(torch.float32),
        node_graph=_index(w.node_graph),
        node_mask=_prefix_mask(w.node_graph.shape[0], w.n_nodes),
        senders=senders, receivers=receivers,
        edge_mask=_prefix_mask(receivers.shape[0], w.n_edges),
        graph_mask=_prefix_mask(w.num_graphs_cap, w.n_graphs),
        labels=_opt(w.labels, lambda t: t.to(torch.float32)),
        label_mask=_opt(w.label_mask, lambda t: t.to(torch.bool)),
        band_col_off=_opt(w.band_col_off, _index),
        gt_fits=w.gt_fits, band_width=w.band_width)


def from_wire_sub(w: WireSub) -> SubgraphBatch:
    """The SubgraphBatch of a wire sub of device tensors."""
    if w.center_delta is not None:
        node_center = torch.cumsum(w.center_delta, 0, dtype=torch.int64)
        node_orig = node_center + w.orig_off.to(torch.int64)
        receivers, senders = _decode_delta(w.edge_rdelta, w.edge_soff)
    else:
        node_center, node_orig = _index(w.node_center), _index(w.node_orig)
        senders, receivers = _index(w.senders), _index(w.receivers)
    return SubgraphBatch(
        node_feat=None, node_center=node_center, node_orig=node_orig,
        node_mask=_prefix_mask(node_center.shape[0], w.n_nodes),
        senders=senders, receivers=receivers,
        edge_mask=_prefix_mask(senders.shape[0], w.n_edges),
        band_col_off=_opt(w.band_col_off, _index),
        gt_fits=w.gt_fits, pool_fits=w.pool_fits, band_width=w.band_width)


# --- one buffer a superbatch ---------------------------------------------------

def _leaves(w):
    """(name, value) of the serialized fields, in order."""
    static = STATIC[type(w)]
    return [(f.name, getattr(w, f.name)) for f in dataclasses.fields(w)
            if f.name not in static and getattr(w, f.name) is not None]


def _flatten(tree):
    return [v for w in tree for _, v in _leaves(w)]


@dataclasses.dataclass(frozen=True)
class ByteSpec:
    """The layout of a tuple of wire objects serialized into one buffer.
    ``treedef``: (class, serialized field names, static fields other than
    ``pool_fits``) a wire object; ``leaves``: (dtype name, shape, offset,
    bytes) a leaf."""

    treedef: tuple
    leaves: tuple
    total: int


def byte_spec_of(tree: Sequence) -> ByteSpec:
    """The layout of a host (NumPy) tuple of wire objects; offsets are
    4-byte aligned."""
    treedef = tuple(
        (type(w), tuple(name for name, _ in _leaves(w)),
         tuple((s, getattr(w, s)) for s in STATIC[type(w)]
               if s != "pool_fits"))
        for w in tree)
    spec, off = [], 0
    for a in _flatten(tree):
        a = np.asarray(a)
        spec.append((str(a.dtype), tuple(a.shape), off, a.nbytes))
        off += (a.nbytes + 3) // 4 * 4
    return ByteSpec(treedef=treedef, leaves=tuple(spec), total=off)


def pack_bytes(tree: Sequence, spec: ByteSpec) -> np.ndarray:
    """Serialize a host tuple of wire objects into one uint8 buffer."""
    buf = np.zeros(spec.total, np.uint8)
    for a, (dt, shape, off, nb) in zip(_flatten(tree), spec.leaves):
        a = np.asarray(a)
        if str(a.dtype) != dt or a.shape != tuple(shape):
            raise ValueError(f"leaf mismatch: {a.dtype}{a.shape} against "
                             f"the spec's {dt}{shape}")
        buf[off:off + nb] = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
    return buf


def pack_bytes_grouped(group: Sequence, spec: ByteSpec) -> np.ndarray:
    """``pack_bytes`` of the stacked group without stacking it: each
    pair's leaves are written straight into their slice [k] of the
    buffer.  ``spec`` is the stacked group's."""
    flat = [_flatten(t) for t in group]
    k_count = len(group)
    buf = np.zeros(spec.total, np.uint8)
    for i, (dt, shape, off, nb) in enumerate(spec.leaves):
        if shape[0] != k_count:
            raise ValueError(f"spec leaf {i} leads with {shape[0]}, the "
                             f"group holds {k_count}")
        view = buf[off:off + nb].reshape(k_count, nb // k_count)
        for k in range(k_count):
            a = np.ascontiguousarray(np.asarray(flat[k][i])).reshape(-1)
            if str(a.dtype) != dt:
                raise ValueError(f"leaf {i} of pair {k}: {a.dtype} against "
                                 f"the spec's {dt}")
            view[k] = a.view(np.uint8)
    return buf


_TORCH_DTYPES = {"int8": torch.int8, "uint8": torch.uint8,
                 "int16": torch.int16, "int32": torch.int32,
                 "int64": torch.int64, "float32": torch.float32,
                 "bool": torch.bool}


def unpack_bytes(buf: torch.Tensor, spec: ByteSpec) -> tuple:
    """The wire objects of a uint8 buffer, each leaf a typed view into it
    (bool leaves are ``!= 0`` of their bytes; 0-d leaves a view reshaped
    to ``()``)."""
    if buf.dtype != torch.uint8 or buf.shape != (spec.total,):
        raise ValueError(f"expected a uint8 buffer of {spec.total} bytes, "
                         f"got {buf.dtype}{tuple(buf.shape)}")
    leaves = []
    for dt, shape, off, nb in spec.leaves:
        seg = buf[off:off + nb]
        if dt == "bool":
            leaf = seg != 0
        else:
            dtype = _TORCH_DTYPES[dt]
            if off % dtype.itemsize:
                raise ValueError(f"leaf at byte {off} is not aligned to "
                                 f"its {dt} items")
            leaf = seg.view(dtype)
        leaves.append(leaf.reshape(shape))
    out, i = [], 0
    for cls, names, statics in spec.treedef:
        fields = dict(zip(names, leaves[i:i + len(names)]))
        fields.update({f.name: None for f in dataclasses.fields(cls)
                       if f.name not in fields
                       and f.name not in STATIC[cls]})
        out.append(cls(**fields, **dict(statics)))
        i += len(names)
    return tuple(out)


def stack_pytrees(items: Sequence):
    """Items of one dataclass (wire objects or host batches, one batch
    each) stacked on a leading axis: ``np.stack`` of each array field.
    ``None`` fields and the other fields (flags, capacities) must agree,
    except ``pool_fits``, a batch's own flag, which becomes the tuple of
    the items' flags.  The JAX package's ``stack_pytrees``."""
    cls = type(items[0])
    out = {}
    for f in dataclasses.fields(cls):
        vals = [getattr(w, f.name) for w in items]
        if f.name == "pool_fits":
            out[f.name] = tuple(vals)
        elif isinstance(vals[0], (np.ndarray, np.generic)):
            out[f.name] = np.stack([np.asarray(v) for v in vals])
        elif any(v is not vals[0] and v != vals[0] for v in vals):
            raise ValueError(f"{cls.__name__}.{f.name} differs between "
                             "the items")
        else:
            out[f.name] = vals[0]
    return cls(**out)


def index_wire(w, k: int):
    """Item ``k`` of a stacked wire object of tensors (views)."""
    return dataclasses.replace(w, **{
        name: v[k] for name, v in _leaves(w)})
