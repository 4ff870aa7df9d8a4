"""Host-side data pipeline: dataset, capacity planning, batch iteration,
wire superbatches and prefetch to the device.

Counterpart of ``scgib_tpu/data/loader.py``.  Ego-nets come from the native
library's threaded extraction (``native.extract_egonets_batch``, the output of
the NumPy BFS of ``graph/egonet.py``; it raises where the library cannot be
built); batches, labels included, from the native flat packer
(``use_flat=True``, the default as in the JAX package, ``data/flat.py``: it
raises where the library cannot be built) or, where the caller asks
(``use_flat=False``), the per-graph NumPy packers, bit-equal to it;
``GraphDataset.subset`` and ``split`` cut a
dataset.  With ``logm_k`` a batch carries the block-diagonal k-step
transition targets of the logM reconstruction loss
(``graph/transition.py``).  ``batch_iterator(workers=n)`` packs on a
thread pool and yields in order.

``wire_superbatches`` turns K packed batches into the wire format
(``graph/wire.py``) and serializes them into one uint8 buffer, the JAX
package's bytes; ``prefetch_to_device`` moves items onto the card ahead of
use (pinned host buffers, copies on a side stream the consumer's stream
waits for); ``background_iter`` runs an iterator in a thread.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graph.banded import band_width, gt_band_fits
from ..graph.batching import (BucketSpec, EgoNets, GraphData, pack_graphs,
                              pack_subgraphs)
from ..graph.container import GraphBatch, SubgraphBatch, _Batch
from ..graph.transition import (pack_logm_targets, transition_logm,
                                transition_logm_batched)


@dataclasses.dataclass
class GraphDataset:
    """Host graphs with their k-hop ego-nets (extracted on construction,
    by the native library)."""

    graphs: List[GraphData]
    k: int = 1
    egonets: Optional[List[EgoNets]] = None

    def __post_init__(self):
        if self.egonets is None:
            from ..native import extract_egonets_batch

            self.egonets = extract_egonets_batch(self.graphs, self.k)

    def __len__(self) -> int:
        return len(self.graphs)

    def subset(self, indices: Sequence[int]) -> "GraphDataset":
        return GraphDataset(graphs=[self.graphs[i] for i in indices],
                            k=self.k,
                            egonets=[self.egonets[i] for i in indices])

    def split(self, n_train: int, n_val: int,
              shuffle_seed: Optional[int] = None):
        """(train, val, test): the reference's prefix slices
        (molecules.py:211-343) after an optional shuffle with
        ``shuffle_seed`` (exp_*BACE_BBBP.py:276)."""
        idx = np.arange(len(self))
        if shuffle_seed is not None:
            np.random.default_rng(shuffle_seed).shuffle(idx)
        return (self.subset(idx[:n_train]),
                self.subset(idx[n_train:n_train + n_val]),
                self.subset(idx[n_train + n_val:]))

    def num_tasks(self) -> Optional[int]:
        """The longest label of the dataset's graphs (None without
        labels), kept: every batch's ``labels`` get that many columns."""
        if not hasattr(self, "_num_tasks"):
            sizes = [np.atleast_1d(g.label).shape[0] for g in self.graphs
                     if g.label is not None]
            self._num_tasks = max(sizes) if sizes else None
        return self._num_tasks

    def flat(self):
        """The ``FlatDataset`` view (``data/flat.py``), built once and
        kept."""
        fd = getattr(self, "_flat", None)
        if fd is None:
            from .flat import build_flat

            fd = self._flat = build_flat(self)
        return fd

    def logms(self, k: int) -> List[List[np.ndarray]]:
        """Each graph's [logM_1 .. logM_k], computed once for ``k`` and
        kept (the batched form from 32 graphs on, as in the JAX
        package)."""
        cache = getattr(self, "_logms", None)
        if cache is None or cache[0] != k:
            if len(self.graphs) >= 32:
                cache = (k, transition_logm_batched(self.graphs, k))
            else:
                cache = (k, [transition_logm(g, k) for g in self.graphs])
            self._logms = cache
        return cache[1]


@dataclasses.dataclass(frozen=True)
class Capacities:
    nodes: int
    edges: int
    graphs: int
    sub_nodes: int
    sub_edges: int


def _sizes(ds: GraphDataset):
    """Per-graph (nodes, edges, sub-nodes, sub-edges), computed once and
    kept on ``ds`` (every epoch's plan reads them)."""
    sizes = getattr(ds, "_size_arrays", None)
    if sizes is None:
        sizes = ds._size_arrays = (
            np.array([g.num_nodes for g in ds.graphs], np.int64),
            np.array([g.num_edges for g in ds.graphs], np.int64),
            np.array([sum(len(nl) for nl in ego.node_lists)
                      for ego in ds.egonets], np.int64),
            np.array([sum(len(el[0]) for el in ego.edge_lists)
                      for ego in ds.egonets], np.int64))
    return sizes


def plan_capacities(ds: GraphDataset, batch_size: int,
                    bucket: BucketSpec = BucketSpec(),
                    safety: float = 1.1) -> Capacities:
    """Buffer sizes that fit a random ``batch_size`` sample: batch_size x
    mean + 3 sigma of the sum (sigma x sqrt(batch_size)), floored at the
    largest graph, times ``safety``, rounded to bucket multiples."""
    n, e, sn, se = _sizes(ds)

    def cap(arr):
        arr = arr.astype(np.float64)
        est = batch_size * arr.mean() + 3.0 * arr.std() * np.sqrt(batch_size)
        return int(max(est, arr.max()) * safety)

    return Capacities(
        nodes=bucket.nodes(cap(n)),
        edges=bucket.edges(cap(np.maximum(e, 1))),
        graphs=bucket.graphs(batch_size),
        sub_nodes=bucket.nodes(cap(sn)),
        sub_edges=bucket.edges(cap(np.maximum(se, 1))),
    )


def plan_batches(ds: GraphDataset, batch_size: int, caps: Capacities,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False) -> List[np.ndarray]:
    """Index selections per batch, greedily shrunk to fit ``caps``."""
    order = np.arange(len(ds))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n, e, sn, se = _sizes(ds)
    plans: List[np.ndarray] = []
    i = 0
    while i < len(order):
        take = min(batch_size, len(order) - i)
        if drop_last and take < batch_size:
            break
        while take > 1:
            sel = order[i:i + take]
            if (n[sel].sum() <= caps.nodes and e[sel].sum() <= caps.edges
                    and sn[sel].sum() <= caps.sub_nodes
                    and se[sel].sum() <= caps.sub_edges):
                break
            take -= 1
        plans.append(order[i:i + take])
        i += take
    return plans


def pack_batch(ds: GraphDataset, sel: Sequence[int], caps: Capacities,
               logm_k: Optional[int] = None, use_flat: bool = False
               ) -> Tuple[GraphBatch, SubgraphBatch]:
    """Pack the graphs ``sel`` of ``ds``.  ``gt_fits`` and the band widths
    come from the dataset's largest graph and ego-net (computed once, kept
    on ``ds``), so they are the same for every batch of the dataset;
    ``pool_fits`` is the batch's own.  Labels take the dataset's task
    count (the JAX package's flat packer does the same).  ``use_flat``:
    the native flat packer (``data/flat.py``), else the per-graph NumPy
    packers.  ``logm_k``: attach the k-step logM targets and weights to
    the GraphBatch."""
    graphs = [ds.graphs[j] for j in sel]
    if use_flat:
        from .flat import pack_flat_batch

        g, sub = pack_flat_batch(ds.flat(), sel, caps,
                                 num_tasks=ds.num_tasks())
    else:
        egos = [ds.egonets[j] for j in sel]
        maxima = getattr(ds, "_gt_maxima", None)
        if maxima is None:
            maxima = (max((g.num_nodes for g in ds.graphs), default=0),
                      max((len(nl) for ego in ds.egonets
                           for nl in ego.node_lists), default=0))
            ds._gt_maxima = maxima
        g = pack_graphs(graphs, caps.nodes, caps.edges, caps.graphs,
                        num_tasks=ds.num_tasks(),
                        gt_fits=gt_band_fits(maxima[0], caps.nodes),
                        band_width=band_width(maxima[0]))
        sub = pack_subgraphs(graphs, egos, caps.sub_nodes, caps.sub_edges,
                             gt_fits=gt_band_fits(maxima[1], caps.sub_nodes),
                             num_centers=caps.nodes,
                             band_width=band_width(maxima[1]))
    if logm_k:
        logms = ds.logms(logm_k)
        T, W = pack_logm_targets(graphs, [logms[j] for j in sel], caps.nodes,
                                 logm_k)
        g = dataclasses.replace(g, logm_targets=T, logm_weights=W)
    return g, sub


def batch_iterator(ds: GraphDataset, batch_size: int, caps: Capacities,
                   shuffle: bool = True, seed: int = 0,
                   drop_last: bool = False, workers: int = 0,
                   use_flat: bool = True, logm_k: Optional[int] = None,
                   transform: Optional[Callable] = None) -> Iterator:
    """Yield packed (GraphBatch, SubgraphBatch) pairs of NumPy arrays;
    the JAX package's parameters, in its order and with its defaults.

    ``use_flat`` (the default): pack with the native flat packer (it
    raises where the library cannot be built); ``False``: the per-graph
    NumPy packers, bit-equal to it.
    ``workers`` > 0: pack up to ``2 * workers`` batches ahead on a thread
    pool of that many threads, yielding in order.  ``transform`` (a
    function of the pair) runs inside those tasks, and its result is what
    is yielded (``wire_superbatches`` serializes there)."""
    plans = plan_batches(ds, batch_size, caps, shuffle, seed, drop_last)
    if use_flat:
        ds.flat()            # built once, outside the worker threads
    if logm_k:
        ds.logms(logm_k)

    def work(sel):
        b = pack_batch(ds, sel, caps, logm_k, use_flat)
        return transform(b) if transform is not None else b

    if workers <= 0:
        for sel in plans:
            yield work(sel)
        return
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending: deque = deque()
        it = iter(plans)
        for sel in it:
            pending.append(pool.submit(work, sel))
            if len(pending) >= 2 * workers:
                break
        for sel in it:
            yield pending.popleft().result()
            pending.append(pool.submit(work, sel))
        while pending:
            yield pending.popleft().result()


# --- background threads and the copies to the device --------------------------

_END = object()


def _drain(q: "queue.Queue", stop: threading.Event):
    stop.set()
    while True:
        try:
            q.get_nowait()
        except queue.Empty:
            return


def _threaded(produce: Callable[[Callable], None], size: int) -> Iterator:
    """Run ``produce(put)`` in a daemon thread, yielding what it puts, up
    to ``size`` items ahead.  An exception in the thread is raised at the
    consumer; a consumer that stops early stops the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=max(size, 1))
    stop = threading.Event()
    err: list = []

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            produce(put)
        except BaseException as e:   # noqa: BLE001 (raised at the consumer)
            err.append(e)
        finally:
            put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        _drain(q, stop)
        t.join(timeout=10)


def background_iter(it: Iterator, size: int = 2) -> Iterator:
    """Drive ``it`` in a daemon thread, buffering up to ``size`` items; an
    exception in it is raised at the consumer."""
    def produce(put):
        for item in it:
            if not put(item):
                return
    return _threaded(produce, size)


def _host_tensors(item):
    """(tensors, rebuild): the arrays of ``item`` as host tensors of the
    dtypes the device takes (a batch's fields as ``.to`` converts them,
    other arrays as they are), and a function that rebuilds ``item`` with
    other tensors in their place.  Tuples and lists are walked; anything
    else (counts, flags) passes through."""
    if isinstance(item, _Batch):
        b = item.to("cpu")
        names = [f.name for f in dataclasses.fields(b)
                 if isinstance(getattr(b, f.name), torch.Tensor)]
        return ([getattr(b, n) for n in names],
                lambda ts: dataclasses.replace(b, **dict(zip(names, ts))))
    if isinstance(item, np.ndarray):
        return [torch.from_numpy(np.ascontiguousarray(item))], \
            lambda ts: ts[0]
    if isinstance(item, torch.Tensor):
        return [item], lambda ts: ts[0]
    if isinstance(item, (tuple, list)):
        parts = [_host_tensors(x) for x in item]
        sizes = [len(ts) for ts, _ in parts]

        def rebuild(ts):
            out, i = [], 0
            for (_, fn), n in zip(parts, sizes):
                out.append(fn(ts[i:i + n]))
                i += n
            return type(item)(out)
        return [t for ts, _ in parts for t in ts], rebuild
    return [], lambda ts: item


class _PinnedRing:
    """``slots`` sets of pinned host buffers used in turn; a slot is
    rewritten only after the copies out of it (its event) have
    finished."""

    def __init__(self, slots: int):
        self.buffers: List[List[torch.Tensor]] = [[] for _ in range(slots)]
        self.events: List[Optional[torch.cuda.Event]] = [None] * slots
        self.turn = 0

    def stage(self, tensors: List[torch.Tensor]):
        """(slot, pinned copies of ``tensors``)."""
        slot = self.turn
        self.turn = (self.turn + 1) % len(self.buffers)
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        bufs = self.buffers[slot]
        for i, t in enumerate(tensors):
            if (i >= len(bufs) or bufs[i].shape != t.shape
                    or bufs[i].dtype != t.dtype):
                pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                if i < len(bufs):
                    bufs[i] = pinned
                else:
                    bufs.append(pinned)
            bufs[i].copy_(t)
        return slot, bufs[:len(tensors)]


def prefetch_to_device(it: Iterator, size: int = 2, device="cuda",
                       host_stage: int = 0) -> Iterator:
    """Move the items of ``it`` onto ``device`` in a background thread,
    up to ``size`` items ahead of the consumer.

    On the card each item's arrays are copied into pinned host buffers
    (a ring of ``size + 1`` sets, each reused only after the copies out
    of it have finished), then to the device with ``copy_(non_blocking=
    True)`` on a side stream; an event recorded after them is waited on by
    the consumer's stream before the item is yielded, and the device
    tensors are ``record_stream``-ed on that stream.  Elsewhere the items
    are converted in the thread.  ``host_stage`` > 0 runs ``it`` (packing,
    serialization) in a thread of its own with that buffer depth, so this
    thread only copies.  Batches are converted as ``.to`` converts them;
    arrays keep their dtype; counts and flags pass through.  An exception
    in either thread is raised at the consumer."""
    device = torch.device(device)
    if host_stage > 0:
        it = background_iter(it, size=host_stage)
    if device.type != "cuda":
        def produce(put):
            for item in it:
                ts, rebuild = _host_tensors(item)
                if not put(rebuild([t.to(device) for t in ts])):
                    return
        return _threaded(produce, size)

    side = torch.cuda.Stream(device)
    ring = _PinnedRing(size + 1)

    def produce(put):
        with torch.cuda.device(device):
            for item in it:
                ts, rebuild = _host_tensors(item)
                slot, pinned = ring.stage(ts)
                with torch.cuda.stream(side):
                    out = [torch.empty(t.shape, dtype=t.dtype, device=device)
                           for t in pinned]
                    for o, t in zip(out, pinned):
                        o.copy_(t, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(side)
                ring.events[slot] = done
                if not put((rebuild(out), out, done)):
                    return

    def consume():
        inner = _threaded(produce, size)
        try:
            for item, tensors, done in inner:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(done)
                for t in tensors:
                    t.record_stream(stream)
                yield item
        finally:
            inner.close()
    return consume()


# --- the wire format's superbatches -------------------------------------------

def wire_compact_ok(ds: GraphDataset) -> bool:
    """True when every possible batch of ``ds`` fits the compact
    (delta / offset) wire encoding (``graph/wire.py``): int8 sender
    offsets need |sender - receiver| <= 127, bounded by the largest graph
    and ego-net; uint8 receiver deltas need every gap between consecutive
    edge-receiving rows <= 255 in any graph order, checked from each
    graph's internal gaps and the worst boundary between two graphs
    (suffix + prefix + 1).  A graph with no edges makes that boundary
    unbounded, so it disqualifies."""
    if not ds.graphs:
        return False
    max_n = max(g.num_nodes for g in ds.graphs)
    max_ego = max((len(nl) for ego in ds.egonets
                   for nl in ego.node_lists), default=0)
    if max_n > 120 or max_ego > 120:
        return False

    def gap_stats(receivers, region):
        if len(receivers) == 0:
            return None
        r = np.unique(np.asarray(receivers, np.int64))
        internal = int(np.diff(r).max()) if len(r) > 1 else 0
        return internal, int(r[0]), int(region - 1 - r[-1])

    def family_ok(per_graph):
        internal = prefix = suffix = 0
        for st in per_graph:
            if st is None:
                return False
            internal = max(internal, st[0])
            prefix = max(prefix, st[1])
            suffix = max(suffix, st[2])
        return internal <= 255 and (suffix + prefix + 1) <= 255

    node_stats = [gap_stats(g.receivers, g.num_nodes) for g in ds.graphs]
    sub_stats = []
    for ego in ds.egonets:
        f = ego.flat()
        sub_stats.append(gap_stats(f.receivers, int(f.node_off[-1])))
    return family_ok(node_stats) and family_ok(sub_stats)


def _wire_pair(compact: bool):
    """The host function that turns a packed pair into its wire pair;
    logM targets are refused (O(k N^2) a batch: ship them per batch)."""
    from ..graph.wire import to_wire_graph, to_wire_sub

    def to_wire(b):
        g, sub = b
        if g.logm_targets is not None:
            raise ValueError("wire superbatches do not carry logM targets "
                             "(O(k N^2): ship per batch instead, "
                             "superbatch_k=0 with recons_type='logM')")
        return (to_wire_graph(g, compact=compact),
                to_wire_sub(sub, compact=compact))
    return to_wire


def _stack_group(group):
    """The stacked (WireGraph, WireSub) of a group of wire pairs."""
    from ..graph.wire import stack_pytrees

    return (stack_pytrees([w for w, _ in group]),
            stack_pytrees([v for _, v in group]))


def wire_superbatches(ds: GraphDataset, batch_size: int, caps: Capacities,
                      super_k: int, shuffle: bool = True, seed: int = 0,
                      workers: int = 4, logm_k: Optional[int] = None,
                      byte_spec=None, compact: Optional[bool] = None,
                      epochs: int = 1) -> Iterator:
    """Yield ``(buf, real_edges, pool_fits)`` superbatches.

    K = ``super_k`` batches packed by the native flat packer (``workers``
    threads) are turned into the wire format in the packing tasks and
    written into ONE uint8 buffer (``pack_bytes_grouped``): the JAX
    package's bytes for the same dataset, seed and K.  ``pool_fits``:
    whether every one of the K batches fits the banded pooling's window,
    a flag the buffer does not carry (``graph/wire.py``); one flag for
    all K, so a superbatch step captures at most two graphs.
    ``real_edges`` counts the graphs' and ego-nets' edges.  ``byte_spec``
    (``superbatch_spec``) is computed from the first group if not given;
    ``compact=None`` takes the compact encoding where
    ``wire_compact_ok``.  ``epochs`` > 1 chains that many epochs (seeds
    ``seed``, ``seed + 1``, ...) before grouping, as ``bench.py``'s
    sustained loop does over a small pool.  A trailing group of fewer
    than K batches is dropped."""
    from ..graph.wire import byte_spec_of, pack_bytes_grouped

    if compact is None:
        compact = wire_compact_ok(ds)
    group = []
    for wpair in (w for e in range(epochs) for w in batch_iterator(
            ds, batch_size, caps, shuffle=shuffle, seed=seed + e,
            workers=workers, logm_k=logm_k, use_flat=True,
            transform=_wire_pair(compact))):
        group.append(wpair)
        if len(group) < super_k:
            continue
        edges = int(sum(int(w.n_edges) + int(v.n_edges) for w, v in group))
        if byte_spec is None:
            byte_spec = byte_spec_of(_stack_group(group))
        yield (pack_bytes_grouped(group, byte_spec), edges,
               all(v.pool_fits for _, v in group))
        group = []


def superbatch_spec(ds: GraphDataset, batch_size: int, caps: Capacities,
                    super_k: int, logm_k: Optional[int] = None,
                    compact: Optional[bool] = None, epochs: int = 1):
    """The ``ByteSpec`` of ``wire_superbatches``'s buffers, for
    ``make_pretrain_superbatch_step``: from the dataset's first K batches
    in order (over ``epochs`` passes, for ``wire_superbatches(epochs=
    ...)`` over a pool of fewer than K batches)."""
    from ..graph.wire import byte_spec_of

    if compact is None:
        compact = wire_compact_ok(ds)
    to_wire = _wire_pair(compact)
    group = []
    for b in (b for _ in range(epochs) for b in batch_iterator(
            ds, batch_size, caps, shuffle=False, logm_k=logm_k)):
        group.append(to_wire(b))
        if len(group) == super_k:
            break
    if len(group) < super_k:
        raise ValueError(f"dataset too small for super_k={super_k}: "
                         f"{len(group)} batches of {batch_size}")
    return byte_spec_of(_stack_group(group))
