"""The port's wire format (``scgib_tpu_torch/graph/wire.py``) against the
JAX package's (``scgib_tpu/graph/wire.py``): the round trip in both modes
(every real entry and every mask exact, padded indices in range), the
overflow of the compact encoding, the wire pairs and superbatch buffers
byte-equal to the JAX package's, and the JAX ``unpack_bytes`` of the
port's buffer giving the JAX batches.

The JAX side packs with its NumPy flat packer (its native library is left
unloaded: ``tests/test_native.py`` builds that one, in place, and a second
process building it could hand it half a file)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import scgib_tpu.native
from scgib_tpu.data import loader as jloader
from scgib_tpu.data.synthetic import random_dataset as jrandom_dataset
from scgib_tpu.graph import wire as jwire

from scgib_tpu_torch.data import loader
from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph import wire
from scgib_tpu_torch.graph.batching import pack_graphs, pack_subgraphs
from scgib_tpu_torch.graph.egonet import extract_egonets


@pytest.fixture(autouse=True)
def _jax_numpy_packers(monkeypatch):
    monkeypatch.setattr(scgib_tpu.native, "_load", lambda: None)


def _batch(n_graphs=8, seed=0, labels=False, lo=6, hi=12):
    graphs = random_dataset(n_graphs, seed=seed, min_nodes=lo, max_nodes=hi,
                            num_tasks=3 if labels else None,
                            label_nan_frac=0.2 if labels else 0.0)
    egos = [extract_egonets(g, 1) for g in graphs]
    return (pack_graphs(graphs, 128, 512, n_graphs),
            pack_subgraphs(graphs, egos, 512, 2048, num_centers=128))


def _device(w):
    return dataclasses.replace(w, **{
        f.name: torch.from_numpy(np.asarray(getattr(w, f.name)))
        for f in dataclasses.fields(w)
        if isinstance(getattr(w, f.name), (np.ndarray, np.generic))})


def _assert_real_entries_equal(got, want, exact_padding, n_cap=128):
    """``got`` (a tensor batch) against ``want`` (the packer's NumPy
    batch): masks, flags and every real entry equal; padded indices in
    range (``n_cap``: the graph batch's node capacity), and equal too where
    ``exact_padding``."""
    ref = want.to("cpu")
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if not isinstance(b, torch.Tensor):
            assert a == b, f.name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        if exact_padding or f.name not in ("senders", "receivers",
                                           "node_center", "node_orig"):
            assert torch.equal(a, b), f.name
            continue
        mask = ref.edge_mask if f.name in ("senders", "receivers") \
            else ref.node_mask
        assert torch.equal(a[mask], b[mask]), f.name
        cap = (ref.node_mask.shape[0] if f.name in ("senders", "receivers")
               else n_cap)
        assert int(a.min()) >= 0 and int(a.max()) < cap, f.name


@pytest.mark.parametrize("compact", [False, True])
def test_round_trip(compact):
    g, sub = _batch(seed=5, labels=True)
    g2 = wire.from_wire_graph(_device(wire.to_wire_graph(g, compact)))
    sub2 = wire.from_wire_sub(_device(wire.to_wire_sub(sub, compact)))
    _assert_real_entries_equal(g2, g, not compact)
    _assert_real_entries_equal(sub2, sub, not compact)
    assert sub2.pool_fits is sub.pool_fits is True


@pytest.mark.parametrize("seed,lo,hi", [(0, 4, 10), (1, 10, 30),
                                        (2, 25, 33)])
def test_compact_round_trip_many_shapes(seed, lo, hi):
    ds = loader.GraphDataset(random_dataset(40, seed=seed, min_nodes=lo,
                                            max_nodes=hi), k=1)
    assert loader.wire_compact_ok(ds)
    caps = loader.plan_capacities(ds, 16)
    for g, sub in loader.batch_iterator(ds, 16, caps, seed=seed):
        _assert_real_entries_equal(
            wire.from_wire_graph(_device(wire.to_wire_graph(g, True))), g,
            False)
        _assert_real_entries_equal(
            wire.from_wire_sub(_device(wire.to_wire_sub(sub, True))), sub,
            False, caps.nodes)


@pytest.mark.parametrize("compact", [False, True])
def test_wire_pairs_equal_jax(compact):
    """The port's wire pair of a batch holds the JAX wire pair's leaves,
    in the JAX flatten order, with its dtypes and values."""
    g, sub = _batch(seed=3, labels=True)
    ours = (wire.to_wire_graph(g, compact), wire.to_wire_sub(sub, compact))
    theirs = (jwire.to_wire_graph(g, compact),
              jwire.to_wire_sub(sub, compact))
    a, b = wire._flatten(ours), jax.tree_util.tree_leaves(theirs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    spec, jspec = wire.byte_spec_of(ours), jwire.byte_spec_of(theirs)
    assert spec.leaves == jspec.leaves and spec.total == jspec.total
    np.testing.assert_array_equal(wire.pack_bytes(ours, spec),
                                  jwire.pack_bytes(theirs, jspec))


def test_compact_overflow_raises():
    graphs = random_dataset(2, seed=1, min_nodes=150, max_nodes=180)
    g = pack_graphs(graphs, 512, 4096, 2)
    with pytest.raises(wire.CompactOverflow):
        wire.to_wire_graph(g, compact=True)
    big = loader.GraphDataset(graphs, k=1)
    assert not loader.wire_compact_ok(big)


def test_compact_ok_refuses_edgeless_graphs():
    from scgib_tpu_torch.graph.batching import GraphData

    ok = GraphData(senders=np.asarray([0, 1], np.int32),
                   receivers=np.asarray([1, 0], np.int32),
                   node_feat=np.zeros((2, 9), np.float32))
    lone = GraphData(senders=np.zeros(0, np.int32),
                     receivers=np.zeros(0, np.int32),
                     node_feat=np.zeros((3, 9), np.float32))
    assert loader.wire_compact_ok(loader.GraphDataset([ok, ok], k=1))
    assert not loader.wire_compact_ok(loader.GraphDataset([ok, lone, ok],
                                                          k=1))


def test_feature_compression_is_exact_or_skipped():
    g, _ = _batch()
    assert wire.to_wire_graph(g).node_feat.dtype == np.int8
    g.node_feat = g.node_feat + 0.5
    assert wire.to_wire_graph(g).node_feat.dtype == np.float32


@pytest.mark.parametrize("compact", [False, True])
def test_superbatch_buffers_equal_jax(compact):
    """``wire_superbatches`` gives the JAX package's buffers, byte for
    byte, for the same dataset, seed and K (the port's native flat packer
    against the JAX package's flat packer), and the K pooling flags of
    the packers; the JAX ``unpack_bytes`` of the port's buffer and its
    decode give the JAX package's batches."""
    K, B = 3, 16
    graphs = random_dataset(120, seed=9, min_nodes=6, max_nodes=20)
    ds = loader.GraphDataset(graphs, k=1)
    jds = jloader.GraphDataset(jrandom_dataset(120, seed=9, min_nodes=6,
                                               max_nodes=20), k=1)
    caps = loader.plan_capacities(ds, B)
    jcaps = jloader.plan_capacities(jds, B)
    assert dataclasses.asdict(caps) == dataclasses.asdict(jcaps)
    spec = loader.superbatch_spec(ds, B, caps, K, compact=compact)
    jspec = jloader.superbatch_spec(jds, B, jcaps, K, compact=compact)
    assert spec.leaves == jspec.leaves and spec.total == jspec.total
    ours = list(loader.wire_superbatches(ds, B, caps, K, seed=4,
                                         workers=2, byte_spec=spec,
                                         compact=compact))
    theirs = list(jloader.wire_superbatches(jds, B, jcaps, K, seed=4,
                                            byte_spec=jspec,
                                            compact=compact))
    assert len(ours) == len(theirs) == (120 // B) // K
    plans = loader.plan_batches(ds, B, caps, seed=4)
    for i, ((buf, edges, fits), (jbuf, jedges)) in enumerate(
            zip(ours, theirs)):
        assert edges == jedges
        np.testing.assert_array_equal(buf, np.asarray(jbuf))
        sels = plans[i * K:(i + 1) * K]
        assert fits is all(loader.pack_batch(ds, s, caps)[1].pool_fits
                           for s in sels)
        jgs, jsubs = jwire.unpack_bytes(jax.numpy.asarray(buf), jspec)
        gs, subs = wire.unpack_bytes(torch.from_numpy(buf), spec)
        for k in range(K):
            jg = jwire.from_wire_graph(jax.tree_util.tree_map(
                lambda a: a[k], jgs))
            jsub = jwire.from_wire_sub(jax.tree_util.tree_map(
                lambda a: a[k], jsubs))
            g = wire.from_wire_graph(wire.index_wire(gs, k))
            sub = wire.from_wire_sub(wire.index_wire(subs, k))
            for ours_b, jb in ((g, jg), (sub, jsub)):
                for f in dataclasses.fields(jb):
                    a, b = getattr(ours_b, f.name, None), getattr(jb, f.name)
                    if b is None or isinstance(b, bool):
                        assert a == b, f.name
                    else:
                        np.testing.assert_array_equal(
                            a.numpy(), np.asarray(b), err_msg=f.name)


def test_unpack_gives_views_of_one_buffer():
    g, sub = _batch(seed=2)
    group = [(wire.to_wire_graph(g, True), wire.to_wire_sub(sub, True))] * 2
    tree = loader._stack_group(group)
    spec = wire.byte_spec_of(tree)
    buf = wire.pack_bytes_grouped(group, spec)
    np.testing.assert_array_equal(buf, wire.pack_bytes(tree, spec))
    t = torch.from_numpy(buf)
    gs, subs = wire.unpack_bytes(t, spec)
    base = t.untyped_storage().data_ptr()
    for w in (gs, subs):
        for name, leaf in wire._leaves(w):
            assert leaf.untyped_storage().data_ptr() == base, name
    assert subs.pool_fits is None and tree[1].pool_fits == (True, True)
    with pytest.raises(ValueError, match="uint8 buffer"):
        wire.unpack_bytes(t[:-4], spec)
