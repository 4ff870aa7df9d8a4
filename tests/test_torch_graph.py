"""PyTorch port vs the JAX package: synthetic data, ego-nets, packers,
capacity planning, the banded blocks and the batch containers.

Host-side code is a NumPy copy, so everything here is compared exactly
(bit-equal arrays)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scgib_tpu.data import loader as jloader
from scgib_tpu.data.synthetic import random_dataset as jrandom_dataset
from scgib_tpu.graph import banded as jbanded
from scgib_tpu.graph.batching import GraphData as JGraphData
from scgib_tpu.graph.batching import pack_graphs as jpack_graphs
from scgib_tpu.graph.batching import pack_subgraphs as jpack_subgraphs
from scgib_tpu.graph.egonet import egonet_sizes as jegonet_sizes
from scgib_tpu.graph.egonet import extract_egonets as jextract_egonets

from scgib_tpu_torch.data import loader
from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph import banded
from scgib_tpu_torch.graph.batching import (GraphData, pack_graphs,
                                            pack_subgraphs)
from scgib_tpu_torch.graph.container import GraphBatch, SubgraphBatch
from scgib_tpu_torch.graph.egonet import egonet_sizes, extract_egonets
from scgib_tpu_torch.ops.kernels import banded as kb

from block_counts import np_blocks

GRAPH_FIELDS = ("node_feat", "node_graph", "node_mask", "senders",
                "receivers", "edge_mask", "graph_mask", "band_col_off")
SUB_FIELDS = ("node_center", "node_orig", "node_mask", "senders",
              "receivers", "edge_mask", "band_col_off")


def _assert_fields_equal(port, ref, fields):
    for f in fields:
        a, b = getattr(port, f), getattr(ref, f)
        if b is None:
            assert a is None, f
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f)


@pytest.fixture(scope="module")
def graphs():
    return random_dataset(24, seed=31, min_nodes=8, max_nodes=30)


@pytest.fixture(scope="module")
def jgraphs():
    """The same graphs as the JAX package's own GraphData objects."""
    return jrandom_dataset(24, seed=31, min_nodes=8, max_nodes=30)


@pytest.fixture(scope="module")
def packed(graphs):
    egos = [extract_egonets(g, 1) for g in graphs]
    return (pack_graphs(graphs, 768, 4096, 24),
            pack_subgraphs(graphs, egos, 3072, 12288))


@pytest.mark.parametrize("kw", [dict(seed=7, min_nodes=10, max_nodes=30),
                                dict(seed=3, min_nodes=5, max_nodes=9,
                                     feat_dim=5)])
def test_random_dataset_matches(kw):
    port = random_dataset(16, **kw)
    ref = jrandom_dataset(16, **kw)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.senders, b.senders)
        np.testing.assert_array_equal(a.receivers, b.receivers)
        np.testing.assert_array_equal(a.node_feat, b.node_feat)


@pytest.mark.parametrize("k", [1, 2])
def test_extract_egonets_matches(graphs, k):
    for g in graphs[:6]:
        port = extract_egonets(g, k)
        ref = jextract_egonets(g, k)
        for a, b in zip(port.node_lists, ref.node_lists):
            np.testing.assert_array_equal(a, b)
        for (s, r), (js, jr) in zip(port.edge_lists, ref.edge_lists):
            np.testing.assert_array_equal(s, js)
            np.testing.assert_array_equal(r, jr)


@pytest.mark.parametrize("k", [1, 2])
def test_egonet_sizes_match(graphs, jgraphs, k):
    """The sizes without extraction: the JAX function's, and the totals of
    the extracted ego-nets; a graph without edges included."""
    empty = GraphData(senders=np.zeros(0, np.int32),
                      receivers=np.zeros(0, np.int32),
                      node_feat=np.zeros((3, 9), np.float32))
    jempty = JGraphData(senders=empty.senders, receivers=empty.receivers,
                        node_feat=empty.node_feat)
    for g, jg in [*zip(graphs[:6], jgraphs[:6]), (empty, jempty)]:
        got = egonet_sizes(g, k)
        assert got == jegonet_sizes(jg, k)
        egos = extract_egonets(g, k)
        assert got == (sum(len(nl) for nl in egos.node_lists),
                       sum(len(s) for s, _ in egos.edge_lists))


def test_pack_graphs_and_subgraphs_match(jgraphs, packed):
    g, sub = packed
    egos = [jextract_egonets(x, 1) for x in jgraphs]
    jg = jpack_graphs(jgraphs, 768, 4096, 24)
    jsub = jpack_subgraphs(jgraphs, egos, 3072, 12288)
    assert g.band_col_off is not None and sub.band_col_off is not None
    _assert_fields_equal(g, jg, GRAPH_FIELDS)
    _assert_fields_equal(sub, jsub, SUB_FIELDS)
    assert sub.node_feat is None and jsub.node_feat is None


def test_unfit_batch_takes_coo_layout():
    """A graph wider than the band gets no window offsets in either
    package, so the encoders take the COO path."""
    n = 300
    s = np.arange(n - 1)
    r = s + 1
    arrays = dict(
        senders=np.concatenate([s, r, [0, n - 1]]).astype(np.int32),
        receivers=np.concatenate([r, s, [n - 1, 0]]).astype(np.int32),
        node_feat=np.ones((n, 3), np.float32))
    g = pack_graphs([GraphData(**arrays)], 512, 1024, 8)
    jg = jpack_graphs([JGraphData(**arrays)], 512, 1024, 8)
    assert g.band_col_off is None and jg.band_col_off is None
    _assert_fields_equal(g, jg, GRAPH_FIELDS)


def test_plan_capacities_and_batches_match():
    ds = loader.GraphDataset(random_dataset(256, seed=7, min_nodes=10,
                                            max_nodes=30), k=1)
    jgraphs = jrandom_dataset(256, seed=7, min_nodes=10, max_nodes=30)
    jds = jloader.GraphDataset(jgraphs, k=1,
                               egonets=[jextract_egonets(g, 1)
                                        for g in jgraphs])
    caps = loader.plan_capacities(ds, 32)
    jcaps = jloader.plan_capacities(jds, 32)
    assert dataclasses.asdict(caps) == dataclasses.asdict(jcaps)
    plans = loader.plan_batches(ds, 32, caps, seed=4)
    jplans = jloader.plan_batches(jds, 32, jcaps, seed=4)
    assert len(plans) == len(jplans)
    for a, b in zip(plans, jplans):
        np.testing.assert_array_equal(a, b)
    g, sub = next(loader.batch_iterator(ds, 32, caps, seed=4))
    jg, jsub = jloader.pack_batch(jds, jplans[0], jcaps)
    _assert_fields_equal(g, jg, GRAPH_FIELDS)
    _assert_fields_equal(sub, jsub, SUB_FIELDS)


@pytest.mark.parametrize("which", ["graph", "sub"])
def test_build_blocks_bit_equal(packed, which):
    """The blocks build (``kb.blocks``, its plain version on the CPU) ==
    build_blocks_jax == pack_banded, bit for bit."""
    b = packed[0] if which == "graph" else packed[1]
    n = b.node_mask.shape[0]
    tb = b.to("cpu")
    got = kb.blocks(tb.receivers, tb.senders, tb.edge_mask, tb.band_col_off,
                    n // 128, 128, 256)
    assert got.dtype == torch.bfloat16 and got.shape == (n // 128, 128, 256)
    want = jbanded.build_blocks_jax(jnp.asarray(b.senders),
                                    jnp.asarray(b.receivers),
                                    jnp.asarray(b.edge_mask),
                                    jnp.asarray(b.band_col_off), n)
    got_np = got.float().numpy()
    np.testing.assert_array_equal(got_np, np.asarray(want, np.float32))
    host = banded.pack_banded(b.senders, b.receivers, b.edge_mask, n)
    np.testing.assert_array_equal(got_np, host.blocks)
    jhost = jbanded.pack_banded(b.senders, b.receivers, b.edge_mask, n)
    np.testing.assert_array_equal(host.blocks, jhost.blocks)
    np.testing.assert_array_equal(host.col_off, jhost.col_off)


# case -> does build_blocks_jax (and pack_banded) see the same edges: XLA's
# negative indices wrap, and pack_banded raises on an edge out of its window
BAND_CASES = {"packed": True, "masked": True, "unmasked": True,
              "doubled": True, "shuffled": True, "out_of_window": False}


def band_case(b, case, band):
    """(senders, receivers, edge_mask) of batch ``b`` for one case: some
    real edges masked, no mask at all over the real edges and five of the
    padding self-loops (which then count 5 on the padding node: counts
    past 256 are not exact in bf16), three real edges doubled (counts of
    2), the order shuffled, or twenty real edges moved a band's width out
    of their window either way."""
    rng = np.random.default_rng(len(case))
    s = np.asarray(b.senders, np.int64)
    r = np.asarray(b.receivers, np.int64)
    m = np.asarray(b.edge_mask, bool)
    real = np.flatnonzero(m)
    if case == "masked":
        m = m & (rng.random(len(m)) < 0.7)
    elif case == "unmasked":
        keep = np.concatenate([real, np.flatnonzero(~m)[:5]])
        s, r, m = s[keep], r[keep], None
    elif case == "doubled":
        s, r, m = (np.concatenate([a, a[real[:3]]]) for a in (s, r, m))
    elif case == "shuffled":
        p = rng.permutation(len(s))
        s, r, m = s[p], r[p], m[p]
    elif case == "out_of_window":
        moved = rng.choice(real, 20, replace=False)
        s = s.copy()
        s[moved[:10]] += band
        s[moved[10:]] -= band
    return s, r, m


@pytest.mark.parametrize("geometry", [(128, 256, 64), (64, 128, 8)],
                         ids=["wide", "gt"])
@pytest.mark.parametrize("case", list(BAND_CASES))
@pytest.mark.parametrize("which", ["graph", "sub"])
def test_build_blocks_cases_bit_equal(packed, which, case, geometry):
    """``kb.blocks`` (its plain version) == the NumPy counts, and
    == build_blocks_jax and pack_banded where they see the same edges,
    bit for bit: masked edges, edges out of their window, the packers'
    padding self-loops, a doubled edge, any edge order."""
    tile, band, align = geometry
    b = packed[0] if which == "graph" else packed[1]
    n = b.node_mask.shape[0]
    s, r, m = band_case(b, case, band)
    off = banded.device_col_off(n, tile, band, align, "cpu")
    got = kb.blocks(torch.from_numpy(r), torch.from_numpy(s),
                    None if m is None else torch.from_numpy(m), off,
                    n // tile, tile, band)
    assert got.dtype == torch.bfloat16 and got.shape == (n // tile, tile,
                                                         band)
    got_np = got.float().numpy()
    want = np_blocks(r, s, m, off.numpy(), n // tile, tile, band)
    np.testing.assert_array_equal(got_np, want)
    assert want.max() == {"doubled": 2, "unmasked": 5}.get(case, 1)
    if not BAND_CASES[case]:
        assert want.sum() == int(np.asarray(b.edge_mask).sum()) - 20
        return
    jm = None if m is None else jnp.asarray(m)
    jwant = jbanded.build_blocks_jax(jnp.asarray(s), jnp.asarray(r), jm,
                                     jnp.asarray(off.numpy()), n, tile,
                                     band)
    np.testing.assert_array_equal(got_np, np.asarray(jwant, np.float32))
    host = banded.pack_banded(s, r, m, n, tile, band, align)
    np.testing.assert_array_equal(got_np, host.blocks)


def test_banded_col_off_and_fit_match(packed):
    for n in (256, 768, 3072, 9728):
        np.testing.assert_array_equal(banded.banded_col_off(n),
                                      jbanded.banded_col_off(n))
    g = packed[0]
    for mask in (g.edge_mask, None):
        assert banded.fits_band_masked(g.senders, g.receivers, mask,
                                       g.node_mask.shape[0]) == \
            jbanded.fits_band_masked(g.senders, g.receivers, mask,
                                     g.node_mask.shape[0])


@pytest.mark.parametrize("shift", [0, 100])
def test_fits_band_matches(packed, shift):
    """Every packed batch fits its band; senders moved 100 rows away do
    not; the port's verdict is the JAX package's in both."""
    for b in packed:
        s, r = np.asarray(b.senders) + shift, np.asarray(b.receivers)
        for tile, band, align in ((128, 256, 64), (64, 128, 8)):
            got = banded.fits_band(s, r, tile, band, align)
            assert got == jbanded.fits_band(s, r, tile, band, align)
            if (tile, band) == (128, 256):
                assert got == (shift == 0)


def test_containers_convert_to_tensors(packed, jgraphs):
    g, sub = packed
    tg = g.to("cpu")
    assert tg.senders.dtype == torch.int64
    assert tg.band_col_off.dtype == torch.int64
    assert tg.node_mask.dtype == torch.bool
    assert tg.node_feat.dtype == torch.float32
    assert tg.band_blocks is None
    assert (tg.num_nodes, tg.num_edges, tg.num_graphs) == (768, 4096, 24)
    # the JAX package's NumPy batches convert to the same tensors
    egos = [jextract_egonets(x, 1) for x in jgraphs]
    jg = GraphBatch.from_numpy(jpack_graphs(jgraphs, 768, 4096, 24), "cpu")
    jsub = SubgraphBatch.from_numpy(
        jpack_subgraphs(jgraphs, egos, 3072, 12288), "cpu")
    tsub = sub.to("cpu")
    for f in GRAPH_FIELDS:
        assert torch.equal(getattr(tg, f), getattr(jg, f)), f
    for f in SUB_FIELDS:
        assert torch.equal(getattr(tsub, f), getattr(jsub, f)), f
    assert tsub.num_nodes == 3072 and tsub.num_edges == 12288
