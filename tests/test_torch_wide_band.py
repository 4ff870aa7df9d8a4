"""The band sized from the data (``graph/banded.py::band_width``): the width
rule and where it places components, the packers past 64 nodes, the
pretraining step on the wide band against its own COO path, the JAX
package (whose band is 256 wide whatever the data) and the
benchmark's plain float64 reference, and what a replay's tally keeps.

Small datasets keep W = 256 and the JAX packers' arrays (also
``test_torch_flat.py`` and ``test_torch_graph.py``)."""

import dataclasses
import statistics

import jax
import numpy as np
import optax
import pytest
import torch

import scgib_tpu.native
from scgib_tpu.data.flat import pack_flat_batch as jpack_flat_batch
from scgib_tpu.data.loader import GraphDataset as JGraphDataset
from scgib_tpu.data.synthetic import random_dataset as jrandom_dataset
from scgib_tpu.graph.batching import pack_graphs as jpack_graphs
from scgib_tpu.graph.batching import pack_subgraphs as jpack_subgraphs
from scgib_tpu.graph.egonet import extract_egonets as jextract_egonets
from scgib_tpu.models.scgib import PretrainModel as JPretrainModel
from scgib_tpu.train.trainer import adam_l2 as jadam_l2

from port_bench import check, drivers
from scgib_tpu_torch.data.loader import (GraphDataset, pack_batch,
                                         plan_capacities)
from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph import banded
from scgib_tpu_torch.graph.batching import pack_graphs, pack_subgraphs
from scgib_tpu_torch.graph.container import GraphBatch, SubgraphBatch
from scgib_tpu_torch.graph.egonet import extract_egonets
from scgib_tpu_torch.models.scgib import PretrainModel
from scgib_tpu_torch.train import trainer
from scgib_tpu_torch.utils import counters, profiling
from scgib_tpu_torch.utils.params import from_jax_variables

IN, HID, DT, K = 9, 16, 8, 3
LR, WD = 1e-4, 5e-5
# four molecules of 70-100 atoms whose 3-hop ego-nets reach 69 nodes: both
# bands 384 wide
SEED, ATOMS = 3, (70, 100)


@pytest.fixture(autouse=True)
def _jax_numpy_packers(monkeypatch):
    """The JAX side packs with its NumPy flat packer (its native library
    is ``tests/test_native.py``'s to build)."""
    monkeypatch.setattr(scgib_tpu.native, "_load", lambda: None)


def _ring(m):
    s = np.arange(m)
    r = (s + 1) % m
    return (np.concatenate([s, r]).astype(np.int64),
            np.concatenate([r, s]).astype(np.int64))


def test_width_rule():
    """256 up to 64 nodes, then the smallest multiple of 128 that is at
    least 2 m + 128; a component of m nodes fits its width and not the
    next narrower one."""
    sizes = (0, 1, 64, 65, 128, 129, 182, 192, 193)
    assert [banded.band_width(m) for m in sizes] == [
        256, 256, 256, 384, 384, 512, 512, 512, 640]
    for m in sizes:
        w = banded.band_width(m)
        assert banded.component_fits(m, w)
        assert w == 256 or not banded.component_fits(m, w - 128)


@pytest.mark.parametrize("m", [64, 66, 128, 182])
def test_a_component_fits_its_band_wherever_it_lands(m):
    """A ring of m nodes (an edge between its first and last) keeps every
    edge in its window at every placement in a capacity of four bands, at
    its width; at 66 nodes (an edge 65 rows long) some placement escapes W
    = 256 (the rule's (W - 128) / 2 is one short of the exact 65)."""
    w = banded.band_width(m)
    cap = 4 * w
    s, r = _ring(m)
    fits = [banded.fits_band_masked(s + at, r + at, None, cap, band=w)
            for at in range(cap - m + 1)]
    assert all(fits)
    narrow = [banded.fits_band_masked(s + at, r + at, None, cap, band=256)
              for at in range(cap - m + 1)]
    assert all(narrow) == (m <= 64)


def test_a_batch_below_its_band_takes_coo():
    """A capacity under the band: the offsets stay None (COO), the width
    is still the data's."""
    s, r = _ring(100)
    from scgib_tpu_torch.graph.batching import GraphData
    g = GraphData(senders=s.astype(np.int32), receivers=r.astype(np.int32),
                  node_feat=np.ones((100, 3), np.float32))
    small = pack_graphs([g], 256, 256, 2)
    assert small.band_width == 384 and small.band_col_off is None
    big = pack_graphs([g], 512, 256, 2)
    np.testing.assert_array_equal(big.band_col_off,
                                  banded.banded_col_off(512, 128, 384))


@pytest.fixture(scope="module")
def wide():
    graphs = random_dataset(4, seed=SEED, min_nodes=ATOMS[0],
                            max_nodes=ATOMS[1], feat_dim=IN)
    ds = GraphDataset(graphs, k=K)
    return ds, plan_capacities(ds, 4)


def _equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or isinstance(x, (bool, int)):
            assert x == y, f.name
        else:
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_flat_and_per_graph_packers_agree_past_64_nodes(wide):
    ds, caps = wide
    fd = ds.flat()
    assert int(np.diff(fd.node_off).max()) > 64 and int(fd.max_ego.max()) > 64
    for sel in ([0, 1, 2, 3], [3, 1], [2]):
        g_ref, sub_ref = pack_batch(ds, sel, caps)
        g, sub = pack_batch(ds, sel, caps, use_flat=True)
        _equal(g, g_ref)
        _equal(sub, sub_ref)
        assert (g.band_width, sub.band_width) == (384, 384)
        assert g.band_col_off is not None and sub.band_col_off is not None


def test_small_datasets_keep_256_and_the_jax_arrays():
    kw = dict(min_nodes=5, max_nodes=30)
    ds = GraphDataset(random_dataset(40, seed=2, **kw), k=2)
    jds = JGraphDataset(jrandom_dataset(40, seed=2, **kw), k=2)
    caps = plan_capacities(ds, 16)
    sel = np.arange(16)
    g, sub = pack_batch(ds, sel, caps, use_flat=True)
    jg, jsub = jpack_flat_batch(jds.flat(), sel, caps)
    assert (g.band_width, sub.band_width) == (256, 256)
    for a, b in ((g, jg), (sub, jsub)):
        assert a.band_col_off is not None
        np.testing.assert_array_equal(a.band_col_off, b.band_col_off)
        np.testing.assert_array_equal(a.senders, b.senders)


def _coo(b):
    return dataclasses.replace(b, band_col_off=None)


def _counts():
    return (counters.of("encoder"), counters.of("pool"),
            counters.of("recon"))


def _clear():
    counters.reset("encoder", "pool", "recon")


@pytest.fixture(scope="module")
def jax_case():
    """The four molecules packed by both packages (the JAX package's bands
    are 256 wide or COO, the port's 384 wide), the
    JAX model's variables from PRNGKey(0), its losses, gradient and one
    Adam step, and the mask of gradients above 1e-5 of the largest
    (``test_torch_trainer.py``'s)."""
    graphs = jrandom_dataset(4, seed=SEED, min_nodes=ATOMS[0],
                             max_nodes=ATOMS[1], feat_dim=IN)
    egos = [jextract_egonets(x, K) for x in graphs]
    jg = jpack_graphs(graphs, 512, 1024, 8, banded="device")
    jsub = jpack_subgraphs(graphs, egos, 8192, 16896, banded="device")
    jmodel = JPretrainModel(in_dim=IN, hidden=HID, d_transfer=DT,
                            deterministic=True)
    # initialised under jit: the same draws, in a fifth of the eager time
    v = jax.tree_util.tree_map(np.asarray, jax.jit(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jg, jsub, train=True))())

    @jax.jit
    def value_and_grad(params):
        def total(p):
            out, _ = jmodel.apply({"params": p,
                                   "batch_stats": v["batch_stats"]},
                                  jg, jsub, train=True,
                                  mutable=["batch_stats"])
            return out.total, out
        return jax.value_and_grad(total, has_aux=True)(params)

    (_, jlosses), grad = value_and_grad(v["params"])
    grad = jax.tree_util.tree_map(np.asarray, grad)
    scale = max(np.abs(a).max() for a in jax.tree_util.tree_leaves(grad))
    keep = jax.tree_util.tree_map(
        lambda a: (np.abs(a) > 1e-5 * scale).astype(np.float32), grad)
    masked = jax.tree_util.tree_map(lambda a, k: a * k, grad, keep)
    tx = jadam_l2(LR, WD)
    upd, _ = tx.update(masked, tx.init(v["params"]), v["params"])
    after = optax.apply_updates(v["params"], upd)
    return (graphs, v, [float(x) for x in jlosses],
            from_jax_variables({"params": masked}),
            from_jax_variables({"params": keep}),
            from_jax_variables({"params": after}))


def _port_step(graphs, v, keep, coo):
    """The port's losses, masked gradient and parameters after one Adam
    step on the four molecules, packed by its own packers."""
    egos = [extract_egonets(x, K) for x in graphs]
    g = pack_graphs(graphs, 512, 1024, 8)
    sub = pack_subgraphs(graphs, egos, 8192, 16896, num_centers=512)
    assert (g.band_width, sub.band_width) == (384, 384)
    g, sub = g.to("cpu"), sub.to("cpu")
    if coo:
        g, sub = _coo(g), _coo(sub)
    model = PretrainModel(IN, hidden=HID, d_transfer=DT, deterministic=True)
    model.load_state_dict(from_jax_variables(v))
    grads = {}

    def masked(gr, name):
        grads[name] = gr * keep[name]
        return grads[name]
    for name, p in model.named_parameters():
        p.register_hook(lambda gr, n=name: masked(gr, n))
    _clear()
    step = trainer.make_pretrain_step(model, torch.optim.Adam(
        model.parameters(), lr=LR, weight_decay=WD))
    out = step(g, sub)
    return ([float(x) for x in out], grads,
            {n: p.detach().clone() for n, p in model.named_parameters()},
            _counts())


def test_step_on_the_wide_band_is_its_coo_path_and_the_jax_step(jax_case):
    graphs, v, jlosses, jgrad, keep, jafter = jax_case
    band = _port_step(graphs, v, keep, coo=False)
    coo = _port_step(graphs, v, keep, coo=True)
    assert band[3] == ({"band": 8}, {"banded": 1}, {"band": 1})
    assert coo[3] == ({"coo": 8}, {"banded": 1}, {"coo": 1})
    for got in (band, coo):
        np.testing.assert_allclose(got[0], jlosses, rtol=1e-5)
        for name, want in jgrad.items():
            # float32 sums in another order: within 1e-4 of the leaf's
            # largest entry
            np.testing.assert_allclose(got[1][name].numpy(), want.numpy(),
                                       rtol=1e-4, atol=1e-4 * float(
                                           want.abs().max()), err_msg=name)
            np.testing.assert_allclose(got[2][name].numpy(),
                                       jafter[name].numpy(), rtol=1e-4,
                                       atol=5e-2 * LR, err_msg=name)


def _bench_driver(seed):
    config = {"model": {"encoder": "GIN", "in_dim": IN, "hidden": HID,
                        "d_transfer": DT, "num_layers": 4, "num_heads": 8,
                        "readout": "sum", "use_att": True,
                        "recons_type": "adj", "recons_impl": "gram",
                        "kl_mode": "corrected", "k": K,
                        "precision": "float32"},
              "pretrain": {"lr": LR, "weight_decay": WD}}
    traffic = {"loop": "pretrain", "feed": "resident", "molecules": 4,
               "atoms": list(ATOMS), "batch_size": 4, "checked_steps": 1,
               "warmup_cycles": 1, "trace_steps": 1}
    d = drivers.make(config, traffic, seed, "cpu")
    return d


def test_step_on_the_wide_band_is_the_float64_reference():
    """The benchmark's plain reference (float64, COO by construction)
    against the port's first step on the wide band, from the same seeded
    weights and noise: the losses, the first gradient and the step, as
    ``port_bench``'s check reads them, within its float32 gates."""
    d = _bench_driver(2 ** 31 + 11)
    g, sub = d.batches[0]
    assert (g.band_width, sub.band_width) == (384, 384)
    assert g.band_col_off is not None and sub.band_col_off is not None
    d.warm_up()
    d.release()
    prog, ref = check.program_record(d), check.reference_record(d)
    for p, r in zip(prog["losses"][0], ref["losses"][0]):
        assert abs(p - r) <= 2e-6 * abs(r)
    norms = {n: float(x.norm()) for n, x in ref["first_grad"].items()}
    med = statistics.median(norms.values())
    for n, x in ref["first_grad"].items():
        diff = float((prog["first_grad"][n].double() - x).norm())
        assert diff <= 5e-3 * max(norms[n], med), n
    nums = check.gaps(prog, ref, d.weights)
    assert nums["change"] <= 3e-4 and nums["grad"] <= 1e-4, nums


def test_a_replays_tally_keeps_its_branches_and_widths():
    """The counts a replay's ``scgib.step.tally`` span carries: the
    launches and branches its capture added, and each batch's band width
    (0 where it is on the COO path)."""
    g = GraphBatch(node_feat=torch.zeros(4, 2), node_graph=torch.zeros(4),
                   node_mask=torch.ones(4, dtype=torch.bool),
                   senders=torch.zeros(2), receivers=torch.zeros(2),
                   edge_mask=torch.ones(2, dtype=torch.bool),
                   graph_mask=torch.ones(1, dtype=torch.bool),
                   band_col_off=torch.zeros(1), band_width=512)
    sub = SubgraphBatch(node_feat=None, node_center=torch.zeros(4),
                        node_orig=torch.zeros(4),
                        node_mask=torch.ones(4, dtype=torch.bool),
                        senders=torch.zeros(2), receivers=torch.zeros(2),
                        edge_mask=torch.ones(2, dtype=torch.bool),
                        band_width=384)
    added = {("launch", "gin_fwd"): 8, ("encoder", "band"): 4,
             ("encoder", "coo"): 4, ("pool", "banded"): 1,
             ("recon", "band"): 1, ("route", ("gt_fwd", "staged")): 3}
    out = torch.zeros(())
    counts = trainer._replay_counts((None, (g, sub), out, added))
    assert counts[profiling.STEP_PARTS[3]] == {
        "launch.gin_fwd": 8, "encoder.band": 4, "encoder.coo": 4,
        "pool.banded": 1, "recon.band": 1, "band_widths": (512, 0)}


def test_the_transformer_keeps_coo_past_the_256_band(wide):
    """The transformer's wide attention geometry is (128, 256) alone: a
    batch of a wider band gives it no band (COO), the GIN and the
    reconstruction their band at the batch's width."""
    from scgib_tpu_torch.models.scgib import _resolve_band
    ds, caps = wide
    g, sub = (b.to("cpu") for b in pack_batch(ds, [0, 1, 2, 3], caps))
    for b in (g, sub):
        assert not b.gt_fits and b.band_width == 384
        assert _resolve_band(b, gt=True) is None
        blocks, _ = _resolve_band(b)
        assert blocks.shape[1:] == (128, 384)
