"""The compiled pretraining step's pieces on the CPU, against the JAX package.

- ``segment_broadcast``: the gather whose backward is a segment sum (one
  ``index_add_``), as the JAX package's custom VJP has it, with ids out of
  range clamped.
- The pooling's branch flag, now taken by the packer in NumPy, against the
  JAX function's device-side ``fits`` (read off its ``lax.cond``), on a
  normal and a skewed batch.
- ``make_pretrain_scan_step``: three inner steps against the JAX scan step,
  with the gradient mask of ``test_torch_trainer.py`` and its tolerances.
- The capture guard: the forward and backward of one step, for both
  encoders and every option, dispatch no op that reads the device back to
  the host (what a CUDA graph cannot capture).  The optimizer is left out:
  torch's CPU Adam keeps its step count on the host.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scgib_tpu.data.synthetic import random_dataset as jrandom_dataset
from scgib_tpu.graph.batching import pack_graphs as jpack_graphs
from scgib_tpu.graph.batching import pack_subgraphs as jpack_subgraphs
from scgib_tpu.graph.egonet import extract_egonets as jextract_egonets
from scgib_tpu.models.scgib import PretrainModel as JPretrainModel
from scgib_tpu.ops import pool as jpool
from scgib_tpu.ops import segment as jsegment
from scgib_tpu.train.trainer import TrainState, adam_l2 as jadam_l2
from scgib_tpu.train.trainer import \
    make_pretrain_scan_step as jmake_pretrain_scan_step

from scgib_tpu_torch.data.loader import (GraphDataset, batch_iterator,
                                         plan_capacities)
from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph.banded import banded_col_off, device_col_off
from scgib_tpu_torch.graph.batching import (GraphData, pack_graphs,
                                            pack_subgraphs)
from scgib_tpu_torch.graph.container import GraphBatch, SubgraphBatch
from scgib_tpu_torch.graph.egonet import extract_egonets
from scgib_tpu_torch.models.scgib import PretrainModel
from scgib_tpu_torch.ops import pool, segment
from scgib_tpu_torch.train import trainer
from scgib_tpu_torch.utils import counters
from scgib_tpu_torch.utils.params import (adam_to_optax, from_jax_variables,
                                          load_adam_state)

IN, HID, DT = 9, 16, 8
LR, WD, N_INNER = 1e-4, 5e-5, 3


class OpLog(torch.utils._python_dispatch.TorchDispatchMode):
    """The names of the ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func._schema.name)
        return func(*args, **(kwargs or {}))


# --- (a) segment_broadcast ---------------------------------------------------

@pytest.mark.parametrize("shape", [(), (5,)], ids=["vector", "matrix"])
def test_segment_broadcast_matches_jax_with_ids_out_of_range(shape):
    rng = np.random.default_rng(0)
    n_seg = 7
    ids = np.array([0, 3, 3, 6, -2, 9, 1, 6, 2, 7], np.int32)
    vals = rng.normal(size=(n_seg,) + shape).astype(np.float32)
    ct = rng.normal(size=(len(ids),) + shape).astype(np.float32)

    def jloss(v):
        out = jsegment.segment_broadcast(v, jnp.asarray(ids), n_seg)
        return jnp.sum(out * ct), out
    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(vals))
    v = torch.from_numpy(vals).requires_grad_()
    out = segment.segment_broadcast(v, torch.from_numpy(ids).long(), n_seg)
    log = OpLog()
    with log:
        (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-6)
    # the backward is one index_add_, not the gather's index_put_
    assert "aten::index_add" in log.names or "aten::index_add_" in log.names
    assert not any(n.startswith("aten::index_put") for n in log.names)


def test_segment_broadcast_gradcheck_float64():
    ids = torch.tensor([0, 2, 2, 4, -1, 5, 1])
    vals = torch.randn(5, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda v: segment.segment_broadcast(v, ids, 5), (vals,))


# --- (b) the pooling's branch flag -------------------------------------------

def _jax_fits(monkeypatch, data, ids, num_segments, mask):
    """The JAX pooling's output and the predicate its ``lax.cond`` got."""
    preds = []
    real = jax.lax.cond

    def cond(pred, *args, **kw):
        preds.append(bool(pred))
        return real(pred, *args, **kw)
    monkeypatch.setattr(jax.lax, "cond", cond)
    out = jpool.sorted_segment_sum_banded(
        jnp.asarray(data), jnp.asarray(ids, jnp.int32), num_segments,
        mask=jnp.asarray(mask))
    assert len(preds) == 1
    return np.asarray(out), preds[0]


def _complete_graph(n, feat, rng):
    s, r = np.nonzero(~np.eye(n, dtype=bool))
    return GraphData(senders=s.astype(np.int32), receivers=r.astype(np.int32),
                     node_feat=rng.normal(size=(n, feat)).astype(np.float32))


def _skewed_batch():
    """13 complete graphs of 10 nodes (k=1 ego-nets of 10 rows each) then
    small ones: the first tile of 128 centers owns 1280 sub-rows, more than
    the 1024 the window holds at S = 2048, N = 512."""
    rng = np.random.default_rng(3)
    graphs = [_complete_graph(10, IN, rng) for _ in range(13)]
    graphs += random_dataset(60, seed=4, min_nodes=4, max_nodes=6,
                             feat_dim=IN)
    graphs = graphs[:13] + graphs[13:13 + 50]
    egos = [extract_egonets(x, 1) for x in graphs]
    return graphs, egos, 512, 2048


@pytest.mark.parametrize("skewed", [False, True], ids=["normal", "skewed"])
def test_pool_flag_from_the_packer_matches_jax(monkeypatch, skewed):
    if skewed:
        graphs, egos, n_cap, s_cap = _skewed_batch()
    else:
        graphs = random_dataset(16, seed=5, min_nodes=8, max_nodes=28,
                                feat_dim=IN)
        egos = [extract_egonets(x, 1) for x in graphs]
        n_cap, s_cap = 512, 1536
    sub = pack_subgraphs(graphs, egos, s_cap, 16384, num_centers=n_cap)
    rng = np.random.default_rng(1)
    data = rng.normal(size=(s_cap, 8)).astype(np.float32)
    want, jfits = _jax_fits(monkeypatch, data, sub.node_center, n_cap,
                            sub.node_mask)
    assert sub.pool_fits is jfits is (not skewed)
    tsub = sub.to("cpu")
    assert tsub.pool_fits is sub.pool_fits
    counters.reset("pool")
    got = pool.sorted_segment_sum_banded(
        torch.from_numpy(data), tsub.node_center, n_cap,
        mask=tsub.node_mask, fits=tsub.pool_fits)
    assert counters.of("pool") == {("scatter" if skewed else "banded"): 1}
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_pool_flag_without_the_packer():
    """A batch packed without the centers' capacity has no flag; on the CPU
    the pool takes the test itself, and from_numpy keeps None."""
    graphs = random_dataset(8, seed=2, min_nodes=8, max_nodes=20,
                            feat_dim=IN)
    egos = [extract_egonets(x, 1) for x in graphs]
    sub = pack_subgraphs(graphs, egos, 1024, 4096)
    assert sub.pool_fits is None
    assert SubgraphBatch.from_numpy(sub, "cpu").pool_fits is None
    counters.reset("pool")
    x = torch.randn(1024, 4)
    out = pool.sorted_segment_sum_banded(
        x, torch.from_numpy(sub.node_center).long(), 256,
        mask=torch.from_numpy(sub.node_mask))
    assert counters.of("pool") == {"banded": 1}
    np.testing.assert_allclose(out.numpy(), segment.segment_sum(
        x, torch.from_numpy(sub.node_center).long(), 256,
        torch.from_numpy(sub.node_mask)).numpy(), rtol=1e-5, atol=1e-5)


def test_device_col_off_matches_the_host_offsets():
    for n, geo in ((3072, (64, 128, 8)), (9728, (64, 128, 8)),
                   (512, (128, 256, 64)), (256, (128, 256, 64))):
        np.testing.assert_array_equal(
            device_col_off(n, *geo, "cpu").numpy(), banded_col_off(n, *geo))


# --- (c) the scanned step ----------------------------------------------------

def test_scan_step_matches_jax_scan_step():
    graphs = jrandom_dataset(12, seed=4, min_nodes=8, max_nodes=20,
                             feat_dim=IN)
    egos = [jextract_egonets(x, 1) for x in graphs]
    jg = jpack_graphs(graphs, 256, 1024, 16, banded="device")
    jsub = jpack_subgraphs(graphs, egos, 1024, 4096, banded="device")
    jmodel = JPretrainModel(in_dim=IN, hidden=HID, d_transfer=DT,
                            deterministic=True)
    v = jmodel.init({"params": jax.random.PRNGKey(0),
                     "noise": jax.random.PRNGKey(1)}, jg, jsub, train=True)
    v = jax.tree_util.tree_map(np.asarray, v)

    def total(params):
        losses, _ = jmodel.apply({"params": params,
                                  "batch_stats": v["batch_stats"]},
                                 jg, jsub, train=True,
                                 mutable=["batch_stats"])
        return losses.total

    # the mask of test_torch_trainer.py: gradients zero but for rounding
    grad0 = jax.tree_util.tree_map(np.abs, jax.grad(total)(v["params"]))
    scale = max(a.max() for a in jax.tree_util.tree_leaves(grad0))
    keep = jax.tree_util.tree_map(
        lambda a: (a > 1e-5 * scale).astype(np.float32), grad0)
    tx = optax.chain(
        optax.stateless(lambda u, _: jax.tree_util.tree_map(
            lambda a, k: a * k, u, keep)),
        jadam_l2(LR, WD))
    jstep = jmake_pretrain_scan_step(jmodel, tx, N_INNER, donate=False)
    state, jlosses = jstep(TrainState.create(v, tx), jg, jsub,
                           jax.random.PRNGKey(7))

    model = PretrainModel(IN, hidden=HID, d_transfer=DT, deterministic=True)
    model.load_state_dict(from_jax_variables(v))
    keep_t = from_jax_variables({"params": keep})
    for name, p in model.named_parameters():
        p.register_hook(lambda g, k=keep_t[name]: g * k)
    step = trainer.make_pretrain_scan_step(
        model, trainer.adam_l2(model, LR, WD), N_INNER)
    losses = step(GraphBatch.from_numpy(jg, "cpu"),
                  SubgraphBatch.from_numpy(jsub, "cpu"))
    for a, b in zip(losses, jlosses):
        assert a.shape == (N_INNER,)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4)
    want = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats}))
    got = model.state_dict()
    params = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=5e-2 * LR if name in params else 1e-6,
                                   err_msg=name)


def test_scan_step_draws_fresh_noise_each_inner_step():
    """With the noise on, the inner steps differ, and the scan step equals
    that many single steps from the same start and generator."""
    ds = GraphDataset(random_dataset(16, seed=3, min_nodes=6, max_nodes=14),
                      k=1)
    caps = plan_capacities(ds, 8)
    g, sub = next(batch_iterator(ds, 8, caps, shuffle=False))
    g, sub = g.to("cpu"), sub.to("cpu")
    runs = []
    for scan in (True, False):
        model = PretrainModel(IN, hidden=HID, d_transfer=DT)
        torch.manual_seed(0)
        for p in model.parameters():
            torch.nn.init.normal_(p, std=0.2)
        gen = torch.Generator().manual_seed(5)
        opt = trainer.adam_l2(model, LR, WD)
        if scan:
            losses = trainer.make_pretrain_scan_step(model, opt, 2)(
                g, sub, gen)
        else:
            step = trainer.make_pretrain_step(model, opt)
            per = [step(g, sub, gen) for _ in range(2)]
            losses = [torch.stack(x) for x in zip(*per)]
        runs.append((losses, {k: t.clone() for k, t in
                              model.state_dict().items()}))
    (scan_l, scan_s), (one_l, one_s) = runs
    for a, b in zip(scan_l, one_l):
        assert torch.equal(a, b)
    assert all(torch.equal(scan_s[k], one_s[k]) for k in scan_s)
    assert scan_l[0][0] != scan_l[0][1]          # KL: fresh noise


# --- (d) the capture guard ---------------------------------------------------

OPTIONS = {"default": {}, "s2s": {"readout": "s2s"},
           "use_att off": {"use_att": False},
           "reference KL": {"kl_mode": "reference"},
           "logM": {"recons_type": "logM"}, "dense": {"recons_impl": "dense"}}


@pytest.fixture(scope="module")
def packed():
    ds = GraphDataset(random_dataset(24, seed=9, min_nodes=8, max_nodes=20),
                      k=1)
    caps = plan_capacities(ds, 12)
    return {logm: tuple(b.to("cpu") for b in next(batch_iterator(
        ds, 12, caps, shuffle=False, logm_k=1 if logm else None)))
        for logm in (False, True)}


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("encoder", ["GIN", "Transformer"])
def test_step_reads_nothing_back_to_the_host(packed, encoder, option):
    kw = OPTIONS[option]
    g, sub = packed["recons_type" in kw]
    assert sub.pool_fits is not None and g.band_col_off is not None
    model = PretrainModel(IN, hidden=HID, d_transfer=DT, encoder=encoder,
                          num_layers=2, num_heads=4, **kw)
    gen = torch.Generator().manual_seed(0)
    guard = trainer.CaptureGuard()
    with guard:
        model.train()
        losses = model(g, sub, rand=lambda shape: torch.rand(
            shape, generator=gen))
        losses.total.backward()
    assert guard.last is not None
    assert any(p.grad is not None for p in model.parameters())


def test_capture_guard_refuses_host_reads():
    x = torch.arange(6.0)
    for read in (lambda: float(x.sum()), lambda: bool(x.max() > 2),
                 lambda: x.nonzero(), lambda: x[x > 2],
                 lambda: torch.unique(x)):
        with pytest.raises(trainer.HostReadError), trainer.CaptureGuard():
            read()


# --- the counts and the optimizer state around a captured step ---------------

def test_tally_round_trip():
    before = counters.snapshot()
    diff = {("launch", "gt_fwd"): 3, ("pool", "banded"): 1,
            ("encoder", "gt_band_64x128"): 10,
            ("route", ("gt_fwd_bf16", "staged")): 2}
    counters.add(diff)
    after = counters.snapshot()
    assert {k: after.get(k, 0) - before.get(k, 0) for k in diff} == diff
    counters.add(diff, -1)
    assert counters.snapshot() == before


def test_adam_state_loads_in_place():
    """A loaded Adam state is copied into the tensors the optimizer already
    has (a captured step reads those very tensors)."""
    model = PretrainModel(IN, hidden=HID, d_transfer=DT, deterministic=True)
    opt = trainer.adam_l2(model, LR, WD)
    ds = GraphDataset(random_dataset(8, seed=1, min_nodes=6, max_nodes=12),
                      k=1)
    g, sub = (b.to("cpu") for b in next(batch_iterator(
        ds, 8, plan_capacities(ds, 8), shuffle=False)))
    trainer.pretrain_step_eager(model, opt, g, sub)
    saved = adam_to_optax(model, opt)
    ids = {n: {k: id(t) for k, t in opt.state[p].items()}
           for n, p in model.named_parameters()}
    trainer.pretrain_step_eager(model, opt, g, sub)
    load_adam_state(model, opt, saved)
    for n, p in model.named_parameters():
        assert {k: id(t) for k, t in opt.state[p].items()} == ids[n]
        assert float(opt.state[p]["step"]) == 1.0
    np.testing.assert_array_equal(adam_to_optax(model, opt)["0"]["1"]["mu"],
                                  saved["0"]["1"]["mu"])


def test_batch_key_tells_apart_what_changes_the_captured_work():
    ds = GraphDataset(random_dataset(16, seed=3, min_nodes=6, max_nodes=14),
                      k=1)
    caps = plan_capacities(ds, 8)
    it = batch_iterator(ds, 8, caps, shuffle=False)
    (g1, s1), (g2, s2) = [tuple(b.to("cpu") for b in x) for x in
                          (next(it), next(it))]
    assert trainer.batch_key(g1, s1) == trainer.batch_key(g2, s2)
    for changed in (dataclasses.replace(s1, pool_fits=not s1.pool_fits),
                    dataclasses.replace(s1, gt_fits=not s1.gt_fits),
                    dataclasses.replace(s1, band_col_off=None)):
        assert trainer.batch_key(g1, changed) != trainer.batch_key(g1, s1)
