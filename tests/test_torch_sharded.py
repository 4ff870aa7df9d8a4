"""Node-sharded pretraining over ``torch.distributed``: the port's
edge partitions, ring halo, global segment ops, ``PartitionedGIN`` and
``ShardedPretrainModel`` against the JAX package's
(``tests/test_edge_partition.py``, ``tests/test_sharded_scgib.py``).

The host plans (``partition_edges``, ``partition_edges_ring``,
``shard_pretrain_batch``) must be bit-equal to the JAX functions'.  One
world of 4 gloo ranks (``tests/sharded_cases.py``, spawned once for the
module) runs every rank-side case, at 1 and 2 shards on
``new_group([0])`` and ``new_group([0, 1])``; the tests hold what the ranks
saw against the JAX ``shard_map`` versions on the CPU mesh
``tests/conftest.py`` forces, and against the JAX single-device model on
the union batch.  Tolerances: the ops rtol 1e-5 with atol 1e-5
(``tests/test_edge_partition.py``'s); the summed losses rtol 1e-5 and the
gradients ``tests/test_sharded_scgib.py``'s per-leaf bound
(``_close_grads``); one sharded Adam step's parameters
``tests/test_torch_dp.py``'s ``PARAM_TOL``, its statistics rtol 1e-5, and
the ranks' states byte-equal.  Width: hidden 32, d_transfer 16, k = 1,
``deterministic=True``, batches packed with ``banded=False``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from scgib_tpu.data.synthetic import random_dataset as jrandom_dataset
from scgib_tpu.graph.batching import pack_graphs as jpack_graphs
from scgib_tpu.graph.batching import pack_subgraphs as jpack_subgraphs
from scgib_tpu.graph.egonet import extract_egonets as jextract_egonets
from scgib_tpu.models.scgib import PretrainModel as JPretrainModel
from scgib_tpu.parallel import edge_partition as jep
from scgib_tpu.parallel import sharded_ops as jso
from scgib_tpu.parallel.dp import make_mesh, shard_map
from scgib_tpu.parallel.sharded_batch import (
    shard_pretrain_batch as jshard_pretrain_batch)
from scgib_tpu.parallel.sharded_scgib import (
    ShardedPretrainModel as JShardedPretrainModel)

from scgib_tpu_torch.models.scgib import PretrainModel
from scgib_tpu_torch.parallel import edge_partition as ep
from scgib_tpu_torch.parallel.dryrun import dryrun_multichip
from scgib_tpu_torch.parallel.sharded_batch import shard_pretrain_batch
from scgib_tpu_torch.parallel.sharded_scgib import ShardedPretrainModel
from scgib_tpu_torch.train.trainer import adam_l2, make_pretrain_step
from scgib_tpu_torch.utils.params import from_jax_variables

import sharded_cases as C

OP_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=2.5e-4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these steps are many tiny ops, which crawl on
    several threads when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_batch(n_graphs, seed, min_nodes, max_nodes, caps):
    """The JAX package's packing of ``sharded_cases``' batches."""
    graphs = jrandom_dataset(n_graphs, seed=seed, min_nodes=min_nodes,
                             max_nodes=max_nodes, feat_dim=C.IN)
    egos = [jextract_egonets(g, 1) for g in graphs]
    n, e, ng, sn, se = caps
    return (jpack_graphs(graphs, n, e, ng, banded=False),
            jpack_subgraphs(graphs, egos, sn, se))


@pytest.fixture(scope="module")
def jax_model():
    """The JAX union batch, spanning batch, model and initial
    variables."""
    union = _jax_batch(6, 0, 10, 20, (128, 1024, 8, 1024, 4096))
    spanning = _jax_batch(2, 7, 12, 15, (32, 256, 4, 256, 1024))
    single = JPretrainModel(in_dim=C.IN, hidden=C.HID, d_transfer=C.DT,
                            deterministic=True)
    variables = jax.jit(lambda g, s: single.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        g, s, train=True))(*union)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return union, spanning, variables


@pytest.fixture(scope="module")
def ranks(jax_model, tmp_path_factory):
    """Starts the 4-rank world; calling the result waits for it and gives
    the ranks' results (the JAX side computes meanwhile)."""
    out = tmp_path_factory.mktemp("sharded")
    torch.save(from_jax_variables(jax_model[2]), out / "weights.pt")
    wait = C.spawn(C.WORLD, out)
    cache = []

    def results():
        if not cache:
            cache.append(wait())
        return cache[0]
    yield results
    results()


def _on_mesh(fn, shards, in_specs, out_specs):
    return jax.jit(shard_map(fn, mesh=make_mesh(jax.devices()[:shards]),
                             in_specs=in_specs, out_specs=out_specs,
                             check_vma=False))


def _per_rank(a, world=C.WORLD):
    return np.split(np.asarray(a), world)


# --- the host plans, bit-equal -----------------------------------------------

def _edge_cases():
    """(senders, receivers, num_nodes) of the JAX tests' seeds at node
    counts every shard count here divides: the packed batches of seeds 41
    and 7, and the random edges of seed 3."""
    out = []
    for seed in (41, 7):
        g = jpack_graphs(jrandom_dataset(16, seed=seed, min_nodes=8,
                                         max_nodes=30), 480, 2048, 16,
                         banded=False)
        m = np.asarray(g.edge_mask)
        out.append((np.asarray(g.senders)[m], np.asarray(g.receivers)[m],
                    480))
    rng = np.random.default_rng(3)
    out.append(tuple(rng.integers(0, 120, size=700).astype(np.int32)
                     for _ in range(2)) + (120,))
    return out


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and np.array_equal(got, want), what


@pytest.mark.parametrize("shards", (2, 3, 4, 8))
def test_edge_plans_bit_equal(shards, ranks):
    for i, (s, r, n) in enumerate(_edge_cases()):
        got, want = (ep.partition_edges(s, r, n, shards),
                     jep.partition_edges(s, r, n, shards))
        for f in ("senders_global", "receivers_local", "edge_mask"):
            _same(getattr(got, f), getattr(want, f), (i, f))
        assert got.nodes_per_shard == want.nodes_per_shard
        got, want = (ep.partition_edges_ring(s, r, n, shards),
                     jep.partition_edges_ring(s, r, n, shards))
        for f in ("senders_owner_local", "receivers_local", "edge_mask"):
            _same(getattr(got, f), getattr(want, f), (i, f))
        assert (got.radius, got.nodes_per_shard) == (want.radius,
                                                     want.nodes_per_shard)
        # the port's edge_cap pads every slot: the JAX plan, then padding
        cap = want.edge_mask.shape[-1]
        padded = ep.partition_edges_ring(s, r, n, shards, edge_cap=cap + 5)
        for f in ("senders_owner_local", "receivers_local", "edge_mask"):
            a = getattr(padded, f)
            _same(a[..., :cap], getattr(want, f), (i, f, "capped"))
            assert not a[..., cap:].any(), (i, f)
        with pytest.raises(ValueError, match="edge_cap"):
            ep.partition_edges_ring(s, r, n, shards, edge_cap=cap - 1)


@pytest.mark.parametrize("batch", ("union", "spanning"))
@pytest.mark.parametrize("shards", (1, 2, 4))
def test_shard_pretrain_batch_bit_equal(shards, batch, jax_model):
    """Every leaf and ``radius`` of the port's resharding equals the JAX
    function's, from the same packed arrays."""
    g, sub = getattr(C, f"{batch}_batch")()
    got = shard_pretrain_batch(g, sub, shards)
    want = jshard_pretrain_batch(g, sub, shards)
    assert got.radius == want.radius
    for f in dataclasses.fields(got):
        if f.name != "radius":
            _same(getattr(got, f.name), getattr(want, f.name), f.name)
    if batch == "spanning" and shards == C.WORLD:
        assert got.radius >= 2
    # fixed caps: the same arrays, padded
    cap = want.edge_mask.shape[-1]
    fixed = shard_pretrain_batch(g, sub, shards, 2048, 4096, cap + 3)
    assert fixed.sub_node_feat.shape[1] == 2048
    for f in ("senders_owner_local", "receivers_local", "edge_mask"):
        _same(getattr(fixed, f)[..., :cap], getattr(want, f), f)
        assert not getattr(fixed, f)[..., cap:].any(), f


def test_port_batches_are_the_jax_packers(jax_model):
    """The ranks pack with the port; the JAX references pack with the JAX
    package: the same arrays."""
    for got, want in zip(C.union_batch() + C.spanning_batch(),
                         jax_model[0] + jax_model[1]):
        for f in dataclasses.fields(got):
            a = getattr(got, f.name)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(
                    a, np.asarray(getattr(want, f.name)), err_msg=f.name)


# --- the collectives and ops, per rank ---------------------------------------

@pytest.fixture(scope="module")
def jax_ops():
    """The JAX shard_map versions of every op on the 4-device mesh: the
    per-shard outputs and gradients, split by rank."""
    S = C.WORLD
    res = {}
    s, r, h = C.packed_edges()
    part = jep.partition_edges(s, r, 512, S)
    fn = _on_mesh(lambda x, sg, rl, em: jep.partitioned_spmm(
        x, sg[0], rl[0], em[0], "data"), S, (P("data"),) * 4, P("data"))
    res["allgather_spmm"] = fn(h, part.senders_global, part.receivers_local,
                               part.edge_mask)

    s, r, h, w = C.ring_data()
    plan = jep.partition_edges_ring(s, r, C.RING_N, S)
    pl = (plan.senders_owner_local, plan.receivers_local, plan.edge_mask)
    specs = (P("data"),) + (P(None, "data"),) * 3

    def ring(x, sol, rl, em):
        return jep.ring_partitioned_spmm(x, sol[:, 0], rl[:, 0], em[:, 0],
                                         plan.radius, "data")

    def sddmm(x, sol, rl, em):
        return jso.ring_sddmm_sum(x, sol[:, 0], rl[:, 0], em[:, 0],
                                  plan.radius, "data")[None]

    ring_fn = _on_mesh(ring, S, specs, P("data"))
    out, vjp = jax.vjp(lambda x: ring_fn(x, *pl), jnp.asarray(h))
    res["ring_spmm"], res["ring_spmm_grad"] = out, vjp(jnp.asarray(w))[0]
    sd_fn = _on_mesh(sddmm, S, specs, P("data"))
    res["sddmm"] = sd_fn(h, *pl)
    res["sddmm_grad"] = jax.grad(lambda x: sd_fn(x, *pl).sum())(
        jnp.asarray(h))
    res["radius"] = plan.radius

    ids, mask, data, logits, w, ws = C.seg_data()
    G = C.SEG_G

    def segs(x, lt, i, m, ws_):
        first = (jax.lax.axis_index("data") == 0).astype(x.dtype)

        def local(x, lt):
            # this shard's scalar, differentiated inside the shard as the
            # JAX model is: psum's transpose sums the cotangents
            mean = jso.gseg_mean(x, i, G, "data", m)
            alpha = jso.gseg_softmax(lt, i, G, "data", m)
            return ((mean * jnp.asarray(w[:G]) * first).sum()
                    + (alpha * ws_).sum()), (mean, alpha)

        (_, (mean, alpha)), (gx, glt) = jax.value_and_grad(
            local, argnums=(0, 1), has_aux=True)(x, lt)
        std, mn = jso.gseg_std_mean(x, i, G, "data", m)
        outs = {"gseg_sum": jso.gseg_sum(x, i, G, "data", m),
                "gseg_count": jso.gseg_count(i, G, "data", m),
                "gseg_mean": mean, "gseg_std_mean": jnp.stack([std, mn]),
                "gseg_max": jso.gseg_max(x, i, G, "data", m)}
        return ({k: v[None] for k, v in outs.items()}, alpha, gx, glt)

    seg_fn = _on_mesh(segs, S, (P("data"),) * 5, (P("data"),) * 4)
    outs, alpha, gx, glt = seg_fn(data, logits, ids, mask, ws)
    res.update(outs)
    res["gseg_softmax"] = alpha
    res["gseg_mean_grad"], res["gseg_softmax_grad"] = gx, glt
    return res


OPS = ("allgather_spmm", "ring_spmm", "ring_spmm_grad", "sddmm",
       "sddmm_grad", "gseg_sum", "gseg_count", "gseg_mean", "gseg_std_mean",
       "gseg_max", "gseg_softmax", "gseg_mean_grad", "gseg_softmax_grad")


@pytest.mark.parametrize("name", OPS)
def test_ops_match_jax_per_rank(name, jax_ops, ranks):
    """Each rank's output (or gradient) of the op at 4 shards against the
    JAX shard's, within rtol and atol 1e-5."""
    per = _per_rank(jax_ops[name])
    for r, res in enumerate(ranks()):
        got = res["ops"][name].numpy()
        np.testing.assert_allclose(got, per[r].reshape(got.shape),
                                   **OP_TOL, err_msg=f"rank {r}")


def test_ring_radius_is_multi_hop(jax_ops, ranks):
    assert all(res["ops"]["radius"] == jax_ops["radius"] == 2
               for res in ranks())


def test_wrong_way_ring_backward_is_caught_at_four_shards(jax_ops, ranks):
    """A planted fault: the ring's backward shifted the same way as its
    forward.  At 4 shards the gradient check fails.  At 2 shards both
    directions reach the same rank, so the fault cannot show: there the
    faulty gradient is the right one, byte for byte."""
    want = _per_rank(jax_ops["ring_spmm_grad"])
    res = ranks()
    assert any(not np.allclose(r["wrong_way_4"].numpy(), w, **OP_TOL)
               for r, w in zip(res, want))
    for r in res[:2]:
        assert torch.equal(r["wrong_way_2"], r["right_way_2"])


# --- the model ---------------------------------------------------------------

def _jax_losses_and_grads(model, variables, g, sub, grads=True):
    def loss_fn(params):
        losses, _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            g, sub, train=True, mutable=["batch_stats"])
        return losses.total, losses

    if not grads:
        return [float(x) for x in jax.jit(loss_fn)(variables["params"])[1]]
    (_, losses), grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return ([float(x) for x in losses], from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, grad)}))


@pytest.fixture(scope="module")
def jax_refs(jax_model):
    """The JAX single-device losses and gradients on the union and the
    spanning batch, the reference-KL losses, and the JAX sharded model's
    per-shard losses at 4 shards."""
    union, spanning, v = jax_model
    single = JPretrainModel(in_dim=C.IN, hidden=C.HID, d_transfer=C.DT,
                            deterministic=True)
    ref = JPretrainModel(in_dim=C.IN, hidden=C.HID, d_transfer=C.DT,
                         deterministic=True, kl_mode="reference")
    out = {"union": _jax_losses_and_grads(single, v, *union),
           "spanning": _jax_losses_and_grads(single, v, *spanning),
           "reference": _jax_losses_and_grads(ref, v, *union, grads=False)}
    batch = jshard_pretrain_batch(*union, C.WORLD)
    sharded = JShardedPretrainModel(axis_name="data", in_dim=C.IN,
                                    hidden=C.HID, d_transfer=C.DT,
                                    radius=batch.radius, deterministic=True)

    def per_shard(b):
        b = jax.tree_util.tree_map(lambda x: x[0], b)
        losses, _ = sharded.apply(v, b, train=True, mutable=["batch_stats"])
        return jnp.stack(tuple(losses))[None]

    out["per_shard"] = np.asarray(_on_mesh(per_shard, C.WORLD, (P("data"),),
                                           P("data"))(batch))
    return out


def _close_grads(got, want):
    """``tests/test_sharded_scgib.py``'s bound: each leaf's largest error
    within 2e-6 of the largest gradient plus 1e-4 of its own largest entry
    (at least 1)."""
    assert set(got) == set(want)
    gscale = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        tol = 2e-6 * gscale + 1e-4 * max(float(w.abs().max()), 1.0)
        d = float((got[k] - w).abs().max())
        assert d <= tol, f"{k}: max diff {d} > {tol}"


@pytest.mark.parametrize("shards", C.SHARDS)
def test_summed_losses_and_grads_match_jax_union(shards, jax_refs, ranks):
    losses, grads = jax_refs["union"]
    for res in ranks()[:shards]:
        rec = res[f"model_{shards}"]
        np.testing.assert_allclose(rec["summed"], losses, rtol=1e-5)
        _close_grads(rec["grads"], grads)


@pytest.mark.parametrize("shards", C.SHARDS)
def test_reference_kl_is_exact_when_sharded(shards, jax_refs, ranks):
    """``kl_mode='reference'``: the last graph is the union batch's."""
    for res in ranks()[:shards]:
        np.testing.assert_allclose(res[f"reference_{shards}"]["summed"],
                                   jax_refs["reference"], rtol=1e-5)


def test_local_losses_match_jax_shards(jax_refs, ranks):
    """Each rank's local-numerator losses against the JAX sharded model's
    losses on the same shard (``out_specs=P('data')``)."""
    for r, res in enumerate(ranks()):
        np.testing.assert_allclose(res[f"model_{C.WORLD}"]["local"],
                                   jax_refs["per_shard"][r], rtol=1e-5,
                                   atol=1e-6, err_msg=f"rank {r}")


def test_graphs_spanning_shards(jax_refs, ranks):
    """2 graphs of 12-15 nodes at 4 ranks of 8 nodes: each graph spans
    shards and one edge joins shards 2 apart (radius 2, two ring hops)."""
    g, _ = C.spanning_batch()
    idx = np.nonzero(g.node_mask)[0]
    spans = [len(np.unique(idx[g.node_graph[idx] == gi] // 8)) > 1
             for gi in np.unique(g.node_graph[idx])]
    assert all(spans)
    losses, grads = jax_refs["spanning"]
    for res in ranks():
        rec = res["spanning"]
        assert rec["radius"] >= 2
        np.testing.assert_allclose(rec["summed"], losses, rtol=1e-5)
        _close_grads(rec["grads"], grads)


def test_state_dict_is_pretrain_models(jax_model):
    """The same keys, shapes and order as ``PretrainModel``'s, and one
    ``from_jax_variables`` result loads into both."""
    state = from_jax_variables(jax_model[2])
    single = PretrainModel(C.IN, **C.MODEL)
    sharded = ShardedPretrainModel(C.IN, **C.MODEL)
    assert list(sharded.state_dict()) == list(single.state_dict())
    assert [n for n, _ in sharded.named_parameters()] == [
        n for n, _ in single.named_parameters()]
    single.load_state_dict(state)
    sharded.load_state_dict(state)
    for k, v in sharded.state_dict().items():
        assert torch.equal(v, single.state_dict()[k]), k


def test_sharded_model_refuses_other_encoders():
    for kw in ({"encoder": "GCN"}, {"readout": "s2s"}):
        with pytest.raises(ValueError, match="GIN"):
            ShardedPretrainModel(C.IN, **C.MODEL, **kw)


@pytest.fixture(scope="module")
def single_step(jax_model):
    """One step of the port's single-device step on the union batch."""
    g, sub = (b.to("cpu") for b in C.union_batch())
    model = PretrainModel(C.IN, **C.MODEL)
    model.load_state_dict(from_jax_variables(jax_model[2]))
    losses = make_pretrain_step(model, adam_l2(model, C.LR, C.WD))(g, sub)
    return [float(x) for x in losses], model.state_dict(), {
        n for n, _ in model.named_parameters()}


@pytest.mark.parametrize("shards", C.SHARDS)
def test_one_sharded_step_matches_single_step(shards, single_step, ranks):
    """One Adam step: the parameters within PARAM_TOL of the single step's
    on the union batch, the BatchNorm statistics within rtol 1e-5, every
    rank's state byte-equal to rank 0's."""
    losses, state, params = single_step
    res = ranks()[:shards]
    for rec in (r[f"step_{shards}"] for r in res):
        np.testing.assert_allclose(rec["losses"], losses, rtol=1e-5)
        for k, w in state.items():
            tol = PARAM_TOL if k in params else dict(rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(rec["state"][k].numpy(), w.numpy(),
                                       **tol, err_msg=k)
        assert rec["bytes"] == res[0][f"step_{shards}"]["bytes"]


def test_dryrun_multichip_two_gloo_ranks_on_the_cpu(capsys):
    """The four parts on two gloo ranks; the resumed loop bit-identical."""
    res = dryrun_multichip(2, device="cpu", backend="gloo")
    line = capsys.readouterr().out
    assert "dryrun_multichip(2): ok" in line and "bit-identical" in line
    assert res["world"] == 2 and res["device"] == "cpu"
    assert all(np.isfinite(res[k]) for k in (
        "dp_loss", "sp_partitioned_sum", "sharded_pretrain_loss",
        "loop_loss"))
    with pytest.raises(ValueError, match="NCCL"):
        dryrun_multichip(2, device="cpu", backend="nccl")
