"""The rank processes of the node-sharded tests (``test_torch_sharded.py``),
and the data both sides build.  torch and numpy only: a spawned rank runs
this file as a script and never imports a test module (which would import
JAX).

    python tests/sharded_cases.py <rank> <world> <port> <dir>

joins a gloo world of ``world`` processes on localhost, runs every case
over the world (4 ranks), over ``new_group([0, 1])`` and over
``new_group([0])``, and writes what it saw to ``<dir>/sharded-<rank>.pt``.
The model's starting weights (the JAX model's initial variables, through
``utils/params.py::from_jax_variables``) come from ``<dir>/weights.pt``.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (ROOT, os.path.dirname(os.path.abspath(__file__))):
    if path not in sys.path:
        sys.path.insert(0, path)

from dp_cases import free_port, state_bytes  # noqa: E402
from scgib_tpu_torch.data.synthetic import random_dataset  # noqa: E402
from scgib_tpu_torch.graph.batching import (pack_graphs,  # noqa: E402
                                            pack_subgraphs)
from scgib_tpu_torch.graph.egonet import extract_egonets  # noqa: E402

IN, HID, DT = 9, 32, 16
WORLD = 4
SHARDS = (1, 2, 4)
LR, WD = 1e-4, 5e-5
MODEL = dict(hidden=HID, d_transfer=DT, deterministic=True)
# the ops' data: the ring over random edges spanning the whole ring
RING_N, RING_E, RING_D = 128, 700, 16
# the global segment ops' data: rows of sorted ids over shard borders
SEG_N, SEG_D, SEG_G = 128, 8, 12


def union_batch():
    """The JAX test's union batch (``tests/test_sharded_scgib.py``): 6
    graphs of 10-20 nodes, node capacity 128, no band."""
    return _pack(random_dataset(6, seed=0, min_nodes=10, max_nodes=20,
                                feat_dim=IN), 128, 1024, 8, 1024, 4096)


def spanning_batch():
    """2 graphs of 12-15 nodes in 32 node rows: at 4 ranks of 8 nodes each
    graph spans shards, and an edge joins shards 2 apart (radius 2)."""
    return _pack(random_dataset(2, seed=7, min_nodes=12, max_nodes=15,
                                feat_dim=IN), 32, 256, 4, 256, 1024)


def _pack(graphs, n, e, ng, sn, se):
    egos = [extract_egonets(g, 1) for g in graphs]
    return (pack_graphs(graphs, n, e, ng, banded=False),
            pack_subgraphs(graphs, egos, sn, se, banded=False))


def packed_edges():
    """The JAX test's packed batch for ``partitioned_spmm`` (16 graphs of
    8-30 nodes, seed 41), its real edges and features of width 32."""
    g = pack_graphs(random_dataset(16, seed=41, min_nodes=8, max_nodes=30),
                    512, 2048, 16, banded=False)
    m = g.edge_mask
    h = np.random.default_rng(0).normal(size=(512, 32)).astype(np.float32)
    return g.senders[m], g.receivers[m], h


def ring_data():
    """Random edges over the whole ring (``tests/test_edge_partition.py``'s
    adversarial case), features, and the cotangent of the ring's output."""
    rng = np.random.default_rng(3)
    s = rng.integers(0, RING_N, size=RING_E).astype(np.int32)
    r = rng.integers(0, RING_N, size=RING_E).astype(np.int32)
    h = rng.normal(size=(RING_N, RING_D)).astype(np.float32)
    w = rng.normal(size=(RING_N, RING_D)).astype(np.float32)
    return s, r, h, w


def seg_data():
    """Rows with sorted global segment ids (segments span shards; two ids
    never occur), a mask, and cotangents."""
    rng = np.random.default_rng(5)
    ids = np.sort(rng.integers(0, SEG_G - 2, size=SEG_N)).astype(np.int32)
    mask = rng.random(SEG_N) < 0.8
    data = rng.normal(size=(SEG_N, SEG_D)).astype(np.float32)
    logits = (3 * rng.normal(size=SEG_N)).astype(np.float32)
    w = rng.normal(size=(SEG_N, SEG_D)).astype(np.float32)
    ws = rng.normal(size=SEG_N).astype(np.float32)
    return ids, mask, data, logits, w, ws


def spawn(world, out_dir, timeout=300):
    """Start ``world`` rank processes; returns a function that waits for
    them and gives their results in rank order."""
    import subprocess

    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         port, str(out_dir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def results():
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                p.kill()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"sharded rank {r} exited "
                                   f"{p.returncode}:\n{out[-4000:]}")
        return [torch.load(os.path.join(out_dir, f"sharded-{r}.pt"),
                           weights_only=False) for r in range(world)]
    return results


# --- in a rank ---------------------------------------------------------------

def _rows(a, rank, world):
    per = a.shape[0] // world
    return torch.from_numpy(np.ascontiguousarray(a[rank * per:
                                                   (rank + 1) * per]))


def _plan_slice(plan, rank):
    return [torch.from_numpy(np.ascontiguousarray(a[:, rank])).to(dtype)
            for a, dtype in ((plan.senders_owner_local, torch.int64),
                             (plan.receivers_local, torch.int64),
                             (plan.edge_mask, torch.bool))]


def ops_case(rank, group, world):
    """The collectives and ops on this rank's rows: values and gradients."""
    from scgib_tpu_torch.parallel import sharded_ops as so
    from scgib_tpu_torch.parallel.edge_partition import (
        partition_edges, partition_edges_ring, partitioned_spmm,
        ring_partitioned_spmm)

    res = {}
    s, r, h = packed_edges()
    part = partition_edges(s, r, 512, world)
    res["allgather_spmm"] = partitioned_spmm(
        _rows(h, rank, world), torch.from_numpy(
            part.senders_global[rank]).long(),
        torch.from_numpy(part.receivers_local[rank]).long(),
        torch.from_numpy(part.edge_mask[rank]), group)

    s, r, h, w = ring_data()
    plan = partition_edges_ring(s, r, RING_N, world)
    res["radius"] = plan.radius
    mine = _plan_slice(plan, rank)
    x = _rows(h, rank, world).requires_grad_()
    out = ring_partitioned_spmm(x, *mine, group)
    (out * _rows(w, rank, world)).sum().backward()
    res["ring_spmm"], res["ring_spmm_grad"] = out.detach(), x.grad
    x = _rows(h, rank, world).requires_grad_()
    val = so.ring_sddmm_sum(x, *mine, group)
    val.backward()
    res["sddmm"], res["sddmm_grad"] = val.detach(), x.grad

    ids, mask, data, logits, w, ws = seg_data()
    ids, mask = _rows(ids, rank, world).long(), _rows(mask, rank, world)
    x = _rows(data, rank, world).requires_grad_()
    res["gseg_sum"] = so.gseg_sum(x, ids, SEG_G, group, mask)
    res["gseg_count"] = so.gseg_count(ids, SEG_G, group, mask)
    mean = so.gseg_mean(x, ids, SEG_G, group, mask)
    res["gseg_mean"] = mean
    res["gseg_std_mean"] = torch.stack(so.gseg_std_mean(
        x, ids, SEG_G, group, mask))
    res["gseg_max"] = so.gseg_max(x, ids, SEG_G, group, mask)
    # sum(mean * cotangent) and sum(softmax * cotangent): each rank's own
    # term, the cotangent of the replicated mean counted once (rank 0's)
    lt = _rows(logits, rank, world).requires_grad_()
    alpha = so.gseg_softmax(lt, ids, SEG_G, group, mask)
    res["gseg_softmax"] = alpha
    wm = torch.from_numpy(w[:SEG_G]) * float(rank == 0)
    ((mean * wm).sum() + (alpha * _rows(ws, rank, world)).sum()).backward()
    res["gseg_mean_grad"], res["gseg_softmax_grad"] = x.grad, lt.grad
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in res.items()}


def wrong_way_ring_grad(rank, group, world):
    """The ring's gradient with its backward shifted the same way as the
    forward (a planted fault)."""
    from scgib_tpu_torch.parallel import collectives
    from scgib_tpu_torch.parallel.edge_partition import (
        partition_edges_ring, ring_partitioned_spmm)

    real = collectives._RingShift.backward

    def same_way(ctx, grad):
        return collectives._shift(grad, ctx.shift, ctx.group), None, None
    collectives._RingShift.backward = staticmethod(same_way)
    try:
        s, r, h, w = ring_data()
        plan = partition_edges_ring(s, r, RING_N, world)
        x = _rows(h, rank, world).requires_grad_()
        out = ring_partitioned_spmm(x, *_plan_slice(plan, rank), group)
        (out * _rows(w, rank, world)).sum().backward()
        return x.grad
    finally:
        collectives._RingShift.backward = real


def _local(batch_fn, rank, world):
    from scgib_tpu_torch.parallel.sharded_batch import (local_slice,
                                                        shard_pretrain_batch)

    sharded = shard_pretrain_batch(*batch_fn(), world)
    return local_slice(sharded, rank).to("cpu"), sharded.radius


def _model(weights, group, **kw):
    from scgib_tpu_torch.parallel.sharded_scgib import ShardedPretrainModel

    model = ShardedPretrainModel(IN, **MODEL, **kw, group=group)
    model.load_state_dict(weights)
    return model


def _summed_grads(model, group):
    import torch.distributed as dist

    names = [n for n, p in model.named_parameters()]
    flat = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    dist.all_reduce(flat, group=group)
    out, at = {}, 0
    for name, p in zip(names, model.parameters()):
        out[name] = flat[at:at + p.numel()].view_as(p).clone()
        at += p.numel()
    return out


def model_case(rank, group, world, weights, batch_fn, **kw):
    """Forward and backward of the sharded model on this rank's slice:
    this rank's losses, the summed losses and gradients."""
    import torch.distributed as dist

    b, radius = _local(batch_fn, rank, world)
    model = _model(weights, group, **kw)
    model.train()
    losses = model(b)
    losses.total.backward()
    local = torch.stack(tuple(losses)).detach()
    summed = local.clone()
    dist.all_reduce(summed, group=group)
    return {"local": local.tolist(), "summed": summed.tolist(),
            "grads": _summed_grads(model, group), "radius": radius}


def step_case(rank, group, world, weights):
    """One sharded Adam step: the state after it, and its bytes."""
    from scgib_tpu_torch.parallel.sharded_scgib import (
        make_sharded_pretrain_step)
    from scgib_tpu_torch.train.trainer import adam_l2

    b, _ = _local(union_batch, rank, world)
    model = _model(weights, group)
    opt = adam_l2(model, LR, WD)
    losses = make_sharded_pretrain_step(model, opt, group)(b)
    return {"losses": [float(x) for x in losses],
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "bytes": state_bytes(model, opt)}


def sharded_case(rank, weights):
    import torch.distributed as dist

    groups = {1: dist.new_group([0]), 2: dist.new_group([0, 1]),
              4: dist.group.WORLD}
    res = {"ops": ops_case(rank, groups[WORLD], WORLD),
           "wrong_way_4": wrong_way_ring_grad(rank, groups[4], 4)}
    if rank < 2:
        res["wrong_way_2"] = wrong_way_ring_grad(rank, groups[2], 2)
        res["right_way_2"] = ops_case(rank, groups[2], 2)["ring_spmm_grad"]
    for world in SHARDS:
        if rank >= world:
            continue
        grp = groups[world]
        res[f"model_{world}"] = model_case(rank, grp, world, weights,
                                           union_batch)
        res[f"reference_{world}"] = model_case(
            rank, grp, world, weights, union_batch, kl_mode="reference")
        res[f"step_{world}"] = step_case(rank, grp, world, weights)
    res["spanning"] = model_case(rank, groups[4], 4, weights,
                                 spanning_batch)
    return res


def main(argv):
    rank, world, port, out_dir = argv
    torch.set_num_threads(1)
    import torch.distributed as dist
    from scgib_tpu_torch.parallel.multihost import initialize_distributed

    initialize_distributed(f"tcp://127.0.0.1:{port}", world_size=int(world),
                           rank=int(rank), device="cpu")
    weights = torch.load(os.path.join(out_dir, "weights.pt"))
    res = sharded_case(int(rank), weights)
    torch.save(res, os.path.join(out_dir, f"sharded-{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
