"""A multi-rank dry run of every parallel path of the port.

Counterpart of ``__graft_entry__.py::dryrun_multichip``.
``dryrun_multichip(n, device, backend)`` starts ``n`` rank processes, each
running the JAX function's four parts:

1. one data-parallel pretraining step (``dp.make_dp_pretrain_step``) at
   width 64/32, each rank with its own two-graph batch;
2. one ``PartitionedGIN`` forward and backward over the ring (8 graphs of
   5-9 nodes, width 16, 2 convs);
3. one node-sharded pretraining step
   (``sharded_scgib.make_sharded_pretrain_step``) at width 64/32 on 4n
   graphs of 10-24 nodes;
4. the data-parallel superbatch loop on the wire format (K = 2, batches of
   4, width 16/8, noise on): 3 steps, against 2, an autosave, a fresh
   state loading it and 1 more, which must be bit-identical.  It runs
   under torch's deterministic algorithms: on the card ``index_add_``'s
   atomics otherwise leave two runs of one step rounding apart (XLA's
   scatters are deterministic, so the JAX function needs no such mode).

Rank 0's summary line is printed here.  The JAX function drops to a
virtual CPU mesh when devices are missing; this one does not: the device
and the backend are the caller's.  ``backend="nccl"`` needs a card a rank
and raises with fewer; ``backend="gloo"`` ranks may share one card
(rank r on card r mod the cards) or run on the CPU (``device="cpu"``).

    python -m scgib_tpu_torch.parallel.dryrun N [cuda|cpu] [nccl|gloo]
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

_MODULE = "scgib_tpu_torch.parallel.dryrun"
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _check(n: int, device: str, backend: str):
    if device not in ("cuda", "cpu") or backend not in ("nccl", "gloo"):
        raise ValueError(f"dryrun_multichip: device {device!r} (cuda | cpu)"
                         f", backend {backend!r} (nccl | gloo)")
    if device == "cpu" and backend == "nccl":
        raise ValueError("dryrun_multichip: NCCL needs cards; pass "
                         "backend='gloo' for ranks on the CPU")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: CUDA is not available; "
                               "pass device='cpu', backend='gloo'")
        cards = torch.cuda.device_count()
        if backend == "nccl" and cards < n:
            raise RuntimeError(f"dryrun_multichip({n}): NCCL needs {n} "
                               f"cards, this host has {cards}; pass "
                               f"backend='gloo' to share them")


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: str = "nccl", timeout: float = 900.0) -> dict:
    """Run the four parts on ``n_devices`` ranks (see the module's note);
    prints rank 0's summary line and returns rank 0's readings.  Raises
    where a rank fails or a part's check does not hold."""
    _check(n_devices, device, backend)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_PACKAGE_PARENT] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    # deterministic cuBLAS needs its workspace fixed before the first call
    env.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [subprocess.Popen(
            [sys.executable, "-m", _MODULE, "--rank", str(n_devices),
             str(r), port, device, backend, out_dir], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n_devices)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"dryrun_multichip rank {r} exited "
                                   f"{p.returncode}:\n{log[-6000:]}")
        with open(os.path.join(out_dir, "rank0.json")) as f:
            res = json.load(f)
    print(res["line"], flush=True)
    return res


# --- in a rank ---------------------------------------------------------------

def _graphs_and_egos(n_graphs, seed, min_nodes, max_nodes):
    from ..data.synthetic import random_dataset
    from ..graph.egonet import extract_egonets

    graphs = random_dataset(n_graphs, seed=seed, min_nodes=min_nodes,
                            max_nodes=max_nodes, feat_dim=9)
    return graphs, [extract_egonets(g, 1) for g in graphs]


def _seeded(model):
    from ..utils.params import init_flax_style_

    return init_flax_style_(model, torch.Generator().manual_seed(0))


def _finite(*ts) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in ts)


def _dp_step(group, rank, dev) -> float:
    """Part 1: one data-parallel pretraining step, each rank's own batch of
    2 graphs of 5-9 nodes."""
    from ..graph.batching import pack_graphs, pack_subgraphs
    from ..models.scgib import PretrainModel
    from ..train.trainer import adam_l2
    from . import dp

    graphs, egos = _graphs_and_egos(2, rank, 5, 9)
    g = pack_graphs(graphs, 32, 128, 2).to(dev)
    sub = pack_subgraphs(graphs, egos, 128, 512, num_centers=32).to(dev)
    model = _seeded(PretrainModel(9, hidden=64, d_transfer=32,
                                  group=group)).to(dev)
    step = dp.make_dp_pretrain_step(model, adam_l2(model, 1e-4, 5e-5),
                                    group)
    gen = torch.Generator(device=dev).manual_seed(2 + rank)
    total = float(step(g, sub, gen).total)
    if not math.isfinite(total):
        raise AssertionError(f"non-finite DP loss {total}")
    return total


def _edge_partitioned(group, rank, n, dev) -> float:
    """Part 2: one ``PartitionedGIN`` forward and backward, sum(out^2)
    summed over the ranks."""
    from ..graph.batching import pack_graphs
    from .collectives import all_reduce_sum
    from .edge_partition import partition_edges_ring
    from .partitioned_gin import PartitionedGIN

    graphs, _ = _graphs_and_egos(8, 3, 5, 9)
    node_cap = -(-80 // n) * n
    g = pack_graphs(graphs, node_cap, 4 * node_cap, 8, banded=False)
    em = g.edge_mask
    plan = partition_edges_ring(g.senders[em], g.receivers[em], node_cap, n)
    per, d = plan.nodes_per_shard, 16
    x = np.random.default_rng(0).normal(size=(node_cap, d)).astype(
        np.float32)
    rows = slice(rank * per, (rank + 1) * per)
    enc = _seeded(PartitionedGIN(d, d, 2, group)).to(dev)
    out = enc(torch.from_numpy(x[rows]).to(dev),
              *(torch.from_numpy(a[:, rank]).to(dev) for a in (
                  plan.senders_owner_local.astype(np.int64),
                  plan.receivers_local.astype(np.int64), plan.edge_mask)),
              node_mask=torch.from_numpy(g.node_mask[rows]).to(dev))
    loss = (out ** 2).sum()
    loss.backward()
    if not _finite(*(p.grad for p in enc.parameters())):
        raise AssertionError("non-finite partitioned GIN gradient")
    return float(all_reduce_sum(loss.detach(), group))


def _full_sharded(group, rank, n, dev) -> float:
    """Part 3: one node-sharded pretraining step at width 64/32 on 4n
    graphs of 10-24 nodes."""
    from ..graph.batching import pack_graphs, pack_subgraphs
    from ..train.trainer import adam_l2
    from .sharded_batch import local_slice, shard_pretrain_batch
    from .sharded_scgib import (ShardedPretrainModel,
                                make_sharded_pretrain_step)

    n_graphs = 4 * n
    graphs, egos = _graphs_and_egos(n_graphs, 11, 10, 24)
    total_nodes = sum(gr.num_nodes for gr in graphs)
    node_cap = -(-(total_nodes + 32) // n) * n
    g = pack_graphs(graphs, node_cap, 8 * node_cap, n_graphs, banded=False)
    sub = pack_subgraphs(graphs, egos, 8 * node_cap, 32 * node_cap,
                         banded=False)
    batch = local_slice(shard_pretrain_batch(g, sub, n), rank).to(dev)
    model = _seeded(ShardedPretrainModel(9, hidden=64, d_transfer=32,
                                         group=group)).to(dev)
    step = make_sharded_pretrain_step(model, adam_l2(model, 1e-4, 5e-5),
                                      group)
    gen = torch.Generator(device=dev).manual_seed(5 + rank)
    total = float(step(batch, gen).total)
    if not math.isfinite(total):
        raise AssertionError(f"non-finite sharded loss {total}")
    return total


def _dp_loop_resume(group, rank, n, dev, out_dir) -> float:
    """Part 4: the DP superbatch loop with save, fresh state and resume,
    bit-identical to the uninterrupted run."""
    from ..data.loader import (GraphDataset, plan_capacities,
                               superbatch_spec, wire_superbatches)
    from ..data.synthetic import random_dataset
    from ..models.scgib import PretrainModel
    from ..train import checkpoint
    from ..train.loops import jax_key
    from ..train.trainer import TrainState, adam_l2
    from . import dp

    K, BATCH = 2, 4
    ds = GraphDataset(random_dataset(BATCH * K * n * 2, seed=5,
                                     min_nodes=5, max_nodes=9), k=1)
    caps = plan_capacities(ds, BATCH)
    spec = superbatch_spec(ds, BATCH, caps, K)
    bufs = []
    for i in range(3):
        buf, _, fits = next(wire_superbatches(
            ds, BATCH, caps, K, seed=i * 100 + rank, byte_spec=spec))
        bufs.append((torch.from_numpy(buf).to(dev), fits))

    def fresh():
        model = _seeded(PretrainModel(9, hidden=16, d_transfer=8,
                                      group=group)).to(dev)
        opt = adam_l2(model, 1e-3, 5e-5)
        return (TrainState(model, opt),
                dp.make_dp_superbatch_step(model, opt, group, spec),
                torch.Generator(device=dev).manual_seed(7 + rank))

    def run(state, step, gen, items):
        losses = None
        for buf, fits in items:
            losses = step(buf, fits, gen)
            state.step += K
        return losses

    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        state_a, step_a, gen_a = fresh()
        losses_a = run(state_a, step_a, gen_a, bufs)
        state_b, step_b, gen_b = fresh()
        run(state_b, step_b, gen_b, bufs[:2])
        path = os.path.join(out_dir, f"autosave{rank}.msgpack")
        checkpoint.save_train_state(path, state_b, 1, jax_key(0), extra={
            "torch_rng": gen_b.get_state().cpu().numpy()})
        state_c, step_c, gen_c = fresh()
        _, _, extra = checkpoint.load_train_state(path, state_c)
        gen_c.set_state(torch.from_numpy(np.array(extra["torch_rng"],
                                                  np.uint8)))
        losses_c = run(state_c, step_c, gen_c, bufs[2:])
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    apart = [k for k, v in state_a.model.state_dict().items()
             if not torch.equal(v, state_c.model.state_dict()[k])]
    if apart or not torch.equal(losses_a.total, losses_c.total):
        raise AssertionError(f"the resumed loop is not bit-identical: "
                             f"{apart or 'losses'}")
    return float(losses_c.total[-1])


def _rank_main(n, rank, port, device, backend, out_dir):
    from . import dp, multihost

    n, rank = int(n), int(rank)
    torch.set_num_threads(1)
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    multihost.initialize_distributed(
        f"tcp://127.0.0.1:{port}", world_size=n, rank=rank,
        device="cuda" if backend == "nccl" else "cpu")
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    group = dp.make_mesh()
    res = {"dp_loss": _dp_step(group, rank, dev),
           "sp_partitioned_sum": _edge_partitioned(group, rank, n, dev),
           "sharded_pretrain_loss": _full_sharded(group, rank, n, dev),
           "loop_loss": _dp_loop_resume(group, rank, n, dev, out_dir),
           "device": str(dev), "backend": backend, "world": n}
    bad = [k for k, v in res.items() if isinstance(v, float)
           and not math.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite dry-run readings: {bad}")
    res["line"] = (
        f"dryrun_multichip({n}): ok, dp_loss={res['dp_loss']:.4f}, "
        f"sp_partitioned_sum={res['sp_partitioned_sum']:.4f}, "
        f"sharded_pretrain_loss={res['sharded_pretrain_loss']:.4f}, "
        f"wire_loop_resume=bit-identical (final loss "
        f"{res['loop_loss']:.4f})")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        _rank_main(*sys.argv[2:])
    else:
        dryrun_multichip(int(sys.argv[1]), *sys.argv[2:4])
