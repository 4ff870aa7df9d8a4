"""The rank processes of the data-parallel tests (``test_torch_dp.py``,
``test_torch_multihost.py``), and the data both sides build.  torch and
numpy only: a spawned rank imports this file as a script, never a test
module (which would import JAX).

    python tests/dp_cases.py <case> <rank> <world> <port> <dir>

joins a gloo world of ``world`` processes on localhost through
``initialize_distributed``, reading ``torchrun``'s variables, runs the
case's steps and writes what it saw to ``<dir>/<case>-<rank>.pt``; the
model's starting weights come from ``<dir>/weights.pt``.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from scgib_tpu_torch.data.loader import (  # noqa: E402
    Capacities, GraphDataset, pack_batch, plan_capacities, superbatch_spec,
    wire_superbatches)
from scgib_tpu_torch.data.synthetic import random_dataset  # noqa: E402
from scgib_tpu_torch.models.scgib import (FinetuneModel,  # noqa: E402
                                          PretrainModel)
from scgib_tpu_torch.utils.params import init_flax_style_  # noqa: E402

IN, HID, DT = 9, 16, 8
LR, WD = 1e-4, 5e-5
FT_LR, FT_WD = 1e-3, 1e-5
WORLD = 4
PER_SHARD = 4                 # graphs a rank
UNEVEN = (3, 2, 1, 0)         # graphs a rank in the uneven case: 3 empty
SUPER_K, SUPER_BATCH = 2, 4
PRETRAIN = dict(hidden=HID, d_transfer=DT, num_layers=2, deterministic=True)
FINETUNE = dict(num_out=1, hidden=HID, d_transfer=DT, num_layers=2,
                deterministic=True)


def dataset(num_tasks=None):
    return GraphDataset(random_dataset(WORLD * PER_SHARD, seed=7,
                                       min_nodes=8, max_nodes=20,
                                       num_tasks=num_tasks), k=1)


def shard_caps(ds):
    return plan_capacities(ds, PER_SHARD)


def union_caps(caps, world=WORLD):
    return Capacities(*(world * getattr(caps, f.name)
                        for f in dataclasses.fields(caps)))


def shard(ds, caps, rank, counts=None):
    """Rank ``rank``'s batch: its ``PER_SHARD`` graphs (``counts[rank]``
    of them, the ranks' counts taken in order, with ``counts``).  An empty
    shard is a one-graph batch with every mask cleared, as the JAX
    package's test makes it: the ranks' batches keep one layout."""
    counts = counts or (PER_SHARD,) * WORLD
    start = sum(counts[:rank])
    n = counts[rank]
    g, sub = pack_batch(ds, np.arange(start, start + max(n, 1)), caps,
                        use_flat=True)
    if n == 0:
        g = dataclasses.replace(g, **{k: np.zeros_like(getattr(g, k))
                                      for k in ("node_mask", "edge_mask",
                                                "graph_mask")})
        sub = dataclasses.replace(sub, **{k: np.zeros_like(getattr(sub, k))
                                          for k in ("node_mask",
                                                    "edge_mask")})
    return g, sub


def union(ds, caps, counts=None):
    """The single-device batch of every rank's graphs."""
    counts = counts or (PER_SHARD,) * WORLD
    return pack_batch(ds, np.arange(sum(counts)), union_caps(caps),
                      use_flat=True)


def start_weights(seed=0):
    """The starting weights of the pretraining and fine-tuning models."""
    pre = PretrainModel(IN, **PRETRAIN)
    init_flax_style_(pre, torch.Generator().manual_seed(seed))
    ft = FinetuneModel(IN, **FINETUNE)
    init_flax_style_(ft, torch.Generator().manual_seed(seed + 1))
    return {"pretrain": pre.state_dict(), "finetune": ft.state_dict()}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(case, world, out_dir, timeout=300):
    """Run ``case`` on ``world`` rank processes; returns their results in
    rank order."""
    port = str(free_port())
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(r),
         str(world), port, str(out_dir)],
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {case} exited {p.returncode}:"
                               f"\n{out[-4000:]}")
    return [torch.load(os.path.join(out_dir, f"{case}-{r}.pt"),
                       weights_only=False) for r in range(world)]


# --- in a rank ------------------------------------------------------------------

def state_bytes(model, opt=None, gen=None):
    out = {f"model {k}": v.numpy().tobytes()
           for k, v in model.state_dict().items()}
    if opt is not None:
        for name, p in model.named_parameters():
            for key, t in opt.state.get(p, {}).items():
                out[f"adam {name} {key}"] = t.numpy().tobytes()
    if gen is not None:
        out["generator"] = gen.get_state().numpy().tobytes()
    return out


def _pretrain_model(weights, group, **kw):
    model = PretrainModel(IN, **{**PRETRAIN, **kw}, group=group)
    model.load_state_dict(weights["pretrain"])
    return model


def dp_case(rank, group, weights, out_dir):
    from scgib_tpu_torch.parallel import dp
    from scgib_tpu_torch.train import checkpoint, trainer
    from scgib_tpu_torch.train.loops import jax_key
    from scgib_tpu_torch.train.trainer import (TrainState, adam_l2,
                                               make_pretrain_step,
                                               masked_adam,
                                               finetune_trainable_mask)
    from scgib_tpu_torch.utils import counters
    import torch.distributed as dist

    res = {}
    ds = dataset()
    caps = shard_caps(ds)
    mine = [shard(ds, caps, r) for r in range(WORLD)]
    g, sub = (b.to("cpu") for b in mine[rank])
    # stack_batches + shard_batch: this rank's slice is its own batch
    st = dp.shard_batch(group, dp.stack_batches([b[1] for b in mine]))
    res["shard_equal"] = all(
        np.array_equal(getattr(st, f.name), getattr(mine[rank][1], f.name))
        for f in dataclasses.fields(st)
        if isinstance(getattr(st, f.name), np.ndarray))

    # the pretraining step, twice
    model = _pretrain_model(weights, group)
    opt = adam_l2(model, LR, WD)
    step = dp.make_dp_pretrain_step(model, opt, group)
    res["losses"] = [float(x) for x in step(g, sub)]
    res["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
    res["params"] = {k: v.clone() for k, v in model.state_dict().items()}
    step(g, sub)
    res["state2"] = state_bytes(model, opt)

    # the literal dense reconstruction: this rank's rows against every
    # rank's columns
    model = _pretrain_model(weights, group, recons_impl="dense")
    step = dp.make_dp_pretrain_step(model, adam_l2(model, LR, WD), group)
    res["dense_losses"] = [float(x) for x in step(g, sub)]
    res["dense_grads"] = {k: p.grad.clone()
                          for k, p in model.named_parameters()}

    # one rank's pooling flag False: every rank takes the scatter branch
    model = _pretrain_model(weights, group)
    step = dp.make_dp_pretrain_step(model, adam_l2(model, LR, WD), group)
    counters.reset("pool")
    flagged = dataclasses.replace(sub, pool_fits=rank != 0)
    res["flag_losses"] = [float(x) for x in step(g, flagged)]
    res["flag_branches"] = counters.of("pool")

    # uneven shards, the last one empty
    ug, usub = (b.to("cpu") for b in shard(ds, caps, rank, UNEVEN))
    model = _pretrain_model(weights, group)
    step = dp.make_dp_pretrain_step(model, adam_l2(model, LR, WD), group)
    res["uneven_losses"] = [float(x) for x in step(ug, usub)]

    # the supervised step, the reference freeze, BCE as (sum, count)
    lds = dataset(num_tasks=1)
    fg, fsub = (b.to("cpu") for b in shard(lds, shard_caps(lds), rank))
    model = FinetuneModel(IN, **FINETUNE, group=group)
    model.load_state_dict(weights["finetune"])
    opt = masked_adam(model, finetune_trainable_mask(model), FT_LR, FT_WD)
    step = dp.make_dp_finetune_step(model, opt, group, dp.bce_sum_count)
    res["ft_loss"] = float(step(fg, fsub))
    res["ft_grads"] = {k: p.grad.clone() for k, p in model.named_parameters()
                       if p.grad is not None}
    res["ft_params"] = {k: v.clone() for k, v in model.state_dict().items()}

    # the superbatch loop: 3 steps, against 2, an autosave, a fresh state
    # loading it and 1 more (noise on, each rank's own generator)
    sds = GraphDataset(random_dataset(WORLD * SUPER_BATCH * SUPER_K * 2,
                                      seed=5, min_nodes=6, max_nodes=14),
                       k=1)
    scaps = plan_capacities(sds, SUPER_BATCH)
    spec = superbatch_spec(sds, SUPER_BATCH, scaps, SUPER_K)
    bufs = [next(wire_superbatches(sds, SUPER_BATCH, scaps, SUPER_K,
                                   seed=100 * i + rank, byte_spec=spec))
            for i in range(3)]

    def fresh():
        m = _pretrain_model(weights, group, deterministic=False)
        o = adam_l2(m, 1e-3, WD)
        return m, o, dp.make_dp_superbatch_step(m, o, group, spec)

    def run(step, gen, items):
        return [step(torch.from_numpy(buf), fits, gen)
                for buf, _, fits in items]

    m, o, step = fresh()
    gen = torch.Generator().manual_seed(rank)
    res["super_losses"] = run(step, gen, bufs)
    want = state_bytes(m, o, gen)
    m, o, step = fresh()
    gen = torch.Generator().manual_seed(rank)
    run(step, gen, bufs[:2])
    path = os.path.join(out_dir, f"autosave-{rank}.msgpack")
    checkpoint.save_train_state(path, TrainState(m, o, 2 * SUPER_K), 1,
                                jax_key(0), extra={
                                    "torch_rng": gen.get_state().numpy()})
    m, o, step = fresh()
    state = TrainState(m, o)
    _, _, extra = checkpoint.load_train_state(path, state)
    gen = torch.Generator()
    gen.set_state(torch.from_numpy(np.array(extra["torch_rng"], np.uint8)))
    run(step, gen, bufs[2:])
    got = state_bytes(m, o, gen)
    res["super_apart"] = [k for k in want if want[k] != got[k]]
    res["super_state"] = {k: v for k, v in got.items() if k != "generator"}
    res["super_step"] = state.step

    # the capture guard lets the collectives through
    t = torch.ones(3)
    with trainer.CaptureGuard():
        dist.all_reduce(t, group=group)
    res["guarded_sum"] = t.tolist()

    # world size 1 (rank 0 alone): the DP step is bitwise the single step,
    # noise on, 3 steps
    solo = dist.new_group([0])
    if rank == 0:
        runs = []
        for dp_group in (None, solo):
            m = _pretrain_model(weights, dp_group, deterministic=False)
            o = adam_l2(m, LR, WD)
            gen = torch.Generator().manual_seed(3)
            s = (make_pretrain_step(m, o) if dp_group is None
                 else dp.make_dp_pretrain_step(m, o, dp_group))
            losses = [t.numpy().tobytes() for _ in range(3)
                      for t in s(g, sub, gen)]
            runs.append((losses, state_bytes(m, o, gen)))
        (la, sa), (lb, sb) = runs
        res["solo_apart"] = ([i for i, (a, b) in enumerate(zip(la, lb))
                              if a != b], [k for k in sa if sa[k] != sb[k]])
    return res


def multihost_case(rank, group, weights, out_dir):
    from scgib_tpu_torch.parallel import dp, multihost
    from scgib_tpu_torch.train.trainer import adam_l2

    mesh, device = multihost.global_data_mesh()
    ds = dataset()
    caps = shard_caps(ds)
    g, sub = (multihost.global_batch_from_local(b, device)
              for b in shard(ds, caps, rank))
    model = _pretrain_model(weights, mesh)
    step = dp.make_dp_pretrain_step(model, adam_l2(model, LR, WD),
                                    dp.make_mesh(mesh))
    return {"losses": [float(x) for x in step(g, sub)],
            "world": torch.distributed.get_world_size(mesh),
            "device": str(device)}


def main(argv):
    case, rank, world, port, out_dir = argv
    torch.set_num_threads(1)
    from scgib_tpu_torch.parallel.multihost import initialize_distributed
    import torch.distributed as dist

    # the variables torchrun sets: initialize_distributed reads them
    assert os.environ["RANK"] == rank and os.environ["MASTER_PORT"] == port
    initialize_distributed(device="cpu")
    assert dist.get_world_size() == int(world)
    weights = torch.load(os.path.join(out_dir, "weights.pt"))
    fn = {"dp": dp_case, "multihost": multihost_case}[case]
    res = fn(int(rank), dist.group.WORLD, weights, out_dir)
    torch.save(res, os.path.join(out_dir, f"{case}-{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
