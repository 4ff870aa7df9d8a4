"""One rank of the sync-BN check of ``masked_bn_relu`` over gloo:

    python tests/bn_sync_ranks.py RANK WORLD PORT OUT_DIR DEVICE

Each of WORLD ranks takes its ROWS rows of one seeded batch (width F, a row
mask keeping ~80%) and runs, with the ranks as one sync-BN group: the
four-kernel operation ``masked_bn_relu`` in float32 (on the CPU its plain
kernels), and ``MaskedBatchNorm``'s composed ops with relu and the row
mask in float64; rank 0 also runs the operation on the union batch alone.
Each run's output, the gradients of x, scale and bias under
sum(out * ct), and the running statistics go to ``OUT_DIR/rank{R}.pt``.
``test_torch_batchnorm.py`` (CPU) and ``test_torch_cuda.py`` (DEVICE cuda,
both ranks on the one card) start the ranks and compare.
"""

import copy
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from scgib_tpu_torch.models.layers import (  # noqa: E402
    MaskedBatchNorm, _mask_rows)
from scgib_tpu_torch.ops.kernels import batchnorm as kbn  # noqa: E402
from scgib_tpu_torch.parallel import multihost  # noqa: E402

ROWS, F = 1000, 64


def batch(world):
    """The union batch (x, ct, mask) and the module, from one seed."""
    gen = torch.Generator().manual_seed(11)
    x = 1.5 + torch.randn(world * ROWS, F, generator=gen)
    ct = torch.randn(world * ROWS, F, generator=gen)
    mask = torch.rand(world * ROWS, generator=gen) < 0.8
    bn = MaskedBatchNorm(F)
    with torch.no_grad():
        bn.scale.copy_(1 + 0.3 * torch.randn(F, generator=gen))
        bn.bias.copy_(0.2 * torch.randn(F, generator=gen))
    return x, ct, mask, bn


def run(bn, x, ct, mask, fused, group, dev, dtype):
    bn = copy.deepcopy(bn).to(dev, dtype).train()
    bn.group = group
    x = x.to(dev, dtype).requires_grad_()
    mask = mask.to(dev)
    if fused:
        out = kbn.masked_bn_relu(x, mask, bn.scale, bn.bias, bn.mean, bn.var,
                                 training=True, group=group)
    else:
        out = _mask_rows(torch.relu(bn(x, mask)), mask)
    (out * ct.to(dev, dtype)).sum().backward()
    return {k: v.detach().cpu().double() for k, v in (
        ("y", out), ("dx", x.grad), ("dscale", bn.scale.grad),
        ("dbias", bn.bias.grad), ("mean", bn.mean), ("var", bn.var))}


def main(rank, world, port, out_dir, device):
    rank, world = int(rank), int(world)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize_distributed(f"tcp://127.0.0.1:{port}",
                                     world_size=world, rank=rank,
                                     device="cpu")
    try:
        group = dist.group.WORLD
        x, ct, mask, bn = batch(world)
        mine = slice(rank * ROWS, (rank + 1) * ROWS)
        out = {"kernels": run(bn, x[mine], ct[mine], mask[mine], True, group,
                              dev, torch.float32),
               "composed": run(bn, x[mine], ct[mine], mask[mine], False,
                               group, dev, torch.float64)}
        if rank == 0:
            out["union"] = run(bn, x, ct, mask, True, None, dev,
                               torch.float32)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(out_dir, device, world=2, timeout=300):
    """Start the ranks, wait for them, and return their results."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(r), str(world), port, str(out_dir),
                               device], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
            for r in range(world)]


def gaps(ranks):
    """The largest error of each quantity, relative to the largest entry of
    what it is held to: the ranks' kernels against their composed ops in
    float64 (rows concatenated; dscale, dbias and the running statistics
    rank by rank), and against the union batch's kernels alone (dscale
    and dbias summed over the ranks, as data parallelism sums them)."""
    def gap(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    out = {}
    for name in ("y", "dx"):
        got = torch.cat([r["kernels"][name] for r in ranks])
        out[name, "composed"] = gap(got, torch.cat(
            [r["composed"][name] for r in ranks]))
        out[name, "union"] = gap(got, ranks[0]["union"][name])
    for name in ("dscale", "dbias", "mean", "var"):
        out[name, "composed"] = max(gap(r["kernels"][name],
                                        r["composed"][name]) for r in ranks)
        got = (sum(r["kernels"][name] for r in ranks)
               if name in ("dscale", "dbias") else ranks[1]["kernels"][name])
        out[name, "union"] = gap(got, ranks[0]["union"][name])
    return out


if __name__ == "__main__":
    main(*sys.argv[1:])
