"""Process-group set-up and each rank's batch, for data parallelism across
processes and hosts.

Counterpart of ``scgib_tpu/parallel/multihost.py``.  The JAX package has one
process a host driving that host's devices: ``initialize_distributed``
joins the processes, ``global_data_mesh`` spans every device of every
process, and ``global_batch_from_local`` stitches each host's stacked
per-device batches into global arrays sharded over the mesh.  Here a
process drives one card (``torchrun``'s layout), so:

- ``initialize_distributed`` joins the processes (NCCL on the cards; gloo
  only for ``device="cpu"``), reading ``torchrun``'s variables;
- ``global_data_mesh`` is (the group of every process, this rank's
  device);
- ``global_batch_from_local`` has nothing to stitch: each rank keeps its
  own packed batch, moved to its device, and the data-parallel steps
  (``parallel/dp.py``) reduce across the ranks.

As in the JAX package, a single process needs none of it:
``initialize_distributed`` is then a no-op.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           device: str = "cuda") -> None:
    """Join the process group.  The arguments default from ``torchrun``'s
    variables (``MASTER_ADDR`` / ``MASTER_PORT`` as ``env://``,
    ``WORLD_SIZE``, ``RANK``; the card is ``LOCAL_RANK``'s, else the rank's
    modulo the cards).  No-op for a single process given no
    ``init_method``.  ``device="cuda"``: NCCL, raising where CUDA is
    absent (never gloo in its place); ``"cpu"``: gloo."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if world_size <= 1 and init_method is None:
        return
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: CUDA is not "
                               "available; pass device='cpu' for gloo")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unknown device {device!r} (cuda | cpu)")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def global_data_mesh() -> Tuple[object, torch.device]:
    """(the group of every process, this rank's device): the data mesh of
    ``parallel/dp.py``'s steps, and where this rank's batch goes."""
    group = dist.group.WORLD
    if dist.get_backend(group) == "nccl":
        return group, torch.device("cuda", torch.cuda.current_device())
    return group, torch.device("cpu")


def global_batch_from_local(local_batch, device):
    """This rank's batch on its device: each rank keeps its own packed
    batch (a container or an array), where the JAX package assembles a
    global array from every host's."""
    if hasattr(local_batch, "to"):
        return local_batch.to(device)
    return torch.from_numpy(local_batch).to(device)
