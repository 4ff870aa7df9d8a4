"""The pretraining step, eager, and the train state it advances.

Counterpart of ``scgib_tpu/train/trainer.py::make_pretrain_step`` and
``TrainState``.  The JAX package's ``adam_l2`` is torch-style Adam with L2
added to the gradient before the moments; here that is
``torch.optim.Adam(weight_decay=wd)`` itself (coupled L2, not AdamW), which
callers pass in.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from ..graph.container import GraphBatch, SubgraphBatch
from ..models.scgib import PretrainLosses, PretrainModel, uniform_draws
from ..utils.params import to_jax_variables


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer
    (Adam's moments) and the count of optimizer steps taken: what the JAX
    package's ``TrainState`` holds.  The loop advances ``step``; the model
    and optimizer are updated in place."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @property
    def variables(self) -> dict:
        """A snapshot of the model as a flax ``{"params", "batch_stats"}``
        tree of NumPy arrays."""
        return to_jax_variables(self.model)


def make_pretrain_step(model: PretrainModel, optimizer: torch.optim.Optimizer
                       ) -> Callable[..., PretrainLosses]:
    """``step(g, sub, generator=None) -> losses``: total = KL + contrastive
    + reconstruction, one backward, one optimizer update.  The compression
    noise and the graph transformer's dropout masks come from ``generator``
    (a ``torch.Generator`` on the batch's device), the counterpart of the
    JAX step's ``noise`` and ``dropout`` streams: other bits, the same
    distribution."""

    def step(g: GraphBatch, sub: SubgraphBatch,
             generator: Optional[torch.Generator] = None) -> PretrainLosses:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        losses = model(g, sub,
                       rand=uniform_draws(generator, g.node_feat.device))
        losses.total.backward()
        optimizer.step()
        return PretrainLosses(*(t.detach() for t in losses))

    return step
