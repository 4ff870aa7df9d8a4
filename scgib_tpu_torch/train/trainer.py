"""The pretraining step, eager.

Counterpart of ``scgib_tpu/train/trainer.py::make_pretrain_step``.  The JAX
package's ``adam_l2`` is torch-style Adam with L2 added to the gradient
before the moments; here that is ``torch.optim.Adam(weight_decay=wd)``
itself (coupled L2, not AdamW), which callers pass in.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..graph.container import GraphBatch, SubgraphBatch
from ..models.scgib import PretrainLosses, PretrainModel, uniform_draws


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
