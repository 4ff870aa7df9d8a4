"""Graph batch containers — fixed-capacity padded batches as dataclasses.

Counterpart of ``scgib_tpu/graph/container.py``.  The host packers
(``graph/batching.py``) fill these with NumPy arrays; ``.to(device)`` turns
every field into a tensor on the device: indices become int64 (what
PyTorch's indexing and ``index_add_`` take), masks bool, features float32.

``band_blocks`` may be ``None`` while ``band_col_off`` is set (the packers'
``banded="device"`` mode): the model builds the blocks on the device at first
use and caches them on the batch (``models/scgib.py::_resolve_band``), the
eager counterpart of XLA hoisting the block build out of a scanned step.

``gt_fits`` is a plain bool, not an array: every graph (ego-net) of the
dataset fits the graph-transformer's narrow banded geometry
(``graph/banded.py::gt_band_fits``).  So is a ``SubgraphBatch``'s
``pool_fits``: the candidate pooling's window holds every center tile's
sub-rows (``ops/pool.py::window_fits``), or None where the packer was not
given the centers' capacity.  ``.to`` and ``from_numpy`` pass both through
unchanged, and ``band_width`` too: the width of the banded layout, one a
dataset for its graphs and one for its ego-nets (``graph/banded.py::
band_width``; ``BAND`` = 256 where a batch object has none, as the JAX
package's have not).

``DenseSubgraphBatch`` is the dense ego-net layout (``subgraph_mode=
"dense"``): one slot of ``max_sub`` members per center node, with a dense
within-ego adjacency block.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .banded import BAND

_INDEX_FIELDS = ("node_graph", "senders", "receivers", "band_col_off",
                 "node_center", "node_orig")
_MASK_FIELDS = ("node_mask", "edge_mask", "graph_mask", "label_mask",
                "mask")


def _to_tensor(name: str, value, device: torch.device):
    if name == "band_width":
        return BAND if value is None else int(value)
    if name == "gt_fits":
        return bool(value)
    if name == "pool_fits":
        return None if value is None else bool(value)
    if value is None:
        return None
    if name in _INDEX_FIELDS:
        dtype = torch.int64
    elif name in _MASK_FIELDS:
        dtype = torch.bool
    elif name == "band_blocks":
        dtype = torch.bfloat16
    else:
        dtype = torch.float32
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return torch.from_numpy(np.asarray(value)).to(device=device, dtype=dtype)


class _Batch:
    def to(self, device):
        """A copy with every array field a tensor on ``device``."""
        device = torch.device(device)
        return dataclasses.replace(self, **{
            f.name: _to_tensor(f.name, getattr(self, f.name), device)
            for f in dataclasses.fields(self)})

    @classmethod
    def from_numpy(cls, batch, device):
        """Convert any batch object with this class's field names (the
        port's packers, or the JAX package's NumPy-backed batches) into a
        tensor batch on ``device``."""
        device = torch.device(device)
        return cls(**{f.name: _to_tensor(f.name, getattr(batch, f.name, None),
                                         device)
                      for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class GraphBatch(_Batch):
    """A padded batch of graphs.

      node_feat  [N, F] float   node features (padding rows zero)
      node_graph [N]    index   graph id per node (padding rows 0, masked)
      node_mask  [N]    bool
      senders    [E]    index   COO source (global node id)
      receivers  [E]    index   COO destination, sorted ascending
      edge_mask  [E]    bool
      graph_mask [G]    bool
      labels     [G, T] float  per-graph labels (NaN as 0), or None
      label_mask [G, T] bool   True where a label is present
      band_blocks  [T, 128, W] bf16 0/1 banded adjacency, or None
      band_col_off [T]  index   64-aligned window starts, or None
      gt_fits      bool         the narrow (64, 128) geometry fits
      logm_targets [k, N, N] float  block-diagonal k-step logM targets,
                                    or None (``pack_batch(logm_k=...)``)
      logm_weights [N, N] float     1/n_g^2 inside each graph's block
      band_width   int          W, the band's width (static)
    """

    node_feat: object
    node_graph: object
    node_mask: object
    senders: object
    receivers: object
    edge_mask: object
    graph_mask: object
    labels: Optional[object] = None
    label_mask: Optional[object] = None
    band_blocks: Optional[object] = None
    band_col_off: Optional[object] = None
    gt_fits: bool = False
    logm_targets: Optional[object] = None
    logm_weights: Optional[object] = None
    band_width: int = BAND

    @property
    def num_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[0]


@dataclasses.dataclass
class SubgraphBatch(_Batch):
    """Flattened per-node ego-nets of a GraphBatch.

      node_feat   [S, F] float or None (None: gather g.node_feat[node_orig])
      node_center [S]    index  center node's global id in the GraphBatch
      node_orig   [S]    index  original node's global id
      node_mask   [S]    bool
      senders/receivers/edge_mask [Q]  COO over sub-nodes, receivers sorted
      band_blocks / band_col_off / gt_fits   as in GraphBatch
      pool_fits    bool or None  the pooling window holds every center
                                 tile's sub-rows (None: not computed)
      band_width   int           as in GraphBatch, the ego-nets' own
    """

    node_feat: Optional[object]
    node_center: object
    node_orig: object
    node_mask: object
    senders: object
    receivers: object
    edge_mask: object
    band_blocks: Optional[object] = None
    band_col_off: Optional[object] = None
    gt_fits: bool = False
    pool_fits: Optional[bool] = None
    band_width: int = BAND

    @property
    def num_nodes(self) -> int:
        return self.node_center.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]


@dataclasses.dataclass
class DenseSubgraphBatch(_Batch):
    """Dense-block ego-nets: row ``c`` holds the ego-net of the owning
    GraphBatch's node ``c``, padded to ``max_sub`` members.

      node_feat [C, S, F] float  member features (zero on padding)
      node_orig [C, S]    index  member's global node id
      adj       [C, S, S] float  0/1 within-ego adjacency
      mask      [C, S]    bool   real members (all False for a padded
                                 center)
    """

    node_feat: object
    node_orig: object
    adj: object
    mask: object

    @property
    def num_centers(self) -> int:
        return self.node_feat.shape[0]

    @property
    def max_sub(self) -> int:
        return self.node_feat.shape[1]
