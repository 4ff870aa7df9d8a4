"""k-step transition matrices (NetMF-style log transition) for the
``recons_type='logM'`` reconstruction loss.

Counterpart of ``scgib_tpu/graph/transition.py`` (the reference's
``util.getM_logM`` / ``GetProbTranMat``, util.py:60-91): per graph, the
binary adjacency's powers A^1 .. A^k, each column-normalized, log'ed,
shifted by -log(1/n) and clamped at 0.  ``transition_logm`` is the per-graph
NumPy form, ``transition_logm_batched`` the batched one (one padded
[B, N, N] product chain in torch on the CPU, where the JAX package runs it
jitted on its device), and ``pack_logm_targets`` lays a batch's matrices out
block-diagonally for the loss.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .batching import GraphData


def transition_logm(graph: GraphData, k: int) -> List[np.ndarray]:
    """[logM_1 ... logM_k], each [n, n] float32, computed in float64."""
    n = graph.num_nodes
    A = np.zeros((n, n), dtype=np.float64)
    A[graph.senders, graph.receivers] = 1.0
    out: List[np.ndarray] = []
    Ak = np.eye(n, dtype=np.float64)
    for _ in range(k):
        Ak = Ak @ A
        col = Ak.sum(axis=0, keepdims=True)
        with np.errstate(divide="ignore", invalid="ignore"):
            p = np.log(Ak / col) - np.log(1.0 / n)
        p[~np.isfinite(p)] = 0.0
        p[p < 0] = 0.0
        out.append(p.astype(np.float32))
    return out


def logm_batch(adj: torch.Tensor, n_valid: torch.Tensor,
               k: int) -> torch.Tensor:
    """logM_1..k of a zero-padded batch of graphs at once: ``adj`` [B, N, N]
    binary float32, ``n_valid`` [B] node counts -> [B, k, N, N].  Padding
    rows and columns give 0/0 or log 0, both clamped to 0 as the reference
    clamps them."""
    log_n = torch.log(n_valid.to(torch.float32))[:, None, None]
    Ak = torch.eye(adj.shape[1], dtype=adj.dtype,
                   device=adj.device).expand_as(adj)
    out = []
    for _ in range(k):
        Ak = Ak @ adj
        p = torch.log(Ak / Ak.sum(dim=1, keepdim=True)) + log_n
        p = torch.where(torch.isfinite(p), p, torch.zeros_like(p))
        out.append(p.clamp_min(0.0))
    return torch.stack(out, 1)


def transition_logm_batched(graphs: Sequence[GraphData], k: int,
                            chunk: int = 512) -> List[List[np.ndarray]]:
    """``transition_logm`` for many graphs: chunks of graphs sorted by
    size, each padded to a multiple of 16 nodes and run through
    ``logm_batch`` on the CPU, the valid blocks cropped back out.  Path
    counts are exact integers in float32 at molecular sizes, so this agrees
    with the per-graph form to float32 rounding of the log."""
    out: List[List[np.ndarray]] = [None] * len(graphs)
    order = np.argsort([g.num_nodes for g in graphs], kind="stable")
    for start in range(0, len(order), chunk):
        idx = order[start:start + chunk]
        nmax = max(int(graphs[i].num_nodes) for i in idx)
        N = max(16, -(-nmax // 16) * 16)
        adj = np.zeros((len(idx), N, N), dtype=np.float32)
        nv = np.zeros((len(idx),), dtype=np.float32)
        for b, i in enumerate(idx):
            g = graphs[i]
            adj[b, g.senders, g.receivers] = 1.0
            nv[b] = g.num_nodes
        res = logm_batch(torch.from_numpy(adj), torch.from_numpy(nv),
                         k).numpy()
        for b, i in enumerate(idx):
            n = int(graphs[i].num_nodes)
            out[i] = [res[b, j, :n, :n].copy() for j in range(k)]
    return out


def pack_logm_targets(graphs: Sequence[GraphData],
                      logms: Sequence[List[np.ndarray]], num_nodes: int,
                      k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Block-diagonal padded targets T [k, N, N] (graph g's logM_i in its
    node block) and weights W [N, N] with 1/n_g^2 inside each block (the
    reference's per-graph ``/(row_num*col_num)``, models.py:779-780)."""
    T = np.zeros((k, num_nodes, num_nodes), dtype=np.float32)
    W = np.zeros((num_nodes, num_nodes), dtype=np.float32)
    off = 0
    for g, lm in zip(graphs, logms):
        n = g.num_nodes
        for i in range(k):
            T[i, off:off + n, off:off + n] = lm[i]
        W[off:off + n, off:off + n] = 1.0 / float(n * n)
        off += n
    return T, W
