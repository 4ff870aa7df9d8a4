"""Set2Set global pooling (Vinyals et al.).

Counterpart of ``scgib_tpu/models/set2set.py`` (DGL's ``Set2Set(hidden,
n_iters=2, n_layers=1)`` in the reference): per batch of graphs,

    q_star = 0 [G, 2d];  (c, h) = 0
    repeat n_iters times:
        (c, h), q = LSTM((c, h), q_star)       # input 2d -> hidden d
        e_v = <x_v, q_g(v)>;  a = softmax of e within each graph
        r_g = sum_v a_v x_v;  q_star = [q, r]
    return q_star [G, 2d]

``LSTMCell`` is flax's ``OptimizedLSTMCell``: gates i, f, o sigmoid and g
tanh, c' = f c + i g, h' = o tanh(c'), the input products without a bias
and the hidden ones with one.  Its parameters stack the four gates as rows
[i, f, g, o] (torch's order) with that one bias, so that an optimizer step
moves each gate's bias once, as optax does; ``torch.nn.LSTMCell`` would
carry two biases that both move.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.segment import segment_broadcast, segment_softmax, segment_sum
from ..utils.params import lecun_normal_


class LSTMCell(nn.Module):
    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, in_dim))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden))
        self.flax_init_()

    @torch.no_grad()
    def flax_init_(self, generator: Optional[torch.Generator] = None):
        """flax's defaults: each input kernel lecun-normal (fan-in =
        in_dim), each hidden kernel orthogonal, biases 0."""
        lecun_normal_(self.weight_ih, generator)
        for block in self.weight_hh.chunk(4):
            nn.init.orthogonal_(block, generator=generator)
        self.bias_hh.zero_()

    def forward(self, carry, x):
        c, h = carry
        z = x @ self.weight_ih.T + h @ self.weight_hh.T + self.bias_hh
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h


class Set2Set(nn.Module):
    def __init__(self, hidden: int, n_iters: int = 2):
        super().__init__()
        self.hidden = hidden
        self.n_iters = n_iters
        self.lstm = LSTMCell(2 * hidden, hidden)

    def forward(self, x: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        d, g = self.hidden, num_segments
        q_star = x.new_zeros((g, 2 * d))
        carry = (x.new_zeros((g, d)), x.new_zeros((g, d)))
        for _ in range(self.n_iters):
            carry, q = self.lstm(carry, q_star)
            e = (x * segment_broadcast(q, segment_ids, g)).sum(-1)
            a = segment_softmax(e, segment_ids, g, mask=mask)
            r = segment_sum(x * a[:, None], segment_ids, g, mask=mask)
            q_star = torch.cat([q, r], -1)
        return q_star
