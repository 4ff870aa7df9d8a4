"""Plain PyTorch reference of S-CGIB: both encoders, the three pretraining
losses, the fine-tuning head and loss, and Adam.

Written from the model's equations (the S-CGIB reference's ``models.py`` as
the port documents it), over the real rows of a ``pack.Batch`` only, in the
precision a ``Numerics`` names: float64 for the comparison, or float32 with
the operands of every product rounded to TF32, the control.  Parameters are
a dict of tensors under the port's names (the flax tree's), so that one set
of seed-made weights serves both sides; ``parameter_shapes`` lists them.

The noise is an input.  ``rand(shape)`` returns the uniform draws the
program took at its padded shape for the same call, in the program's order:
each transformer layer's dropout mask (encoder 1's layers, then encoder
2's), then the gate's eps [N, 1] and its noise [N, d]; the reference takes
the rows of its real atoms and ego-net rows, which lead the padded ones.

Departures from the reference code, all of them the port's documented
choices: the KL is the mean over every atom (``corrected``); the per-graph
BatchNorm of the compressor normalizes each graph by its own statistics at
once; the reconstruction is ||IM IM^T - A||_F^2 / n in its gram form.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .pack import Batch

Params = Dict[str, torch.Tensor]
Rand = Callable[[tuple], torch.Tensor]

BN_EPS = 1e-5
LN_EPS = 1e-6
GATE_BIAS = 1e-4
STD_EPS = 1e-7
ATT_CLAMP = 5.0
ATT_EPS = 1e-6
DROPOUT = 0.5


@dataclasses.dataclass(frozen=True)
class Numerics:
    dtype: torch.dtype = torch.float64
    tf32: bool = False          # round every product's operands to TF32


FLOAT64 = Numerics()
TF32 = Numerics(torch.float32, True)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest, as float32."""
    bits = x.detach().float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b on TF32-rounded operands, its backward's products too."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = _tf32(a), _tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


class _TF32Mul(torch.autograd.Function):
    """a * b (broadcast) on TF32-rounded operands, its backward's too."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = _tf32(a), _tf32(b)
        ctx.save_for_backward(ra, rb)
        ctx.shapes = a.shape, b.shape
        return ra * rb

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        sa, sb = ctx.shapes
        return (_unbroadcast(g * b, sa), _unbroadcast(g * a, sb))


def _unbroadcast(g, shape):
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


def _ops(num: Numerics):
    """(matmul, multiply) of this precision: with TF32 each product's
    operands rounded to TF32 in the forward and the backward."""
    if num.tf32:
        return _TF32MatMul.apply, _TF32Mul.apply
    return (lambda a, b: a @ b), (lambda a, b: a * b)


# --- parameters -------------------------------------------------------------

def _mlp(name, din, hid, dout):
    return [(f"{name}.Dense_0.weight", (hid, din)),
            (f"{name}.Dense_0.bias", (hid,)),
            (f"{name}.Dense_1.weight", (dout, hid)),
            (f"{name}.Dense_1.bias", (dout,))]


def _encoder_shapes(prefix, cfg) -> List[Tuple[str, tuple]]:
    d, dt, L = cfg["hidden"], cfg["d_transfer"], cfg["num_layers"]
    out = []
    if cfg["encoder"] == "GIN":
        for i in range(L):
            out += _mlp(f"{prefix}.conv{i}", dt if i == 0 else d, d, d)
            out += [(f"{prefix}.bn{i}.scale", (d,)),
                    (f"{prefix}.bn{i}.bias", (d,))]
        return out
    if cfg["encoder"] != "Transformer":
        raise ValueError(f"no reference for encoder {cfg['encoder']!r}")
    out.append((f"{prefix}.embed.weight", (d, dt)))
    for i in range(L + 1):
        p = f"{prefix}.layer{i}"
        out += [(f"{p}.qkv.weight", (3 * d, d)), (f"{p}.qkv.bias", (3 * d,)),
                (f"{p}.O.weight", (d, d)), (f"{p}.O.bias", (d,)),
                (f"{p}.ln1.weight", (d,)), (f"{p}.ln1.bias", (d,)),
                (f"{p}.ffn1.weight", (2 * d, d)),
                (f"{p}.ffn1.bias", (2 * d,)),
                (f"{p}.ffn2.weight", (d, 2 * d)), (f"{p}.ffn2.bias", (d,)),
                (f"{p}.ln2.weight", (d,)), (f"{p}.ln2.bias", (d,))]
    return out


def parameter_shapes(cfg: dict, head: str) -> List[Tuple[str, tuple]]:
    """(name, shape) of every parameter, ``head`` "pretrain" or
    "finetune" (one output)."""
    d, dt, f = cfg["hidden"], cfg["d_transfer"], cfg["in_dim"]
    out = [("transfer_d.weight", (dt, f))]
    out += _encoder_shapes("core.encoder1", cfg)
    out += _encoder_shapes("core.encoder2", cfg)
    out += [("core.compressor.fc1.weight", (d, d)),
            ("core.compressor.fc1.bias", (d,)),
            ("core.compressor.bn.scale", (d,)),
            ("core.compressor.bn.bias", (d,)),
            ("core.compressor.fc2.weight", (1, d)),
            ("core.compressor.fc2.bias", (1,)),
            ("core.attn_layer.weight", (1, 2 * d)),
            ("core.attn_layer.bias", (1,))]
    out += _mlp("head_mlp", 2 * d, d, d)
    if head == "finetune":
        out += [("s2s.lstm.weight_ih", (4 * d, 2 * d)),
                ("s2s.lstm.weight_hh", (4 * d, d)),
                ("s2s.lstm.bias_hh", (4 * d,))]
        out += _mlp("predict", 2 * d, d, 1)
    return out


def trainable(cfg: dict, head: str, freeze: str = "none") -> List[str]:
    """The parameters an optimizer moves: all of them, or with ``freeze``
    "reference" (the S-CGIB fine-tuning script's freeze loop) every one
    outside the core and, inside it, only those of the encoders' conv 2
    and BatchNorm 2."""
    names = [n for n, _ in parameter_shapes(cfg, head)]
    if freeze == "none":
        return names
    if freeze != "reference":
        raise ValueError(f"unknown freeze {freeze!r}")

    def keep(name):
        parts = name.split(".")
        if parts[0] != "core":
            return True
        return (parts[1] in ("encoder1", "encoder2")
                and parts[2] in ("conv2", "bn2"))
    return [n for n in names if keep(n)]


# --- pieces -----------------------------------------------------------------

def _linear(p: Params, name: str, x, num: Numerics, bias: bool = True):
    mm, _ = _ops(num)
    y = mm(x, p[f"{name}.weight"].T)
    return y + p[f"{name}.bias"] if bias else y


def _mlp2(p, name, x, num):
    return _linear(p, f"{name}.Dense_1",
                   torch.relu(_linear(p, f"{name}.Dense_0", x, num)), num)


def _segsum(x, ids, n):
    return x.new_zeros((n,) + tuple(x.shape[1:])).index_add_(0, ids, x)


def _segsoftmax(a, ids, n):
    top = torch.full((n,), -math.inf, dtype=a.dtype, device=a.device)
    top = top.scatter_reduce(0, ids, a.detach(), "amax")
    e = torch.exp(a - top[ids])
    return e / _segsum(e, ids, n)[ids]


def _l2norm(x, eps=1e-12):
    return x / torch.sqrt((x * x).sum(-1, keepdim=True).clamp_min(eps * eps))


def _batch_norm(x, scale, bias, stats=None):
    """Over all rows with their own biased statistics, or with running
    ``stats`` (mean, var) in eval mode."""
    if stats is None:
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
    else:
        mean, var = stats
    return (x - mean) / torch.sqrt(var + BN_EPS) * scale + bias


def _layer_norm(x, w, b):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * w + b


def gin(p, prefix, cfg, h, senders, receivers, num, running=None):
    """Conv i: MLP(h + sum of in-neighbours) -> BatchNorm -> ReLU."""
    for i in range(cfg["num_layers"]):
        z = h + _segsum(h[senders], receivers, h.shape[0])
        z = _mlp2(p, f"{prefix}.conv{i}", z, num)
        stats = None if running is None else running(f"{prefix}.bn{i}")
        h = torch.relu(_batch_norm(z, p[f"{prefix}.bn{i}.scale"],
                                   p[f"{prefix}.bn{i}.bias"], stats))
    return h


def transformer(p, prefix, cfg, h, senders, receivers, rows_cap, num,
                rand: Optional[Rand]):
    """Embedding, then ``num_layers + 1`` layers of per-edge attention
    (weights exp(clamp(q.k / sqrt(hd), +-5)) over their in-sum plus 1e-6),
    output projection, residual and LayerNorm, FFN with dropout 0.5 where
    ``rand`` is given (training), residual and LayerNorm."""
    mm, mul = _ops(num)
    d, heads = cfg["hidden"], cfg["num_heads"]
    hd = d // heads
    n = h.shape[0]
    h = _linear(p, f"{prefix}.embed", h, num, bias=False)
    for i in range(cfg["num_layers"] + 1):
        pre = f"{prefix}.layer{i}"
        q, k, v = (t.reshape(n, heads, hd)
                   for t in _linear(p, f"{pre}.qkv", h, num).split(d, 1))
        score = mul(q[receivers], k[senders]).sum(-1) / math.sqrt(hd)
        e = torch.exp(score.clamp(-ATT_CLAMP, ATT_CLAMP))       # [E, H]
        w = e / (_segsum(e, receivers, n)[receivers] + ATT_EPS)
        att = _segsum(mul(w[:, :, None], v[senders]), receivers, n)
        h = _layer_norm(h + _linear(p, f"{pre}.O", att.reshape(n, d), num),
                        p[f"{pre}.ln1.weight"], p[f"{pre}.ln1.bias"])
        h2 = torch.relu(_linear(p, f"{pre}.ffn1", h, num))
        if rand is not None:
            keep = rand((rows_cap, 2 * d))[:n] < 1.0 - DROPOUT
            h2 = torch.where(keep, h2 / (1.0 - DROPOUT),
                             torch.zeros_like(h2))
        h = _layer_norm(h + _linear(p, f"{pre}.ffn2", h2, num),
                        p[f"{pre}.ln2.weight"], p[f"{pre}.ln2.bias"])
    return h


@dataclasses.dataclass
class Core:
    interaction: torch.Tensor     # [n, 2d]
    kl: torch.Tensor              # scalar: the mean KL over atoms
    noisy_readout: torch.Tensor   # [G, d]
    clean_readout: torch.Tensor   # [G, d]


def core(p, cfg, b: Batch, num: Numerics, rand: Rand, train: bool,
         running=None) -> Core:
    """Projection, twin encoders, the noise gate with its KL term, the
    ego-net candidates and the core-candidate attention."""
    dt = num.dtype
    x = _l2norm(b.x.to(dt))
    xp = _linear(p, "transfer_d", x, num, bias=False)
    xs = _linear(p, "transfer_d", x[b.sub_orig], num, bias=False)
    drop = rand if (train and cfg["encoder"] == "Transformer") else None
    if cfg["encoder"] == "GIN":
        h = gin(p, "core.encoder1", cfg, xp, b.senders, b.receivers, num,
                running)
        hs = gin(p, "core.encoder2", cfg, xs, b.sub_senders,
                 b.sub_receivers, num, running)
    else:
        h = transformer(p, "core.encoder1", cfg, xp, b.senders, b.receivers,
                        b.node_cap, num, drop)
        hs = transformer(p, "core.encoder2", cfg, xs, b.sub_senders,
                         b.sub_receivers, b.sub_cap, num, drop)
    n, G, gid = b.n, b.num_graphs, b.node_graph
    clean = _segsum(h, gid, G)

    # the gate: a per-graph BatchNorm inside its scorer
    z = _linear(p, "core.compressor.fc1", h, num)
    if running is None:
        cnt = _segsum(torch.ones_like(z[:, 0]), gid, G)[:, None]
        mean_g = _segsum(z, gid, G) / cnt
        var_g = _segsum((z - mean_g[gid]) ** 2, gid, G) / cnt
        zn = (z - mean_g[gid]) / torch.sqrt(var_g[gid] + BN_EPS)
        zn = zn * p["core.compressor.bn.scale"] + p["core.compressor.bn.bias"]
    else:
        zn = _batch_norm(z, p["core.compressor.bn.scale"],
                         p["core.compressor.bn.bias"],
                         running("core.compressor.bn"))
    score = _linear(p, "core.compressor.fc2", torch.relu(zn), num)
    u = rand((b.node_cap, 1))[:n].to(dt)
    eps = (u * (1.0 - 2 * GATE_BIAS) + GATE_BIAS).clamp_min(GATE_BIAS)
    lam = torch.sigmoid(torch.log(eps) - torch.log1p(-eps) + score)

    hd_ = h.detach()
    cnt = _segsum(torch.ones_like(hd_[:, 0]), gid, G)[:, None]
    mean_g = _segsum(hd_, gid, G) / cnt
    std_g = torch.sqrt(_segsum((hd_ - mean_g[gid]) ** 2, gid, G)
                       / (cnt - 1.0).clamp_min(1.0))
    mean_n, std_n = mean_g[gid], std_g[gid]
    noisy_mean = lam * h + (1.0 - lam) * mean_n
    noisy_std = (1.0 - lam) * std_n
    noisy = noisy_mean + rand((b.node_cap, h.shape[1]))[:n].to(dt) * noisy_std
    denom = std_n + STD_EPS
    dev = (noisy_mean - mean_n) / denom
    kl_node = 0.5 * noisy_std ** 2 / denom ** 2 + _segsum(dev * dev, gid,
                                                          G)[gid]
    kl = kl_node.sum() / kl_node.numel()

    cand = _segsum(hs, b.sub_center, n)
    noisy_readout = _segsum(noisy, gid, G)
    att = _linear(p, "core.attn_layer",
                  torch.cat([noisy_readout[gid], cand], -1), num)[:, 0]
    alpha = _segsoftmax(att, gid, G)
    inter = torch.cat([noisy, cand * alpha[:, None]], -1)
    return Core(inter, kl, noisy_readout, clean)


def pretrain_losses(p, cfg, b: Batch, num: Numerics, rand: Rand
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(KL, InfoNCE, adjacency reconstruction) of one training batch."""
    mm, _ = _ops(num)
    c = core(p, cfg, b, num, rand, train=True)
    im = _mlp2(p, "head_mlp", c.interaction, num)
    z1, z2 = _l2norm(c.noisy_readout), _l2norm(c.clean_readout)
    refl, betw = torch.exp(mm(z1, z1.T)), torch.exp(mm(z1, z2.T))
    denom = refl.sum(1) + betw.sum(1) - torch.diagonal(refl)
    contrastive = (-torch.log(torch.diagonal(betw) / denom)).mean()
    gram = mm(im.T, im)
    cross = (im[b.senders] * im[b.receivers]).sum()
    recon = ((gram * gram).sum() - 2.0 * cross + b.senders.numel()) / b.n
    return c.kl, contrastive, recon


def _set2set(p, x, gid, G, num, iters=2):
    d = x.shape[1]
    q_star = x.new_zeros((G, 2 * d))
    c = x.new_zeros((G, d))
    h = x.new_zeros((G, d))
    mm, _ = _ops(num)
    for _ in range(iters):
        z = (mm(q_star, p["s2s.lstm.weight_ih"].T)
             + mm(h, p["s2s.lstm.weight_hh"].T) + p["s2s.lstm.bias_hh"])
        i, f, g, o = z.chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        a = _segsoftmax((x * h[gid]).sum(-1), gid, G)
        q_star = torch.cat([h, _segsum(x * a[:, None], gid, G)], -1)
    return q_star


def finetune_scores(p, cfg, b: Batch, num: Numerics, rand: Rand,
                    train: bool, running=None) -> torch.Tensor:
    """Probabilities [G]: the core, the head MLP, Set2Set and the
    prediction MLP, then a sigmoid.  ``running(name) -> (mean, var)`` gives
    the BatchNorms' running statistics in eval mode."""
    c = core(p, cfg, b, num, rand, train=train, running=running)
    im = _mlp2(p, "head_mlp", c.interaction, num)
    pooled = _set2set(p, im, b.node_graph, b.num_graphs, num)
    return torch.sigmoid(_mlp2(p, "predict", pooled, num))[:, 0]


def bce(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy with each log floored at -100."""
    lp = torch.log(probs).clamp_min(-100.0)
    lq = torch.log1p(-probs).clamp_min(-100.0)
    return -(labels * lp + (1.0 - labels) * lq).mean()


class Adam:
    """Adam with L2 added to the gradient before the moments (torch's
    ``weight_decay``), over the named parameters it is given."""

    def __init__(self, names, lr, weight_decay, betas=(0.9, 0.999),
                 eps=1e-8):
        self.names = list(names)
        self.lr, self.wd, self.eps = lr, weight_decay, eps
        self.b1, self.b2 = betas
        self.m: Params = {}
        self.v: Params = {}
        self.t = 0

    def step(self, params: Params, grads: Params) -> Params:
        """Moves ``params`` in place; returns the gradients it took (with
        the L2 term)."""
        self.t += 1
        taken = {}
        with torch.no_grad():
            for n in self.names:
                g = grads[n] + self.wd * params[n]
                taken[n] = g
                m = self.m.get(n, torch.zeros_like(g))
                v = self.v.get(n, torch.zeros_like(g))
                m = self.b1 * m + (1 - self.b1) * g
                v = self.b2 * v + (1 - self.b2) * g * g
                self.m[n], self.v[n] = m, v
                mh = m / (1 - self.b1 ** self.t)
                vh = v / (1 - self.b2 ** self.t)
                params[n] -= self.lr * mh / (torch.sqrt(vh) + self.eps)
        return taken
