"""PyTorch port vs the JAX package: the bf16 compute modes.

GIN's ``compute_dtype="bfloat16"`` (the fused conv on bf16 h, W1 and W2),
the attention's ``bf16_dots`` (every product of the flash kernels on bf16
operands) and the transformer layer's bf16 dense tail (``dtype``), each
against the JAX package on the same numpy inputs, at a small size (256
rows, width 16, two convs or layers).  The JAX kernels run in Pallas TPU
interpret mode; their backward on a CPU is ``_bwd``'s XLA branch (the GIN
conv) or the merged Pallas backward (the attention).  The card tests
(``test_torch_cuda.py``) hold the CUDA kernels against the same plain
versions.

Tolerances: rtol = atol = 1e-2 for the forward outputs,
2e-2 of the largest entry for the GIN conv's gradients and the layer's bf16
output (JAX rounds each Dense product and its bias add to bf16 separately,
torch's bf16 ``linear`` once), 1e-1 for the attention's gradients against
JAX's merged backward (the JAX package's own 10x rule for bf16 dots,
tests/test_graph_transformer.py) when the port's backward is two-pass.
Where both sides round at the same points (the plain versions against the
Pallas kernels, and ``gt_flash_attention(bwd="merged", bf16_dots=True)``,
the JAX package's own configuration on a TPU, against JAX's) they also
agree to 1e-5 relative: only the order of float32 sums differs, while
float32 and bf16 products differ by 1e-2.  Each rounding point of the
bf16 backward has a control, the plain backward with that rounding alone
left out (``gt_rounding.py``), which the Pallas kernels must lie past.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scgib_tpu.data.synthetic import random_dataset as jrandom_dataset
from scgib_tpu.graph.batching import pack_graphs as jpack_graphs
from scgib_tpu.graph.batching import pack_subgraphs as jpack_subgraphs
from scgib_tpu.graph.egonet import extract_egonets as jextract_egonets
from scgib_tpu.models.encoders import \
    GraphTransformerLayer as JGraphTransformerLayer
from scgib_tpu.models.scgib import PretrainModel as JPretrainModel
from scgib_tpu.ops.pallas import banded as jkb
from scgib_tpu.ops.pallas import gt_flash as jgt

from scgib_tpu_torch import cli
from scgib_tpu_torch.config import DATASETS
from scgib_tpu_torch.data.loader import (GraphDataset, batch_iterator,
                                          plan_capacities)
from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph import banded
from scgib_tpu_torch.graph.batching import pack_graphs
from scgib_tpu_torch.graph.container import GraphBatch, SubgraphBatch
from scgib_tpu_torch.models.encoders import (GIN, GraphTransformer,
                                             GraphTransformerLayer)
from scgib_tpu_torch.models.scgib import (DomainAdaptModel, FinetuneModel,
                                          PretrainModel, _resolve_band)
from scgib_tpu_torch.ops.kernels import banded as kb
from scgib_tpu_torch.ops.kernels import gt_flash as kg
from scgib_tpu_torch.train import loops
from scgib_tpu_torch.train.trainer import (TrainState,
                                           finetune_trainable_mask,
                                           make_eval_fn, make_finetune_step,
                                           masked_adam)
from scgib_tpu_torch.utils import counters
from scgib_tpu_torch.utils.params import from_jax_variables, init_flax_style_

import gt_rounding
from gt_cases import case_inputs

BF = torch.bfloat16
N, WIDTH = 256, 16
SAME_POINTS = 1e-5        # both sides round at the same points


def t(x):
    return torch.from_numpy(np.array(x))


def rel(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32).reshape(got.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def jblocks(blocks):
    return jnp.asarray(blocks.float().numpy()).astype(jnp.bfloat16)


def bf16_exact(x):
    """Whether every entry of a float32 tensor is a bf16 value."""
    return torch.equal(x, x.to(BF).float())


# --- the fused GIN conv ------------------------------------------------------

def gin_inputs(din, seed=0):
    """A symmetric band of |u - v| <= 20 over N rows (tiles of 128, band
    256) and the conv's operands, float32 numpy: h [N, din], W1 [din, 16],
    b1, W2 [16, 16], b2."""
    rng = np.random.default_rng(seed)
    v = np.repeat(np.arange(N), 3)
    u = np.clip(v + rng.integers(-20, 21, v.size), 0, N - 1)
    send, recv = np.concatenate([u, v]), np.concatenate([v, u])
    b = banded.pack_banded(send.astype(np.int32), recv.astype(np.int32), None,
                           N, tile=128, band=256, align=64)
    arrays = [rng.normal(size=(N, din)), rng.normal(size=(din, WIDTH))
              / np.sqrt(din), rng.normal(size=WIDTH) * 0.1,
              rng.normal(size=(WIDTH, WIDTH)) / 4.0,
              rng.normal(size=WIDTH) * 0.1]
    return (torch.from_numpy(b.blocks).to(BF),
            torch.from_numpy(b.col_off.astype(np.int64)),
            [x.astype(np.float32) for x in arrays])


def jax_gin_args(blocks, off, arrays):
    """JAX's GIN caller's arguments in bf16 mode: blocks, h, W1 and W2
    cast to bf16, the biases float32."""
    h, w1, b1, w2, b2 = (jnp.asarray(x) for x in arrays)
    bf = jnp.bfloat16
    return (jblocks(blocks), jnp.asarray(off.numpy().astype(np.int32)),
            h.astype(bf), w1.astype(bf), b1, w2.astype(bf), b2)


@pytest.mark.parametrize("din", [9, 16])
def test_gin_bf16_forward_matches_pallas_kernel(din):
    """9 features: conv 0's width, zero-padded to the products' depth."""
    blocks, off, arrays = gin_inputs(din)
    h, w1, b1, w2, b2 = map(t, arrays)
    counters.reset("launch")
    got = kb.gin_banded_layer(blocks, off, h.to(BF), w1.to(BF), b1,
                              w2.to(BF), b2)
    assert got.dtype == torch.float32
    assert counters.of("launch", kb.KERNELS) == dict.fromkeys(kb.KERNELS, 0)
    with pltpu.force_tpu_interpret_mode():
        want = jkb.gin_banded_layer(*jax_gin_args(blocks, off, arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-2,
                               atol=1e-2)
    assert rel(got, want) <= SAME_POINTS
    # the mode matters: float32 products land 1e-2 away
    f32 = kb.gin_fwd_plain(blocks, off, h, w1, b1, w2, b2)
    assert rel(f32, want) > 100 * SAME_POINTS


@pytest.mark.parametrize("din", [9, 16])
def test_gin_bf16_gradients_match_jax(din):
    """dh, dW1 and dW2 through ``_bwd`` (float32 on the rounded operands,
    then rounded to bf16), db1 and db2 float32, from float32 leaves cast to
    bf16 on both sides."""
    blocks, off, arrays = gin_inputs(din, seed=1)
    ct = np.random.default_rng(2).normal(size=(N, WIDTH)).astype(np.float32)
    jargs = jax_gin_args(blocks, off, arrays)

    def jloss(h, w1, b1, w2, b2):
        bf = jnp.bfloat16
        return jnp.sum(jkb.gin_banded_layer(
            jargs[0], jargs[1], h.astype(bf), w1.astype(bf), b1,
            w2.astype(bf), b2) * ct)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss, argnums=tuple(range(5)))(
            *(jnp.asarray(x) for x in arrays))
    leaves = [t(x).requires_grad_() for x in arrays]
    h, w1, b1, w2, b2 = leaves
    out = kb.gin_banded_layer(blocks, off, h.to(BF), w1.to(BF), b1,
                              w2.to(BF), b2)
    (out * t(ct)).sum().backward()
    for leaf, w, name in zip(leaves, want, ("h", "W1", "b1", "W2", "b2")):
        assert leaf.grad.dtype == torch.float32
        assert rel(leaf.grad, w) <= 2e-2, name
    for leaf in (h, w1, w2):                 # rounded to bf16 on the way out
        assert bf16_exact(leaf.grad)
    assert not bf16_exact(b1.grad) and not bf16_exact(b2.grad)


# --- the attention kernels with bf16 dots ------------------------------------

ATTN_CASES = ("narrow", "wide-16x4", "narrow-edges")


@pytest.fixture(scope="module", params=ATTN_CASES)
def pallas_bf16(request):
    """One case of gt_cases: the Pallas forward, two-pass backward and
    merged backward in interpret mode with bf16 dots."""
    blocks, off, (q, k, v, g) = case_inputs(request.param)
    n, heads, hd = q.shape
    flat = [jnp.asarray(x.reshape(n, heads * hd)) for x in (q, k, v, g)]
    jb, jo = jblocks(blocks), jnp.asarray(off.numpy().astype(np.int32))
    with pltpu.force_tpu_interpret_mode():
        out, z = jgt._run_fwd(jb, jo, *flat[:3], heads, hd, 5.0, 1e-6, True)
        dq, dk, dv = jgt._run_bwd_twopass(jb, jo, *flat, z, heads, hd, 5.0,
                                          1e-6, True)
        merged = jgt._run_bwd_merged(jb, jo, *flat, z, heads, hd, 5.0, 1e-6,
                                     True)
    return (blocks, off, [t(x) for x in (q, k, v, g)],
            {"fwd": (out, z), "rows": (dq,), "cols": (dk, dv),
             "merged": merged})


@pytest.mark.parametrize("kernel", ["fwd", "rows", "cols"])
def test_bf16_plain_versions_match_pallas_kernels(pallas_bf16, kernel):
    blocks, off, (q, k, v, g), want = pallas_bf16
    counters.reset("launch", "route")
    z = t(want["fwd"][1])
    if kernel == "fwd":
        got = kg.gt_fwd(blocks, off, q, k, v, bf16_dots=True)
        f32 = kg.gt_fwd(blocks, off, q, k, v)[0]
    elif kernel == "rows":
        got = kg.gt_bwd_rows(blocks, off, q, k, v, g, z, bf16_dots=True)[:1]
        f32 = kg.gt_bwd_rows(blocks, off, q, k, v, g, z)[0]
    else:
        rho = kg.gt_bwd_rows(blocks, off, q, k, v, g, z, bf16_dots=True)[1]
        got = kg.gt_bwd_cols(blocks, off, q, k, v, g, z, rho, bf16_dots=True)
        f32 = kg.gt_bwd_cols(blocks, off, q, k, v, g, z, rho)[0]
    assert counters.of("launch", kg.KERNELS) == dict.fromkeys(kg.KERNELS, 0)
    for a, b in zip(got, want[kernel]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape),
                                   rtol=1e-2, atol=1e-2)
        assert rel(a, b) <= SAME_POINTS
    assert rel(f32, want[kernel][0]) > 10 * SAME_POINTS


def test_flash_attention_bf16_matches_jax():
    """``gt_flash_attention(bf16_dots=True)``: output and dq, dk, dv
    against JAX's (its merged backward, the port's two-pass one)."""
    blocks, off, (q, k, v, g) = case_inputs("narrow")
    jb, jo = jblocks(blocks), jnp.asarray(off.numpy().astype(np.int32))

    def jloss(q, k, v):
        out = jgt.gt_flash_attention(jb, jo, q, k, v, 5.0, 1e-6, True)
        return jnp.sum(out * g), out

    with pltpu.force_tpu_interpret_mode():
        (_, jout), jgrads = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(
                *(jnp.asarray(x) for x in (q, k, v)))
    ts = [t(x).requires_grad_() for x in (q, k, v)]
    out = kg.gt_flash_attention(blocks, off, *ts, bf16_dots=True)
    (out * t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-2, atol=1e-2)
    for x, jg_, name in zip(ts, jgrads, "qkv"):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg_),
                                   rtol=1e-1, atol=1e-1, err_msg=f"d{name}")


def test_merged_bf16_plain_version_matches_pallas_kernel(pallas_bf16):
    """``gt_bwd_merged(bf16_dots=True)`` on the CPU (its plain version)
    against ``_bwd_merged_kernel`` with ``bf16=True``, the JAX package's
    backward on a TPU, from the Pallas forward's z: the same rounding
    points, so within SAME_POINTS; the float32 plain version lands past ten
    times that."""
    blocks, off, (q, k, v, g), want = pallas_bf16
    z = t(want["fwd"][1])
    counters.reset("launch", "route")
    got = kg.gt_bwd_merged(blocks, off, q, k, v, g, z, bf16_dots=True)
    f32 = kg.gt_bwd_merged(blocks, off, q, k, v, g, z)
    assert counters.of("launch", kg.KERNELS) == dict.fromkeys(kg.KERNELS, 0)
    for a, b in zip(got, want["merged"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape),
                                   rtol=1e-2, atol=1e-2)
        assert rel(a, b) <= SAME_POINTS
    assert max(rel(a, b) for a, b in zip(f32, want["merged"])) > \
        10 * SAME_POINTS


@pytest.mark.parametrize("kernel", ["rows", "cols", "merged", "fwd"])
def test_each_rounding_point_has_a_control(pallas_bf16, kernel):
    """Each rounding point of the bf16-dot kernels left out alone
    (``gt_rounding.py``: q, k, v, g, dS before dq, dS before dk, W before
    dv, those the backward kernel has; the forward's q, k, v and w before
    out): here every control lies at least twice SAME_POINTS from the sound
    plain version, and the Pallas kernel past SAME_POINTS from each, so the
    gate that holds the plain versions to the kernels would catch a single
    rounding skipped.  The forward's plain version (``gt_fwd_plain``, the
    control with no rounding left out) lies within SAME_POINTS of
    ``_fwd_kernel``."""
    blocks, off, (q, k, v, g), want = pallas_bf16
    if kernel == "fwd":
        got = [t(want["fwd"][0]).reshape(q.shape),
               t(want["fwd"][1]).reshape(q.shape[:2])]
        inputs = (blocks, off, q, k, v)
        plain = kg.gt_fwd_plain(blocks, off, q, k, v, bf16_dots=True)
        assert gt_rounding.rel_gap(plain, got) <= SAME_POINTS
        sound = gt_rounding.forward_without(None, *inputs)
        assert all(torch.equal(a, sound[x])
                   for a, x in zip(plain, ("out", "z")))
    else:
        got = [t(x).reshape(q.shape) for x in want[kernel]]
        inputs = (blocks, off, q, k, v, g, t(want["fwd"][1]))
    records = gt_rounding.controls(kernel, got, inputs, SAME_POINTS)
    assert set(records) == set(gt_rounding.KERNELS[kernel][1])
    assert all(sep for _, _, sep in records.values()), records
    assert not gt_rounding.unseen(records, SAME_POINTS), records


# the points random inputs do not separate at the card's 1e-3 gate, by the
# kernels whose controls ``separating_inputs`` sets apart for them
CRAFTED = {"fwd": ("v", "w before out"),
           "merged": ("dS before dk", "w before dv"),
           "cols": ("dS before dk", "w before dv")}


CARD_GATE = 1e-3          # chip_smoke.py's BF16_RTOL


@pytest.mark.parametrize("kernel", ["fwd", "merged"])
def test_tie_slack_admits_no_skipped_rounding(pallas_bf16, kernel):
    """``gt_rounding.tie_slack`` (the bf16 step of each term whose rounded
    factor lies within TIE of a rounding midpoint, which chip_smoke.py's
    phase 14 (a) admits past its gate): the plain version is 0 past its
    own ties, the Pallas kernel (the same rounding points, another
    summation order) no further past them than from the plain version,
    and every single-rounding control at least twice the card's gate
    from the plain version still past the gate beyond the ties, so the
    allowance hides none that the gate separates."""
    blocks, off, (q, k, v, g), want = pallas_bf16
    z = t(want["fwd"][1])
    if kernel == "fwd":
        inputs = (blocks, off, q, k, v)
        plain = kg.gt_fwd_plain(*inputs, bf16_dots=True)
        pallas = [t(want["fwd"][0]).reshape(q.shape), z.reshape(q.shape[:2])]
        controls = {p: gt_rounding.forward_without(p, *inputs)
                    for p in gt_rounding.FWD_POINTS}
        names = ("out", "z")
    else:
        inputs = (blocks, off, q, k, v, g, z)
        plain = kg.gt_bwd_merged_plain(*inputs, bf16_dots=True)
        pallas = [t(x).reshape(q.shape) for x in want["merged"]]
        controls = {p: gt_rounding.backward_without(p, *inputs)
                    for p in gt_rounding.POINTS}
        names = ("dq", "dk", "dv")
    slack = gt_rounding.tie_slack(kernel, inputs)
    assert gt_rounding.beyond_ties(plain, plain, slack)[0] == 0.0
    assert gt_rounding.beyond_ties(pallas, plain, slack)[0] <= \
        gt_rounding.rel_gap(pallas, plain)
    for point, ctl in controls.items():
        got = [ctl[x] for x in names]
        if gt_rounding.rel_gap(got, plain) >= 2 * CARD_GATE:
            past = gt_rounding.beyond_ties(got, plain, slack)[0]
            assert past > CARD_GATE, point


@pytest.mark.parametrize("shape", [(8, 8), (1, 64)], ids=["8x8", "1x64"])
@pytest.mark.parametrize("kernel", sorted(CRAFTED))
def test_separating_inputs_set_the_controls_apart(kernel, shape):
    """``gt_rounding.separating_inputs`` at the card's shapes: the controls
    of the points that random inputs leave within twice the card's gate lie
    past it (the plain versions on the CPU stand for a kernel that rounds
    where they do: they lie past the gate from each such control too)."""
    heads, hd = shape
    inputs = gt_rounding.separating_inputs(kernel, heads, hd)
    if kernel == "fwd":
        got = kg.gt_fwd(*inputs, bf16_dots=True)
        records = gt_rounding.controls(kernel, got, inputs, CARD_GATE)
    else:
        z = kg.gt_fwd(*inputs[:5], bf16_dots=True)[1]
        inputs = inputs + (z,)
        rho = None
        if kernel == "merged":
            got = kg.gt_bwd_merged(*inputs, bf16_dots=True)
        else:
            rho = kg.gt_bwd_rows(*inputs, bf16_dots=True)[1]
            got = kg.gt_bwd_cols(*inputs, rho, bf16_dots=True)
        records = gt_rounding.controls(kernel, got, inputs, CARD_GATE,
                                       rho=rho)
    for point in CRAFTED[kernel]:
        apart, kernel_apart, separated = records[point]
        assert separated and kernel_apart == apart > 10 * CARD_GATE, \
            (point, records)
    assert not gt_rounding.unseen(records, CARD_GATE)


def test_flash_attention_merged_bf16_matches_jax(monkeypatch):
    """``gt_flash_attention(bwd="merged", bf16_dots=True)``, the JAX
    package's own configuration on a TPU, against JAX's
    ``gt_flash_attention(..., True)`` with its default (merged) backward:
    the same rounding points on both sides, so the output and dq, dk, dv
    agree within SAME_POINTS (the two-pass comparison above needs 1e-1)."""
    monkeypatch.delenv("SCGIB_GT_BWD_TWOPASS", raising=False)
    blocks, off, (q, k, v, g) = case_inputs("narrow")
    jb, jo = jblocks(blocks), jnp.asarray(off.numpy().astype(np.int32))

    def jloss(q, k, v):
        out = jgt.gt_flash_attention(jb, jo, q, k, v, 5.0, 1e-6, True)
        return jnp.sum(out * g), out

    with pltpu.force_tpu_interpret_mode():
        (_, jout), jgrads = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(
                *(jnp.asarray(x) for x in (q, k, v)))
    ts = [t(x).requires_grad_() for x in (q, k, v)]
    out = kg.gt_flash_attention(blocks, off, *ts, bwd="merged",
                                bf16_dots=True)
    (out * t(g)).sum().backward()
    assert rel(out, jout) <= SAME_POINTS
    for x, jg_, name in zip(ts, jgrads, "qkv"):
        assert rel(x.grad, jg_) <= SAME_POINTS, f"d{name}"


def test_tpu_default_transformer_matches_its_twopass_twin():
    """A small Transformer ``PretrainModel`` in the JAX package's TPU
    configuration (``gt_bwd="merged"``, ``gt_bf16_dots=True``) against its
    two-pass bf16 twin of the same weights: on the CPU both backwards are
    the same plain passes, so losses and gradients agree to float32
    summation order; the float32-dot model is 1e-3 and more away (the
    control)."""
    GraphTransformerLayer(16, 2, bwd="merged", bf16_dots=True)
    ds = GraphDataset(random_dataset(12, seed=5, min_nodes=8, max_nodes=20),
                      k=1)
    g, sub = (b.to("cpu") for b in next(batch_iterator(
        ds, 12, plan_capacities(ds, 12), shuffle=False)))
    results = []
    for kw in (dict(gt_bwd="merged", gt_bf16_dots=True),
               dict(gt_bf16_dots=True), dict(gt_bwd="merged")):
        model = PretrainModel(9, hidden=WIDTH, d_transfer=8,
                              encoder="Transformer", num_layers=1,
                              num_heads=2, deterministic=True, **kw)
        init_flax_style_(model, torch.Generator().manual_seed(6))
        for m in model.modules():
            if isinstance(m, GraphTransformerLayer):
                m.dropout = 0.0
                assert (m.bwd, m.bf16_dots) == (kw.get("gt_bwd", "twopass"),
                                                kw.get("gt_bf16_dots", False))
        losses = model.train()(g, sub)
        losses.total.backward()
        results.append(([float(x) for x in losses],
                        [p.grad.clone() for p in model.parameters()]))
    (tpu, tpu_grads), (twin, twin_grads), (f32, f32_grads) = results

    def apart(grads):
        """The largest gradient difference from the twin's, relative to
        each tensor's largest entry (at least 1e-3 of the largest)."""
        floor = 1e-3 * max(float(x.abs().max()) for x in twin_grads)
        return max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    floor)
                   for a, b in zip(grads, twin_grads))
    np.testing.assert_allclose(tpu, twin, rtol=1e-6)
    assert apart(tpu_grads) <= 1e-6
    assert apart(f32_grads) > 1e-3
    assert max(abs(a - b) / abs(b) for a, b in zip(f32, twin)) > 1e-6


# --- the transformer layer's bf16 dense tail ---------------------------------

def layer_inputs():
    """A packed batch of N graph rows (its narrow band for the port, the
    wide one for JAX's CPU path) and features [N, 16]."""
    graphs = random_dataset(10, seed=11, min_nodes=8, max_nodes=28)
    b = pack_graphs(graphs, N, 1024, 16).to("cpu")
    x = np.random.default_rng(0).normal(size=(N, WIDTH)).astype(np.float32)
    x[~b.node_mask.numpy()] = 0.0
    wide = _resolve_band(b)
    jband = (jblocks(wide[0]), jnp.asarray(wide[1].numpy()))
    return b, x, _resolve_band(b, gt=True), jband


@pytest.mark.parametrize("bf16_dots", [True, False], ids=["dots", "f32dots"])
def test_layer_bf16_matches_jax(bf16_dots):
    """``GraphTransformerLayer(dtype=bf16)`` against JAX's
    ``GraphTransformerLayer(dtype=jnp.bfloat16)`` on the banded XLA path
    (the JAX layer's CPU path), both in eval mode: bf16 output, rows of
    unit scale after the LayerNorm."""
    b, x, band, jband = layer_inputs()
    js, jr = (jnp.asarray(y.numpy()) for y in (b.senders, b.receivers))
    jlayer = JGraphTransformerLayer(WIDTH, 2, dtype=jnp.bfloat16)
    variables = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x), js, jr,
                            band=jband, train=False)
    want = jlayer.apply(variables, jnp.asarray(x), js, jr, band=jband,
                        train=False)
    assert want.dtype == jnp.bfloat16
    layer = GraphTransformerLayer(WIDTH, 2, bf16_dots=bf16_dots,
                                  dtype=BF).eval()
    layer.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)))
    assert all(p.dtype == torch.float32 for p in layer.parameters())
    got = layer(t(x), b.senders, b.receivers, edge_mask=b.edge_mask,
                band=band)
    assert got.dtype == BF
    rows = b.node_mask.numpy()
    np.testing.assert_allclose(
        got.detach().float().numpy()[rows],
        np.asarray(want, np.float32)[rows], rtol=2e-2, atol=2e-2)


def test_encoder_bf16_tail_casts_back_once():
    """The embedding and every layer in bf16, one cast to float32 after the
    last layer, padding rows zero; the gradients of the float32
    parameters are float32."""
    b, x, band, _ = layer_inputs()
    enc = GraphTransformer(WIDTH, hidden=WIDTH, num_layers=1, num_heads=2,
                           bf16_dots=True, dtype=BF)
    init_flax_style_(enc, torch.Generator().manual_seed(0))
    outs = {}

    enc.layer0.register_forward_pre_hook(
        lambda mod, args: outs.__setitem__("embedded", args[0].dtype))
    enc.layer1.register_forward_hook(
        lambda mod, args, out: outs.__setitem__("layer1", out.dtype))
    got = enc.eval()(t(x), b.senders, b.receivers, node_mask=b.node_mask,
                     edge_mask=b.edge_mask, band=band)
    assert outs == {"embedded": BF, "layer1": BF}
    assert got.dtype == torch.float32
    assert float(got.detach()[~b.node_mask].abs().max()) == 0.0
    got.sum().backward()
    assert all(p.grad.dtype == torch.float32 for p in enc.parameters())


# --- the float32 default -----------------------------------------------------

def test_float32_default_is_the_unchanged_gin():
    """GIN with no compute_dtype runs the float32 composition it always
    ran: bit for bit, output and gradients."""
    blocks, off, arrays = gin_inputs(16, seed=3)
    h = t(arrays[0])
    gin = GIN(16, hidden=WIDTH, num_convs=2)
    init_flax_style_(gin, torch.Generator().manual_seed(1))

    def old(x):
        for i in range(2):
            mlp = getattr(gin, f"conv{i}")
            x = kb.gin_banded_layer(blocks, off, x, mlp.Dense_0.weight.t(),
                                    mlp.Dense_0.bias, mlp.Dense_1.weight.t(),
                                    mlp.Dense_1.bias)
            x = torch.relu(getattr(gin, f"bn{i}")(x))
        return x

    results = []
    for fn in (lambda x: gin(x, None, None, band=(blocks, off)), old):
        gin.zero_grad()
        out = fn(h)
        out.sum().backward()
        results.append([out.detach()] + [p.grad.clone()
                                         for p in gin.parameters()])
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_float32_default_is_the_unchanged_layer():
    """The transformer layer with no dtype and no bf16_dots: the float32
    composition it always ran, bit for bit."""
    b, x, band, _ = layer_inputs()
    layer = GraphTransformerLayer(WIDTH, 2).eval()
    init_flax_style_(layer, torch.Generator().manual_seed(2))
    h = t(x)
    q, k, v = (p.reshape(N, 2, 8) for p in layer.qkv(h).split(WIDTH, 1))
    attn = kg.gt_flash_attention(band[0], band[1], q, k, v)
    h1 = layer.ln1(h + layer.O(attn.reshape(N, WIDTH)))
    want = layer.ln2(h1 + layer.ffn2(torch.relu(layer.ffn1(h1))))
    got = layer(h, b.senders, b.receivers, edge_mask=b.edge_mask, band=band)
    assert torch.equal(got, want)
    # and the kernels' plain versions: bf16_dots=False is the float32 path
    blocks, off, (q, k, v, g) = case_inputs("narrow")
    q, k, v = map(t, (q, k, v))
    out, z = kg.gt_fwd_plain(blocks, off, q, k, v)
    _, e = kg.gt_scores(blocks, off, q, k, 5.0)
    w = e / (e.sum(-1) + 1e-6)[..., None]
    assert torch.equal(out, torch.einsum(
        "thij,tjhd->tihd", w, kg.gt_windows(off, 128, v)).reshape(q.shape))


# --- the models, the parameters, the entry points ----------------------------

MODES = {"GIN": dict(compute_dtype="bfloat16"),
         "Transformer": dict(gt_bf16_dots=True, gt_dtype=BF)}


def test_jax_parameters_load_into_a_bf16_model():
    """The parameter layout does not change: a JAX PretrainModel's tree
    loads as it is into the port's model in every bf16 mode, whose
    parameters stay float32, and its losses stay near the float32
    model's."""
    graphs = jrandom_dataset(8, seed=3, min_nodes=8, max_nodes=20)
    egos = [jextract_egonets(x, 1) for x in graphs]
    jg = jpack_graphs(graphs, N, 1024, 8, banded="device")
    jsub = jpack_subgraphs(graphs, egos, 1024, 4096, banded="device")
    g = GraphBatch.from_numpy(jg, "cpu")
    sub = SubgraphBatch.from_numpy(jsub, "cpu")
    for encoder, mode in MODES.items():
        jmodel = JPretrainModel(in_dim=9, hidden=WIDTH, d_transfer=8,
                                encoder=encoder, num_layers=2, num_heads=2,
                                deterministic=True)
        v = jax.tree_util.tree_map(np.asarray, jmodel.init(
            {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
             "dropout": jax.random.PRNGKey(2)}, jg, jsub, train=False))
        losses = []
        for kw in ({}, mode):
            model = PretrainModel(9, hidden=WIDTH, d_transfer=8,
                                  encoder=encoder, num_layers=2, num_heads=2,
                                  deterministic=True, **kw)
            model.load_state_dict(from_jax_variables(v))    # strict
            assert all(p.dtype == torch.float32
                       for p in model.parameters())
            with torch.no_grad():
                losses.append([float(x) for x in model.eval()(g, sub)])
        for a, b in zip(*losses):
            assert np.isfinite(b) and abs(a - b) <= 0.05 * abs(a) + 1e-3


def test_numerics_reach_every_model():
    def modes(model):
        enc = model.core.encoder1, model.core.encoder2
        return [(e.compute_dtype if isinstance(e, GIN) else
                 (e.layer0.bf16_dots, e.dtype)) for e in enc]
    for cls in (PretrainModel, FinetuneModel, DomainAdaptModel):
        for encoder, mode in MODES.items():
            model = cls(9, hidden=WIDTH, d_transfer=8, encoder=encoder,
                        num_layers=2, num_heads=2, **mode)
            want = ("bfloat16" if encoder == "GIN" else (True, BF))
            assert modes(model) == [want, want], (cls, encoder)
    dense = PretrainModel(9, hidden=WIDTH, d_transfer=8, num_layers=2,
                          subgraph_mode="dense", compute_dtype="bfloat16")
    assert dense.core.encoder2.compute_dtype == "bfloat16"
    # float32 has one spelling, None
    for bad in ("float32", "float16"):
        with pytest.raises(ValueError, match="compute_dtype"):
            GIN(9, compute_dtype=bad)
    for bad in (torch.float32, "bfloat16", torch.float16):
        with pytest.raises(ValueError, match="bfloat16"):
            GraphTransformer(9, dtype=bad)


@pytest.mark.parametrize("encoder", sorted(MODES))
def test_run_pretrain_in_bf16_mode_on_cpu(encoder):
    """``cli.run_pretrain`` threads each mode to the model: two steps,
    finite losses, every conv or attention on its band branch, and no
    launch on the CPU."""
    counters.reset("launch", "route", "encoder")
    records = cli.run_pretrain(synthetic=48, batch_size=16, steps=2,
                               device="cpu", encoder=encoder, num_layers=2,
                               num_heads=2, hidden=WIDTH, d_transfer=8,
                               log=lambda _: None, **MODES[encoder])
    for rec in records:
        assert all(np.isfinite(rec[k]) for k in
                   ("kl", "contrastive", "reconstruction"))
    band = "band" if encoder == "GIN" else "gt_band_64x128"
    per_step = 4 if encoder == "GIN" else 6
    assert counters.of("encoder") == {band: per_step * 2}
    assert not any(counters.of("launch", kb.KERNELS + kg.KERNELS).values())


@pytest.mark.parametrize("encoder", sorted(MODES))
def test_run_finetune_in_bf16_mode_on_cpu(encoder):
    """The fine-tuning loop on a bf16-mode ``FinetuneModel``: two epochs of
    captured-step code on the CPU, finite losses and metrics, every conv or
    attention on its band branch."""
    spec = DATASETS["BACE"]
    ds = GraphDataset(random_dataset(48, seed=1, num_tasks=spec.num_tasks),
                      k=1)
    caps = plan_capacities(ds, 8)
    train, val, test = ds.split(32, 8, shuffle_seed=2)
    model = FinetuneModel(9, num_out=spec.num_tasks, hidden=WIDTH,
                          d_transfer=8, encoder=encoder, num_layers=2,
                          num_heads=2, **MODES[encoder])
    init_flax_style_(model, torch.Generator().manual_seed(5))
    opt = masked_adam(model, finetune_trainable_mask(model), 1e-3, 5e-5)
    counters.reset("encoder")
    result = loops.run_finetune(
        make_finetune_step(model, opt, spec.loss, spec.grad_accum),
        make_eval_fn(model), TrainState(model, opt), train, val, test, caps,
        8, spec, epochs=2, seed=3, log=None)
    assert len(result["history"]) == 2
    assert all(np.isfinite(v) for rec in result["history"] for v in rec)
    assert set(counters.of("encoder")) == {
        "band" if encoder == "GIN" else "gt_band_64x128"}
