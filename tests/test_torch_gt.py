"""PyTorch port vs the JAX package: the graph-transformer slice.

The narrow banded geometry and the ``gt_fits`` flags (bit-equal), the COO
attention ops, the plain attention reference, the plain versions of the
four attention kernels against the JAX Pallas kernels in TPU interpret mode
(``bf16_dots=False``) on the inputs of ``gt_cases.py`` (head layouts, both
geometries, all-zero rows, an entry 2, scores past the clamp; the card
tests take the same inputs), the transformer layer and encoder with bridged
weights, the whole ``PretrainModel(encoder="Transformer")``, three trainer
steps, the dropout draws and the CLI.

Tolerances: host-side arrays and flags are compared exactly; the ops and
kernels at rtol = atol = 2e-5 in float32, the strict bound of the JAX
package's own flash-kernel test (reduction order differs); the encoder at
1e-5 relative to its unit-scale LayerNorm output plus 1e-4 relative; the
model's losses at rtol 1e-4 and its gradients at rtol 1e-3 with atol 1e-5
of the largest gradient, as in ``test_torch_model.py``.  The JAX encoder on
a CPU attends over the wide (128, 256) band, the port over the narrow
(64, 128) one when ``gt_fits`` is set; both windows hold every edge, so the
two agree up to reduction order.
"""

import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from scgib_tpu.data import loader as jloader
from scgib_tpu.data.synthetic import random_dataset as jrandom_dataset
from scgib_tpu.graph import banded as jbanded
from scgib_tpu.graph.batching import GraphData as JGraphData
from scgib_tpu.graph.batching import pack_graphs as jpack_graphs
from scgib_tpu.graph.batching import pack_subgraphs as jpack_subgraphs
from scgib_tpu.graph.egonet import extract_egonets as jextract_egonets
from scgib_tpu.models.encoders import GraphTransformer as JGraphTransformer
from scgib_tpu.models.encoders import \
    GraphTransformerLayer as JGraphTransformerLayer
from scgib_tpu.models.scgib import PretrainModel as JPretrainModel
from scgib_tpu.ops import segment as jseg
from scgib_tpu.ops.pallas import gt_flash as jgt
from scgib_tpu.ops.spmm import sddmm_dot as jsddmm_dot
from scgib_tpu.ops.spmm_banded import \
    gt_banded_attention as jgt_banded_attention
from scgib_tpu.train.trainer import TrainState, adam_l2 as jadam_l2
from scgib_tpu.train.trainer import make_pretrain_step as jmake_pretrain_step

import optax

from scgib_tpu_torch import cli
from scgib_tpu_torch.data import loader
from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph import banded
from scgib_tpu_torch.graph.batching import (GraphData, pack_graphs,
                                            pack_subgraphs)
from scgib_tpu_torch.graph.container import GraphBatch, SubgraphBatch
from scgib_tpu_torch.graph.egonet import extract_egonets
from scgib_tpu_torch.models import encoders
from scgib_tpu_torch.models.encoders import (GraphTransformer,
                                             GraphTransformerLayer, dropout)
from scgib_tpu_torch.models.scgib import (PretrainModel, _resolve_band,
                                          uniform_draws)
from scgib_tpu_torch.ops import segment
from scgib_tpu_torch.ops.kernels import gt_flash as kg
from scgib_tpu_torch.ops.spmm import sddmm_dot
from scgib_tpu_torch.ops.spmm_banded import gt_banded_attention, gt_scores
from scgib_tpu_torch.train.trainer import make_pretrain_step
from scgib_tpu_torch.utils.params import from_jax_variables, init_flax_style_

from gt_cases import (CASES, EMPTY, GEOMETRIES, Q_SCALE, REPEATED,
                      case_inputs)
from gt_cases import banded_graph as _banded_graph
from gt_cases import qkvg as _qkvg

TOL = dict(rtol=2e-5, atol=2e-5)


def t(x):
    return torch.from_numpy(np.array(x))


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def jblocks(blocks):
    return jnp.asarray(blocks.float().numpy()).astype(jnp.bfloat16)


def no_dropout(next_fun, args, kwargs, context):
    """flax interceptor: ``nn.Dropout`` returns its input unchanged."""
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.fixture(scope="module")
def batch():
    """(g, sub) tensor batches on the CPU: 512 graph rows, 1536 ego-net
    rows, both fitting the band and the narrow geometry."""
    graphs = random_dataset(16, seed=5, min_nodes=8, max_nodes=28)
    egos = [extract_egonets(g, 1) for g in graphs]
    return (pack_graphs(graphs, 512, 2048, 16).to("cpu"),
            pack_subgraphs(graphs, egos, 1536, 4096).to("cpu"))


# --- modules 1-4: geometry, flags --------------------------------------------

@pytest.mark.parametrize("which", ["graph", "sub"])
def test_narrow_blocks_bit_equal_jax(batch, which):
    b = batch[0] if which == "graph" else batch[1]
    n = b.num_nodes
    off = banded.banded_col_off(n, banded.GT_TILE, banded.GT_BAND,
                                banded.GT_ALIGN)
    np.testing.assert_array_equal(off, jbanded.banded_col_off(n, 64, 128, 8))
    blocks, port_off = _resolve_band(b, gt=True)
    np.testing.assert_array_equal(port_off.numpy(), off)
    want = jbanded.build_blocks_jax(
        jnp.asarray(b.senders.numpy()), jnp.asarray(b.receivers.numpy()),
        jnp.asarray(b.edge_mask.numpy()), jnp.asarray(off), n, tile=64,
        band=128)
    assert blocks.dtype == torch.bfloat16 and blocks.shape == want.shape
    np.testing.assert_array_equal(blocks.float().numpy(),
                                  np.asarray(want, np.float32))
    # every edge lies in its window: the blocks hold all of them
    assert int(blocks.float().sum()) == int(b.edge_mask.sum())
    # built once per batch
    assert _resolve_band(b, gt=True)[0] is blocks


@pytest.mark.parametrize("max_component,cap", [
    (33, 256), (34, 256), (20, 128), (20, 64), (20, 192), (20, 200),
    (0, 512)])
def test_gt_band_fits_matches_jax(max_component, cap):
    assert (banded.gt_band_fits(max_component, cap)
            == jbanded.gt_band_fits(max_component, cap))


def _star(n, feat_dim=9):
    """A star of n nodes: node 0's 1-hop ego-net has all n."""
    s = np.concatenate([np.zeros(n - 1), np.arange(1, n)]).astype(np.int32)
    r = np.concatenate([np.arange(1, n), np.zeros(n - 1)]).astype(np.int32)
    x = np.random.default_rng(n).normal(size=(n, feat_dim)).astype(
        np.float32)
    return s, r, x


@pytest.mark.parametrize("star", [0, 33, 34], ids=["none", "star33",
                                                    "star34"])
@pytest.mark.parametrize("max_nodes", [33, 34])
def test_gt_fits_flags_match_jax_packers(star, max_nodes):
    """Both sides of the 33-node boundary, for graphs (``max_nodes``) and
    for ego-nets (a star's center), per batch and per dataset."""
    jgraphs = jrandom_dataset(10, seed=max_nodes, min_nodes=max_nodes - 2,
                              max_nodes=max_nodes)
    if star:
        s, r, x = _star(star)
        jgraphs.append(JGraphData(senders=s, receivers=r, node_feat=x))
    graphs = [GraphData(senders=g.senders, receivers=g.receivers,
                        node_feat=g.node_feat) for g in jgraphs]
    jds = jloader.GraphDataset(jgraphs, k=1)
    ds = loader.GraphDataset(graphs, k=1)
    caps = loader.plan_capacities(ds, 4)
    jcaps = jloader.Capacities(**{f: getattr(caps, f) for f in (
        "nodes", "edges", "graphs", "sub_nodes", "sub_edges")})
    sel = np.arange(len(graphs))[-4:]     # holds the star, if any
    g, sub = loader.pack_batch(ds, sel, caps)
    jg, jsub = jloader.pack_batch(jds, sel, jcaps)
    assert (g.gt_fits, sub.gt_fits) == (jg.gt_fits, jsub.gt_fits)
    assert g.gt_fits == (max_nodes <= 33 and star <= 33)
    assert sub.gt_fits == (star <= 33)
    # per batch (no dataset at hand): the packers' own default
    sel = sel[:2]
    egos = [ds.egonets[j] for j in sel]
    pg = pack_graphs([graphs[j] for j in sel], caps.nodes, caps.edges,
                     caps.graphs)
    psub = pack_subgraphs([graphs[j] for j in sel], egos, caps.sub_nodes,
                          caps.sub_edges)
    jpg = jpack_graphs([jgraphs[j] for j in sel], caps.nodes, caps.edges,
                       caps.graphs)
    jpsub = jpack_subgraphs([jgraphs[j] for j in sel],
                            [jds.egonets[j] for j in sel], caps.sub_nodes,
                            caps.sub_edges)
    assert (pg.gt_fits, psub.gt_fits) == (jpg.gt_fits, jpsub.gt_fits)
    # the flag stays a bool through the tensor conversions
    for port, ref, cls in ((g, jg, GraphBatch), (sub, jsub, SubgraphBatch)):
        moved = port.to("cpu")
        assert moved.gt_fits is port.gt_fits
        assert cls.from_numpy(ref, "cpu").gt_fits is bool(ref.gt_fits)


# --- module 5: the COO attention ops ------------------------------------------

def test_sddmm_dot_and_segment_normalize_exp_match_jax(batch):
    g, _ = batch
    rng = np.random.default_rng(0)
    n, heads, hd = g.num_nodes, 4, 8
    k = rng.normal(size=(n, heads, hd)).astype(np.float32)
    q = rng.normal(size=(n, heads, hd)).astype(np.float32)
    s, r, m = (x.numpy() for x in (g.senders, g.receivers, g.edge_mask))
    score = sddmm_dot(t(k), t(q), g.senders, g.receivers)
    jscore = jsddmm_dot(jnp.asarray(k), jnp.asarray(q), jnp.asarray(s),
                        jnp.asarray(r))
    close(score, jscore)
    # scores past the clamp on both sides
    big = score * 3.0
    close(segment.segment_normalize_exp(big, g.receivers, n, mask=g.edge_mask),
          jseg.segment_normalize_exp(jnp.asarray(big.numpy()),
                                     jnp.asarray(r), n,
                                     mask=jnp.asarray(m)))


# --- module 6: the plain attention reference ----------------------------------

@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_gt_banded_attention_matches_jax(geometry):
    blocks, off = _banded_graph(geometry)
    q, k, v, ct = _qkvg(256)
    jb, jo = jblocks(blocks), jnp.asarray(off.numpy())

    def jloss(q, k, v):
        out = jgt_banded_attention(jb, jo, q, k, v)
        return jnp.sum(out * ct), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    ts = [t(x).requires_grad_() for x in (q, k, v)]
    out = gt_banded_attention(blocks, off, *ts)
    (out * t(ct)).sum().backward()
    close(out, jout)
    for x, jg_, name in zip(ts, jgrads, "qkv"):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg_),
                                   err_msg=f"d{name}", **TOL)


def test_gt_banded_attention_follows_its_dtype():
    blocks, off = _banded_graph("narrow")
    q, k, v, _ = (t(x).double() for x in _qkvg(256))
    assert gt_banded_attention(blocks, off, q, k, v).dtype == torch.float64
    out, z = kg.gt_fwd(blocks, off, q, k, v)
    assert out.dtype == z.dtype == torch.float64


# --- module 7: the kernels' plain versions vs the Pallas kernels ---------------

@pytest.fixture(scope="module", params=list(CASES))
def pallas_run(request):
    """Inputs of one of ``gt_cases.CASES`` (geometry, heads x head width,
    edge cases), and the outputs of each of the four Pallas kernels in
    interpret mode (f32 dots): fwd (out, z), rows (dq, rho), cols (dk, dv)
    and merged (dq, dk, dv)."""
    blocks, off, (q, k, v, g) = case_inputs(request.param)
    n, heads, hd = q.shape
    flat = [jnp.asarray(x.reshape(n, heads * hd)) for x in (q, k, v, g)]
    jb, jo = jblocks(blocks), jnp.asarray(off.numpy().astype(np.int32))
    calls = []
    pallas_call = pl.pallas_call

    def recording(*args, **kwargs):
        fn = pallas_call(*args, **kwargs)

        def run(*xs):
            outs = fn(*xs)
            calls.append([np.asarray(o) for o in outs])
            return outs
        return run

    with pltpu.force_tpu_interpret_mode(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", recording)
        out, z = jgt._run_fwd(jb, jo, *flat[:3], heads, hd, 5.0, 1e-6, False)
        jgt._run_bwd_twopass(jb, jo, *flat, z, heads, hd, 5.0, 1e-6, False)
        jgt._run_bwd_merged(jb, jo, *flat, z, heads, hd, 5.0, 1e-6, False)
    fwd, rows, cols, merged = calls
    shape = (n, heads, hd)
    return {"blocks": blocks, "off": off, "qkvg": [t(x) for x in (q, k, v, g)],
            "fwd": (fwd[0].reshape(shape), fwd[1]),
            "rows": (rows[0].reshape(shape), rows[1]),
            "cols": tuple(x.reshape(shape) for x in cols),
            "merged": tuple(x.reshape(shape) for x in merged)}


@pytest.mark.parametrize("kernel", ["fwd", "rows", "cols", "merged"])
def test_plain_versions_match_pallas_kernels(pallas_run, kernel):
    r = pallas_run
    blocks, off = r["blocks"], r["off"]
    q, k, v, g = r["qkvg"]
    z = t(r["fwd"][1])
    if kernel == "fwd":
        got = kg.gt_fwd(blocks, off, q, k, v)
    elif kernel == "rows":
        got = kg.gt_bwd_rows(blocks, off, q, k, v, g, z)
    elif kernel == "cols":
        got = kg.gt_bwd_cols(blocks, off, q, k, v, g, z, t(r["rows"][1]))
    else:
        got = kg.gt_bwd_merged(blocks, off, q, k, v, g, z)
    assert len(got) == len(r[kernel])
    for a, b in zip(got, r[kernel]):
        close(a, b)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_edge_cases_hold_what_they_claim(geometry):
    """The edge-case inputs have all-zero gate rows (in the narrow geometry
    a whole empty tile), an entry 2, and scores past the clamp; the plain
    backward gives those rows zero gradients."""
    blocks, off, (q, k, v, g) = case_inputs(f"{geometry}-edges")
    lo, hi = EMPTY
    a = blocks.float().reshape(-1, blocks.shape[2])
    assert float(a[lo:hi].abs().max()) == 0.0
    if geometry == "narrow":
        assert float(blocks[lo // 64].float().abs().max()) == 0.0
    u, w = REPEATED
    assert float(a[u, w - int(off[u // blocks.shape[1]])]) >= 2.0
    qt, kt, vt, gt = (t(x) for x in (q, k, v, g))
    s, _ = gt_scores(blocks, off, qt, kt, 5.0)
    gated = s[blocks.float()[:, None].expand_as(s) != 0]
    assert float((gated.abs() > 5.0).float().mean()) > 0.5
    assert float((gated.abs() <= 5.0).float().mean()) > 0.01
    assert float(qt.abs().max()) > Q_SCALE
    z = kg.gt_fwd(blocks, off, qt, kt, vt)[1]
    dq, rho = kg.gt_bwd_rows(blocks, off, qt, kt, vt, gt, z)
    dk, dv = kg.gt_bwd_cols(blocks, off, qt, kt, vt, gt, z, rho)
    for x in (dq, rho, dk, dv):
        assert float(x[lo:hi].abs().max()) == 0.0
        assert float(x.abs().max()) > 0.0


def test_kernel_build_key_covers_the_headers(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` header gives every source a new library
    path, so no stale library is loaded; the source's own edits too."""
    from scgib_tpu_torch.ops.kernels import build

    (tmp_path / "a.cu").write_text('#include "w.cuh"\n')
    (tmp_path / "w.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build._so_path("a")
    assert build._so_path("a") == first
    (tmp_path / "w.cuh").write_text("// v2\n")
    second = build._so_path("a")
    assert second != first and second.name.startswith("libscgib_a_")
    (tmp_path / "a.cu").write_text('#include "w.cuh"\n// edited\n')
    assert build._so_path("a") not in (first, second)


_FAKE_PTXAS = """\
ptxas info    : Compiling entry function '_Z13gt_fwd_kernelILi0EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z13gt_fwd_kernelILi0EEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 166 registers, used 0 barriers
ptxas info    : Compiling entry function '_Z18gt_row_pass_kernelILi4ELb0EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z18gt_row_pass_kernelILi4ELb0EEvPKf
    8 bytes stack frame, 8 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers, 8 bytes cumulative stack size
"""


def test_kernel_build_keeps_its_ptxas_report(tmp_path, monkeypatch):
    """A library built before is loaded without a build, and its ptxas
    report with it, read back from beside the library; a library whose
    report is missing is built again."""
    from scgib_tpu_torch.ops.kernels import build

    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"""#!{sys.executable}
import subprocess, sys
open({str(calls)!r}, "a").write("x")
out = sys.argv[sys.argv.index("-o") + 1]
subprocess.run(["gcc", "-shared", "-fPIC", "-x", "c", "-", "-o", out],
               input=b"int f(void) {{ return 1; }}", check=True)
sys.stderr.write({_FAKE_PTXAS!r})
""")
    nvcc.chmod(0o755)
    (tmp_path / "a.cu").write_text("// a\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "logs", {})
    want = {"_Z13gt_fwd_kernelILi0EEvPKf": {
                "registers": 166, "spill_stores": 0, "spill_loads": 0},
            "_Z18gt_row_pass_kernelILi4ELb0EEvPKf": {
                "registers": 96, "spill_stores": 8, "spill_loads": 16}}
    build.load("a")
    assert calls.read_text() == "x"
    assert build.ptxas_report("a") == want
    for reload in ("cached", "report lost"):
        build._libs.clear()
        build.logs.clear()
        if reload == "report lost":
            build._log_path(build._so_path("a")).unlink()
        build.load("a")
        assert build.ptxas_report("a") == want
    assert calls.read_text() == "xx"


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_merged_backward_matches_twopass(geometry):
    """The autograd function's two backward variants, and both against
    autograd through ``gt_banded_attention``."""
    blocks, off = _banded_graph(geometry)
    q, k, v, ct = _qkvg(256, seed=6)
    grads = {}
    for bwd in ("twopass", "merged", "autograd"):
        ts = [t(x).requires_grad_() for x in (q, k, v)]
        out = (gt_banded_attention(blocks, off, *ts) if bwd == "autograd"
               else kg.gt_flash_attention(blocks, off, *ts, bwd=bwd))
        (out * t(ct)).sum().backward()
        grads[bwd] = [x.grad for x in ts]
    for bwd in ("merged", "autograd"):
        for a, b in zip(grads[bwd], grads["twopass"]):
            close(a, b)
    with pytest.raises(ValueError, match="bwd"):
        kg.gt_flash_attention(blocks, off, *(t(x) for x in (q, k, v)),
                              bwd="onepass")


def test_wrappers_take_plain_versions_on_cpu_without_launching():
    blocks, off = _banded_graph("narrow")
    q, k, v, g = (t(x) for x in _qkvg(256))
    kg.reset_launch_counts()
    out, z = kg.gt_fwd(blocks, off, q, k, v)
    kg.gt_bwd_merged(blocks, off, q, k, v, g, z)
    assert kg.launch_counts() == dict.fromkeys(kg.KERNELS, 0)


# --- modules 8-10: layer and encoder -----------------------------------------

HID, HEADS = 32, 4


def _encoder_inputs(coo, seed=0):
    """Graph-batch inputs (512 rows, 16 molecules) for the encoder: the
    port's band (narrow) and the JAX one (wide), or none on the COO path."""
    graphs = random_dataset(16, seed=11, min_nodes=8, max_nodes=28)
    b = pack_graphs(graphs, 512, 2048, 16, banded=not coo).to("cpu")
    x = np.random.default_rng(seed).normal(size=(512, HID)).astype(
        np.float32)
    x[~b.node_mask.numpy()] = 0.0
    if coo:
        band = jband = None
    else:
        band = _resolve_band(b, gt=True)
        wide = _resolve_band(b)
        jband = (jblocks(wide[0]), jnp.asarray(wide[1].numpy()))
        assert band[0].shape[1:] == (64, 128)
    jargs = [jnp.asarray(y.numpy()) for y in (b.senders, b.receivers)]
    kw = dict(node_mask=b.node_mask, edge_mask=b.edge_mask)
    jkw = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}
    return b, x, band, jband, jargs, kw, jkw


LAYOUTS = {"fused": {}, "separate": {"SCGIB_GT_FUSED_QKV": "0"},
           "stacked": {"SCGIB_GT_SCAN": "1"}}


def _encoder_close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("layout", ["fused", "separate"])
@pytest.mark.parametrize("path", ["band", "coo"])
def test_layer_matches_jax(monkeypatch, path, layout):
    for k, v in LAYOUTS[layout].items():
        monkeypatch.setenv(k, v)
    b, x, band, jband, (js, jr), kw, jkw = _encoder_inputs(path == "coo")
    jlayer = JGraphTransformerLayer(HID, HEADS)
    variables = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x), js, jr,
                            band=jband, train=False,
                            edge_mask=jkw["edge_mask"])
    want = jlayer.apply(variables, jnp.asarray(x), js, jr, band=jband,
                        train=False, edge_mask=jkw["edge_mask"])
    assert ("qkv" in variables["params"]) == (layout == "fused")
    layer = GraphTransformerLayer(HID, HEADS).eval()
    layer.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)))
    encoders.branch_counts.clear()
    got = layer(t(x), b.senders, b.receivers, edge_mask=b.edge_mask,
                band=band)
    rows = b.node_mask.numpy()        # padding rows are masked downstream
    _encoder_close(got[rows], np.asarray(want)[rows])
    assert dict(encoders.branch_counts) == (
        {"gt_band_64x128": 1} if path == "band" else {"gt_coo": 1})


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("path", ["band", "coo"])
def test_encoder_matches_jax(monkeypatch, path, layout):
    for k, v in LAYOUTS[layout].items():
        monkeypatch.setenv(k, v)
    b, x, band, jband, (js, jr), kw, jkw = _encoder_inputs(path == "coo", 1)
    x = x[:, :16]                                   # embed 16 -> HID
    jenc = JGraphTransformer(hidden=HID, num_layers=1, num_heads=HEADS)
    args = (jnp.asarray(x), js, jr)
    jkw = dict(jkw, band=jband, train=False, gt_fits=True)
    variables = jenc.init(jax.random.PRNGKey(2), *args, **jkw)
    want = jenc.apply(variables, *args, **jkw)
    assert ("layers" in variables["params"]) == (layout == "stacked")
    enc = GraphTransformer(16, hidden=HID, num_layers=1,
                           num_heads=HEADS).eval()
    enc.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)))
    got = enc(t(x), b.senders, b.receivers, band=band, **kw)
    _encoder_close(got, want)
    assert float(got.detach()[~b.node_mask].abs().max()) == 0.0


def test_layernorm_and_dropout_defaults():
    layer = GraphTransformerLayer(HID, HEADS)
    assert layer.ln1.eps == layer.ln2.eps == 1e-6      # flax's, not torch's
    assert layer.dropout == 0.5
    with pytest.raises(ValueError, match="multiple"):
        GraphTransformerLayer(30, 4)


def test_dropout_mask_from_seeded_generator():
    x = torch.ones(2000, 64)
    draws = [dropout(x, 0.5, uniform_draws(torch.Generator().manual_seed(9),
                                           "cpu")) for _ in range(2)]
    assert torch.equal(draws[0], draws[1])              # repeatable
    kept = draws[0] != 0
    assert set(draws[0][kept].unique().tolist()) == {2.0}
    assert abs(float(kept.float().mean()) - 0.5) < 0.01
    other = dropout(x, 0.5, uniform_draws(torch.Generator().manual_seed(10),
                                          "cpu"))
    assert not torch.equal(other, draws[0])
    assert dropout(x, 0.0, None) is x
    # a layer drops only in training mode, from the draws it is handed
    layer = GraphTransformerLayer(HID, HEADS)
    h = torch.randn(64, HID)
    s = r = torch.arange(64)
    calls = []

    def rand(shape):
        calls.append(shape)
        return torch.rand(shape)

    layer.eval()(h, s, r, rand=rand)
    assert not calls
    layer.train()(h, s, r, rand=rand)
    assert calls == [(64, 2 * HID)]


# --- modules 11-14: model, trainer, CLI ----------------------------------------

IN, MHID, DT, MHEADS = 9, 16, 8, 2


def _model_batches(banded_mode):
    graphs = jrandom_dataset(12, seed=3, min_nodes=8, max_nodes=20,
                             feat_dim=IN)
    egos = [jextract_egonets(x, 1) for x in graphs]
    jg = jpack_graphs(graphs, 256, 1024, 16, banded=banded_mode)
    jsub = jpack_subgraphs(graphs, egos, 1024, 4096, banded=banded_mode)
    return jg, jsub


def _jax_model(deterministic=True):
    return JPretrainModel(in_dim=IN, hidden=MHID, d_transfer=DT,
                          encoder="Transformer", num_layers=1,
                          num_heads=MHEADS, deterministic=deterministic)


def _port_model(v):
    m = PretrainModel(IN, hidden=MHID, d_transfer=DT, encoder="Transformer",
                      num_layers=1, num_heads=MHEADS, deterministic=True)
    m.load_state_dict(from_jax_variables(v))
    for mod in m.modules():
        if isinstance(mod, GraphTransformerLayer):
            mod.dropout = 0.0
    return m.train()


@pytest.mark.parametrize("path", ["band", "coo"])
def test_pretrain_model_matches_jax(path):
    """Train mode, deterministic gate, dropout neutralized on both sides:
    losses and every parameter's gradient."""
    jg, jsub = _model_batches("device" if path == "band" else False)
    assert (jg.band_col_off is not None) == (path == "band")
    assert jg.gt_fits and jsub.gt_fits
    jmodel = _jax_model()
    v = jmodel.init({"params": jax.random.PRNGKey(0),
                     "noise": jax.random.PRNGKey(1),
                     "dropout": jax.random.PRNGKey(2)}, jg, jsub, train=True)
    v = jax.tree_util.tree_map(np.asarray, v)

    def loss(params):
        losses, _ = jmodel.apply({"params": params,
                                  "batch_stats": v["batch_stats"]},
                                 jg, jsub, train=True,
                                 mutable=["batch_stats"],
                                 rngs={"dropout": jax.random.PRNGKey(3)})
        return losses.total, losses

    with fnn.intercept_methods(no_dropout):
        (_, losses), grads = jax.value_and_grad(loss, has_aux=True)(
            v["params"])
    model = _port_model(v)
    encoders.branch_counts.clear()
    port = model(GraphBatch.from_numpy(jg, "cpu"),
                 SubgraphBatch.from_numpy(jsub, "cpu"))
    port.total.backward()
    assert dict(encoders.branch_counts) == (
        {"gt_band_64x128": 4} if path == "band" else {"gt_coo": 4})
    for a, b in zip(port, losses):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4)
    want = from_jax_variables({"params": jax.tree_util.tree_map(
        np.asarray, grads)})
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(params[name].grad.numpy(), w.numpy(),
                                   rtol=1e-3, atol=1e-5 * scale,
                                   err_msg=name)


def test_bridge_and_init_cover_the_transformer():
    jg, jsub = _model_batches("device")
    v = _jax_model().init({"params": jax.random.PRNGKey(0),
                           "noise": jax.random.PRNGKey(1),
                           "dropout": jax.random.PRNGKey(2)},
                          jg, jsub, train=True)
    v = jax.tree_util.tree_map(np.asarray, v)
    state = from_jax_variables(v)
    model = PretrainModel(IN, hidden=MHID, d_transfer=DT,
                          encoder="Transformer", num_layers=1,
                          num_heads=MHEADS)
    assert set(state) == set(model.state_dict())
    jl = v["params"]["core"]["encoder1"]["layer1"]
    np.testing.assert_array_equal(
        state["core.encoder1.layer1.ln2.weight"].numpy(),
        jl["ln2"]["scale"])
    np.testing.assert_array_equal(
        state["core.encoder1.layer1.qkv.weight"].numpy(),
        jl["qkv"]["kernel"].T)
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(3.0)
    init_flax_style_(model, torch.Generator().manual_seed(0))
    ln = model.core.encoder2.layer0.ln1
    assert float(ln.weight.min()) == float(ln.weight.max()) == 1.0
    assert float(ln.bias.abs().max()) == 0.0
    assert float(model.core.encoder2.embed.weight.std()) < 1.0


def test_three_steps_match_jax_trainer():
    """As ``test_torch_trainer.py``: both trainers mask the gradients that
    are zero but for rounding; dropout is neutralized on both sides."""
    lr, wd, steps = 1e-4, 5e-5, 3
    jg, jsub = _model_batches("device")
    jmodel = _jax_model()
    v = jmodel.init({"params": jax.random.PRNGKey(0),
                     "noise": jax.random.PRNGKey(1),
                     "dropout": jax.random.PRNGKey(2)}, jg, jsub, train=True)
    v = jax.tree_util.tree_map(np.asarray, v)

    def total(params):
        losses, _ = jmodel.apply({"params": params,
                                  "batch_stats": v["batch_stats"]},
                                 jg, jsub, train=True,
                                 mutable=["batch_stats"],
                                 rngs={"dropout": jax.random.PRNGKey(3)})
        return losses.total

    with fnn.intercept_methods(no_dropout):
        grad0 = jax.tree_util.tree_map(np.abs, jax.grad(total)(v["params"]))
        scale = max(a.max() for a in jax.tree_util.tree_leaves(grad0))
        keep = jax.tree_util.tree_map(
            lambda a: (a > 1e-5 * scale).astype(np.float32), grad0)
        tx = optax.chain(
            optax.stateless(lambda u, _: jax.tree_util.tree_map(
                lambda a, k: a * k, u, keep)),
            jadam_l2(lr, wd))
        state = TrainState.create(v, tx)
        jstep = jmake_pretrain_step(jmodel, tx, donate=False)
        for i in range(steps):
            state, jlosses = jstep(state, jg, jsub, jax.random.PRNGKey(i))

    model = _port_model(v)
    keep_t = from_jax_variables({"params": keep})
    for name, p in model.named_parameters():
        p.register_hook(lambda g, k=keep_t[name]: g * k)
    g, sub = (GraphBatch.from_numpy(jg, "cpu"),
              SubgraphBatch.from_numpy(jsub, "cpu"))
    step = make_pretrain_step(model, torch.optim.Adam(
        model.parameters(), lr=lr, weight_decay=wd))
    for _ in range(steps):
        losses = step(g, sub, torch.Generator().manual_seed(0))
    for a, b in zip(losses, jlosses):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4)
    want = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats}))
    got = model.state_dict()
    params = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=5e-2 * lr if name in params else 1e-6,
                                   err_msg=name)


def test_cli_pretrain_transformer_on_cpu(capsys):
    encoders.branch_counts.clear()
    records = cli.run_pretrain(synthetic=24, batch_size=8, steps=1,
                               device="cpu", encoder="Transformer",
                               num_layers=1, num_heads=4, gt_bwd="merged")
    assert all(np.isfinite(records[0][k])
               for k in ("kl", "contrastive", "reconstruction"))
    assert set(encoders.branch_counts) == {"gt_band_64x128"}
    cli.main(["pretrain", "--synthetic", "24", "--batch_size", "8",
              "--steps", "1", "--device", "cpu", "--encoder", "Transformer",
              "--num_layers", "1", "--num_heads", "4"])
    assert "step 0: kl" in capsys.readouterr().out


def test_cli_transformer_refuses_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["pretrain", "--synthetic", "8", "--steps", "1",
                  "--encoder", "Transformer"])
