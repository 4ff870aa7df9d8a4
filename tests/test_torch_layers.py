"""PyTorch port vs the JAX package: MaskedBatchNorm, SegmentBatchNorm,
MLP2 and the GIN encoder (band path and COO path), with flax weights
carried across by ``utils/params.py::from_jax_variables``.

Tolerance: rtol = atol = 1e-5 in float32 for the layers; 1e-4 for the GIN
stack, whose four convs each sum 64-wide products and renormalize."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scgib_tpu.models import encoders as jenc
from scgib_tpu.models import layers as jlayers

from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph.batching import pack_graphs
from scgib_tpu_torch.models import encoders
from scgib_tpu_torch.models.layers import MLP2, MaskedBatchNorm, SegmentBatchNorm
from scgib_tpu_torch.utils import counters
from scgib_tpu_torch.utils.params import from_jax_variables

TOL = dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def bridged(module, variables):
    module.load_state_dict(from_jax_variables(np_tree(variables)))
    return module


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 6)) * 3 + 1).astype(np.float32)
    mask = rng.random(64) < 0.7
    ids = np.sort(rng.integers(0, 5, size=64)).astype(np.int32)
    return x, mask, ids


@pytest.mark.parametrize("masked", [True, False])
def test_masked_batchnorm_train_eval_and_running_stats(rows, masked):
    x, mask, _ = rows
    m = mask if masked else None
    jbn = jlayers.MaskedBatchNorm()
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), None, train=False)
    v = {"params": {"scale": np.linspace(0.5, 1.5, 6).astype(np.float32),
                    "bias": np.linspace(-1, 1, 6).astype(np.float32)},
         "batch_stats": v["batch_stats"]}
    bn = bridged(MaskedBatchNorm(6), v)
    jm = None if m is None else jnp.asarray(m)
    bn.train()
    y, upd = jbn.apply(v, jnp.asarray(x), jm, train=True,
                       mutable=["batch_stats"])
    close(bn(t(x), None if m is None else t(m)), y)
    close(bn.mean, upd["batch_stats"]["mean"])
    close(bn.var, upd["batch_stats"]["var"])
    bn.eval()
    v2 = {"params": v["params"], "batch_stats": upd["batch_stats"]}
    close(bn(t(x), None if m is None else t(m)),
          jbn.apply(v2, jnp.asarray(x), jm, train=False))


def test_segment_batchnorm_train_eval_and_running_stats(rows):
    x, mask, ids = rows
    jbn = jlayers.SegmentBatchNorm()
    args = (jnp.asarray(x), jnp.asarray(ids), 5)
    v = jbn.init(jax.random.PRNGKey(0), *args, mask=jnp.asarray(mask),
                 train=True)
    bn = bridged(SegmentBatchNorm(6), v)
    bn.train()
    y, upd = jbn.apply(v, *args, mask=jnp.asarray(mask), train=True,
                       mutable=["batch_stats"])
    close(bn(t(x), t(ids).long(), 5, mask=t(mask)), y)
    close(bn.mean, upd["batch_stats"]["mean"])
    close(bn.var, upd["batch_stats"]["var"])
    bn.eval()
    close(bn(t(x), t(ids).long(), 5, mask=t(mask)),
          jbn.apply({"params": v["params"],
                     "batch_stats": upd["batch_stats"]}, *args,
                    mask=jnp.asarray(mask), train=False))


def test_mlp2_matches(rows):
    x = rows[0]
    jm = jlayers.MLP2(hidden=12, out=5)
    v = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    m = bridged(MLP2(6, 12, 5), v)
    close(m(t(x)), jm.apply(v, jnp.asarray(x)))


@pytest.fixture(scope="module")
def gin_batch():
    graphs = random_dataset(16, seed=9, min_nodes=8, max_nodes=28)
    g = pack_graphs(graphs, 512, 2048, 16)
    assert g.band_col_off is not None
    return g


@pytest.mark.parametrize("path", ["band", "coo"])
@pytest.mark.parametrize("train", [True, False])
def test_gin_encoder_matches(gin_batch, path, train):
    """The JAX GIN on the CPU takes banded_spmm + MLP on the band path and
    gather_sum + MLP on the COO path; the port takes the fused layer's
    plain version and the same COO path."""
    from scgib_tpu_torch.models.scgib import _resolve_band

    g = gin_batch.to("cpu")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(512, 8)).astype(np.float32)
    band = _resolve_band(g) if path == "band" else None
    jband = None
    if band is not None:
        jband = (jnp.asarray(band[0].float().numpy()),
                 jnp.asarray(band[1].numpy().astype(np.int32)))
    jgin = jenc.GIN(hidden=16, num_convs=3)
    jargs = (jnp.asarray(x), jnp.asarray(g.senders.numpy()),
             jnp.asarray(g.receivers.numpy()))
    jkw = dict(node_mask=jnp.asarray(g.node_mask.numpy()),
               edge_mask=jnp.asarray(g.edge_mask.numpy()), band=jband)
    v = jgin.init(jax.random.PRNGKey(1), *jargs, train=False, **jkw)
    if not train:   # non-trivial running statistics
        v = {"params": v["params"], "batch_stats": jax.tree_util.tree_map(
            lambda a: a + 0.3, v["batch_stats"])}
    gin = bridged(encoders.GIN(8, hidden=16, num_convs=3), v)
    gin.train(train)
    counters.reset("encoder")
    out = gin(t(x), g.senders, g.receivers, node_mask=g.node_mask,
              edge_mask=g.edge_mask, band=band)
    assert counters.of("encoder") == {path: 3}
    if train:
        want, upd = jgin.apply(v, *jargs, train=True,
                               mutable=["batch_stats"], **jkw)
        close(out, want, rtol=1e-4, atol=1e-4)
        for i in range(3):
            close(getattr(gin, f"bn{i}").mean,
                  upd["batch_stats"][f"bn{i}"]["mean"], rtol=1e-4, atol=1e-4)
            close(getattr(gin, f"bn{i}").var,
                  upd["batch_stats"][f"bn{i}"]["var"], rtol=1e-4, atol=1e-4)
    else:
        close(out, jgin.apply(v, *jargs, train=False, **jkw),
              rtol=1e-4, atol=1e-4)
