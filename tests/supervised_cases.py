"""Shared inputs and helpers of the supervised-path parity tests
(``test_torch_finetune.py``, ``test_torch_finetune_steps.py``): two
labelled batches from the JAX package's generator and packers, the port's
and the JAX package's models at the tests' widths, the JAX variables
(jitted init, kept), and the comparison of a port model's state with a
JAX variables tree."""

import flax.linen as fnn
import jax
import numpy as np

from scgib_tpu.data.synthetic import random_dataset as jrandom_dataset
from scgib_tpu.graph.batching import pack_graphs as jpack_graphs
from scgib_tpu.graph.batching import pack_subgraphs as jpack_subgraphs
from scgib_tpu.graph.egonet import extract_egonets as jextract_egonets
from scgib_tpu.models.scgib import DomainAdaptModel as JDomainAdaptModel
from scgib_tpu.models.scgib import FinetuneModel as JFinetuneModel

from scgib_tpu_torch.graph.container import GraphBatch, SubgraphBatch
from scgib_tpu_torch.models.encoders import GraphTransformerLayer
from scgib_tpu_torch.models.scgib import DomainAdaptModel, FinetuneModel
from scgib_tpu_torch.utils.params import from_jax_variables

IN, HID, DT, TASKS = 9, 16, 8, 3
LR, WD = 1e-3, 1e-5
TOL = dict(rtol=1e-5, atol=1e-6)
# GIN at 3 convs keeps a conv2 for the reference freeze mask to train
ENCODERS = {"GIN": {"num_layers": 3},
            "Transformer": {"encoder": "Transformer", "num_layers": 1,
                            "num_heads": 2}}


def labelled_graphs(n=12, seed=3, **kw):
    return jrandom_dataset(n, seed=seed, min_nodes=8, max_nodes=20,
                           feat_dim=IN, num_tasks=TASKS, label_nan_frac=0.3,
                           **kw)


def jax_batch(graphs):
    egos = [jextract_egonets(x, 1) for x in graphs]
    return (jpack_graphs(graphs, 256, 1024, 16, banded="device"),
            jpack_subgraphs(graphs, egos, 1024, 4096, banded="device"))


def make_batches():
    """Two labelled JAX batches (some labels NaN) that fit the band and the
    narrow attention geometry."""
    out = [jax_batch(labelled_graphs(seed=s)) for s in (3, 4)]
    for jg, jsub in out:
        assert jg.band_col_off is not None and jg.gt_fits and jsub.gt_fits
        assert not np.asarray(jg.label_mask)[:12].all()
    return out


def port(jg, jsub):
    return (GraphBatch.from_numpy(jg, "cpu"),
            SubgraphBatch.from_numpy(jsub, "cpu"))


def no_dropout(next_fun, args, kwargs, context):
    """flax interceptor: ``nn.Dropout`` returns its input unchanged."""
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def no_port_dropout(model):
    for m in model.modules():
        if isinstance(m, GraphTransformerLayer):
            m.dropout = 0.0
    return model


_VARIABLES = {}


def jax_variables(jmodel, jg, jsub):
    """The JAX model's variables (jitted init, kept per model and batch)."""
    key = (jmodel, id(jg))
    if key not in _VARIABLES:
        v = jax.jit(jmodel.init, static_argnames=("train",))(
            {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
             "dropout": jax.random.PRNGKey(2)}, jg, jsub, train=True)
        _VARIABLES[key] = jax.tree_util.tree_map(np.asarray, v)
    return _VARIABLES[key]


def close_state(model, want_vars, lr=None):
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, want_vars))
    got = model.state_dict()
    params = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        atol = (5e-2 * lr if lr else 1e-6) if name in params else 1e-6
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=atol, err_msg=name)


def models(kind, encoder, regression=False):
    kw = dict(hidden=HID, d_transfer=DT, deterministic=True,
              **ENCODERS[encoder])
    if kind == "finetune":
        return (FinetuneModel(IN, num_out=TASKS, regression=regression, **kw),
                JFinetuneModel(in_dim=IN, num_out=TASKS,
                               regression=regression, **kw))
    return DomainAdaptModel(IN, **kw), JDomainAdaptModel(in_dim=IN, **kw)
