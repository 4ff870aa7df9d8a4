"""PyTorch port vs the JAX package: importing the reference's whole-module
torch pickle (``utils/reference_import.py``).

The shipped artifact is not in the repository, so a stand-in is built
(``tests/reference_cases.py``): the reference's class names, three nesting
levels, 5 convs, depth 1 the only trained one, every class of it shelled
on load.  The port's flat state and converted tree must equal the JAX
package's functions' on the same file, bit for bit; ``FinetuneModel`` from
the converted weights must give the JAX model's scores (rtol 1e-5, atol
1e-6); and the ``finetune`` and ``adapt`` verbs must adopt the file's 5
convs."""

import sys

import jax
import numpy as np
import pytest
import torch

from scgib_tpu.models.scgib import FinetuneModel as JFinetuneModel
from scgib_tpu.train import checkpoint as jckpt
from scgib_tpu.utils import reference_import as jref

from scgib_tpu_torch import cli
from scgib_tpu_torch.models.scgib import FinetuneModel
from scgib_tpu_torch.utils import reference_import as ref
from scgib_tpu_torch.utils.params import from_jax_variables

from reference_cases import MODULE, write_stand_in
from supervised_cases import TOL, jax_batch, labelled_graphs, port

IN, HID, DT, CONVS, DEPTH = 9, 16, 8, 5, 3


@pytest.fixture(scope="module")
def stand_in(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "stand_in.pt"
    return str(write_stand_in(path, IN, HID, DT, CONVS, DEPTH))


def test_flat_state_equals_jax(stand_in):
    got = ref.load_reference_state(stand_in)
    want = jref.load_reference_state(stand_in)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k
    assert f"{'model.' * DEPTH}Encoder1.ginlayers.4.apply_func.mlp.2.bias" \
        in got
    assert MODULE not in sys.modules


def test_the_trained_depth_is_one_and_there_are_five_convs(stand_in):
    flat = ref.load_reference_state(stand_in)
    assert ref.nesting_depths(flat) == DEPTH
    assert [ref.bn_trained_at_depth(flat, d) for d in range(DEPTH + 1)] == \
        [False, True, False, False]
    assert ref.trained_core_depth(flat) == 1
    _, meta = ref.convert_to_pretrain_variables(flat)
    assert meta == {"core_depth": 1, "num_convs": CONVS}
    _, meta = ref.convert_to_pretrain_variables(flat, depth=2)
    assert meta["core_depth"] == 2


@pytest.mark.parametrize("depth", [None, 2])
def test_converted_tree_equals_jax(stand_in, depth):
    got, meta = ref.convert_to_pretrain_variables(
        ref.load_reference_state(stand_in), depth=depth)
    want, jmeta = jref.convert_to_pretrain_variables(
        jref.load_reference_state(stand_in), depth=depth)
    assert meta == jmeta
    g, w = (jax.tree_util.tree_leaves_with_path(t) for t in (got, want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path


def test_finetune_model_from_the_import_matches_jax(stand_in):
    """The converted core grafted into a fresh FinetuneModel (5 convs):
    its parameter tree is the JAX model's, and its eval-mode scores
    (deterministic gate) are the JAX model's."""
    jg, jsub = jax_batch(labelled_graphs(seed=3))
    kw = dict(hidden=HID, d_transfer=DT, num_layers=CONVS,
              deterministic=True)
    jmodel = JFinetuneModel(in_dim=IN, num_out=3, **kw)
    init = jax.tree_util.tree_map(np.asarray, jmodel.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jg, jsub, train=True))
    pre, _ = ref.convert_to_pretrain_variables(
        ref.load_reference_state(stand_in))
    v = jckpt.load_core_into(init, pre)
    model = FinetuneModel(IN, num_out=3, **kw)
    state = from_jax_variables(v)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    np.testing.assert_array_equal(
        model.core.encoder2.bn4.var.numpy(),
        pre["batch_stats"]["core"]["encoder2"]["bn4"]["var"])
    want = jmodel.apply(v, jg, jsub, train=False)
    with torch.no_grad():
        got = model.eval()(*port(jg, jsub))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


SMALL = ["--synthetic", "60", "--hidden", str(HID), "--d_transfer", str(DT),
         "--batch_size", "16", "--device", "cpu", "--epochs", "1"]


def test_finetune_verb_adopts_the_imported_depth(stand_in, tmp_path, capsys):
    ft = str(tmp_path / "ft.msgpack")
    run = cli.main(["finetune", "--dataset", "BACE", "--pretrained",
                    stand_in, "--out", ft] + SMALL)
    out = capsys.readouterr().out
    assert "imported checkpoint has 5 conv layers; overriding " \
           "--num_layers 4" in out
    assert "core depth 1, 5 convs" in out
    model = run["last"]["state"].model
    assert model.core.encoder1.num_convs == CONVS
    # the reference freeze keeps conv 0 as imported
    pre, _ = ref.convert_to_pretrain_variables(
        ref.load_reference_state(stand_in))
    np.testing.assert_array_equal(
        model.core.encoder1.conv0.Dense_0.weight.detach().numpy().T,
        pre["params"]["core"]["encoder1"]["conv0"]["Dense_0"]["kernel"])
    evaluated = cli.main(["eval", "--dataset", "BACE", "--checkpoint", ft,
                          "--split", "test"] + SMALL)
    assert abs(evaluated["test"] - run["last"]["history"][-1][2]) <= 1e-6


def test_adapt_verb_adopts_the_imported_depth(stand_in, tmp_path, capsys):
    info = cli.main(["adapt", "--pretrained", stand_in, "--out",
                     str(tmp_path / "ad.msgpack")] + SMALL)
    assert "overriding --num_layers 4" in capsys.readouterr().out
    assert np.isfinite(info["best_loss"])
    assert sum(k.startswith("core.encoder1.conv") and k.endswith(
        "Dense_0.weight") for k in from_jax_variables(
            info["best_variables"])) == CONVS
