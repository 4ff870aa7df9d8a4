"""Process-group set-up (``parallel/multihost.py``), as
``tests/test_multihost.py`` holds the JAX package's: a no-op for one
process; with ``torchrun``'s variables, two real processes join a gloo
group, keep their own batches (``global_batch_from_local``) and run the DP
pretraining step over ``global_data_mesh``, whose losses must be the
single-process step's on the union batch (rtol 1e-5 and, for the
reconstruction, 1e-4, ``tests/test_parallel.py``'s).  Asked for CUDA where
there is none, it raises rather than carry on over gloo.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from scgib_tpu_torch.models.scgib import PretrainModel
from scgib_tpu_torch.parallel.multihost import initialize_distributed
from scgib_tpu_torch.train.trainer import adam_l2, make_pretrain_step

import dp_cases as C

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these steps are many tiny ops, which crawl on
    several threads when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_initialize_distributed_is_a_noop_for_one_process(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is None
    assert initialize_distributed(world_size=1, device="cpu") is None
    assert not dist.is_initialized()


def test_initialize_distributed_refuses_gloo_in_place_of_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initialize_distributed("tcp://127.0.0.1:1", world_size=2, rank=0)
    assert not dist.is_initialized()


def test_two_processes_from_the_env_match_single_device(tmp_path):
    weights = C.start_weights()
    torch.save(weights, tmp_path / "weights.pt")
    ranks = C.spawn("multihost", 2, tmp_path)
    assert [r["world"] for r in ranks] == [2, 2]
    assert [r["device"] for r in ranks] == ["cpu", "cpu"]
    assert ranks[0]["losses"] == ranks[1]["losses"]

    ds = C.dataset()
    g, sub = (b.to("cpu") for b in C.union(ds, C.shard_caps(ds), (4, 4)))
    model = PretrainModel(C.IN, **C.PRETRAIN)
    model.load_state_dict(weights["pretrain"])
    want = make_pretrain_step(model, adam_l2(model, C.LR, C.WD))(g, sub)
    for a, b, rtol in zip(ranks[0]["losses"], want, (1e-5, 1e-5, 1e-4)):
        np.testing.assert_allclose(a, float(b), rtol=rtol)
