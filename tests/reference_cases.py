"""A stand-in for the reference's whole-module pickle
(``pre_training_v1_GIN_64_5_1.pt``, not in the repository), written with
torch alone: ``tests/test_torch_reference_import.py`` and ``chip_smoke.py``
import it.

A throwaway module registered in ``sys.modules`` defines ``nn.Module``
classes under the reference's names: ``Mainmodel_continue`` wrapping the
previous stage at ``.model``, ``depth`` levels deep around a ``Mainmodel``;
each with ``Encoder1`` / ``Encoder2`` (``ginlayers.{i}.apply_func.mlp.{0,2}``
and ``batch_norms.{i}``), ``compressor.{0,1,3}``, ``attn_layer``,
``transfer_d`` and ``MLP.{0,2}``.  Weights are random from ``seed``; every
BatchNorm keeps its (0, 1) init but the depth-1 encoders' and
compressor's, so depth 1 is the only one that looks trained, as in the
shipped artifact.  The whole model is ``torch.save``d and the module
removed from ``sys.modules``, so a load must shell every one of its
classes."""

import sys
import types

import torch
from torch import nn

MODULE = "scgib_reference_stand_in"


def _classes(in_dim, hidden, d_transfer, convs):
    class ApplyNodeFunc(nn.Module):
        def __init__(self, d_in):
            super().__init__()
            self.mlp = nn.Sequential(nn.Linear(d_in, hidden), nn.ReLU(),
                                     nn.Linear(hidden, hidden))

    class GINConv(nn.Module):
        def __init__(self, d_in):
            super().__init__()
            self.apply_func = ApplyNodeFunc(d_in)

    class Encoder(nn.Module):
        def __init__(self):
            super().__init__()
            self.ginlayers = nn.ModuleList(
                GINConv(d_transfer if i == 0 else hidden)
                for i in range(convs))
            self.batch_norms = nn.ModuleList(nn.BatchNorm1d(hidden)
                                             for _ in range(convs))

    class Mainmodel(nn.Module):
        def __init__(self):
            super().__init__()
            self.transfer_d = nn.Linear(in_dim, d_transfer, bias=False)
            self.Encoder1 = Encoder()
            self.Encoder2 = Encoder()
            self.compressor = nn.Sequential(
                nn.Linear(hidden, hidden), nn.BatchNorm1d(hidden), nn.ReLU(),
                nn.Linear(hidden, 1))
            self.attn_layer = nn.Linear(2 * hidden, 1)
            self.MLP = nn.Sequential(nn.Linear(2 * hidden, hidden),
                                     nn.ReLU(), nn.Linear(hidden, hidden))

    class Mainmodel_continue(Mainmodel):
        def __init__(self, model):
            super().__init__()
            self.model = model

    return ApplyNodeFunc, GINConv, Encoder, Mainmodel, Mainmodel_continue


def write_stand_in(path, in_dim=9, hidden=64, d_transfer=32, convs=5,
                   depth=3, seed=0):
    """Write the stand-in pickle to ``path``; returns ``path``."""
    mod = types.ModuleType(MODULE)
    for cls in _classes(in_dim, hidden, d_transfer, convs):
        cls.__module__ = MODULE
        cls.__qualname__ = cls.__name__
        setattr(mod, cls.__name__, cls)
    sys.modules[MODULE] = mod
    try:
        torch.manual_seed(seed)
        model = mod.Mainmodel()
        for _ in range(depth):
            model = mod.Mainmodel_continue(model)
        trained = model.model
        with torch.no_grad():
            for bn in [*trained.Encoder1.batch_norms,
                       *trained.Encoder2.batch_norms, trained.compressor[1]]:
                bn.running_mean.uniform_(-0.5, 0.5)
                bn.running_var.uniform_(0.5, 2.0)
                bn.weight.uniform_(0.5, 1.5)
                bn.bias.uniform_(-0.2, 0.2)
        torch.save(model, path)
    finally:
        del sys.modules[MODULE]
    return path
