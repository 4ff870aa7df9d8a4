"""The fused GIN backward's row tiles (``ops/kernels/banded.py``), on the CPU.

``gin_fused_bwd`` runs each block's row tiles as a pipeline: producer warps
gather tile k into one stage of a two-stage ring while consumer warps run
the products of tile k - 1 from the other.  The kernel runs only on the
card (``test_torch_cuda.py``); here: the launch plan's width rule through
the wrapper's mirror of it (rows a tile, and the shared memory the two
stages take, inside a block's 227 KB at every width up to 128); the row
tiles and the overlapped ones a launch counts, at the benchmark's PCQM and
Peptides shapes; and a pretraining step's tally carrying them, with the
launch played on the CPU.  About 5 s in all; this file imports neither JAX
nor the JAX package."""

import functools
import itertools

import pytest
import torch

from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph.batching import pack_graphs, pack_subgraphs
from scgib_tpu_torch.graph.egonet import extract_egonets
from scgib_tpu_torch.models.scgib import PretrainModel
from scgib_tpu_torch.ops.kernels import banded as kb
from scgib_tpu_torch.train import trainer
from scgib_tpu_torch.utils import counters, profiling

SMEM_BYTES = 232_448          # shared memory a block may take on an H100
SMS = 132                     # the grid: one block an SM


@pytest.mark.parametrize("widths,rows", [
    ((9, 64, 64), 64), ((32, 64, 64), 64), ((64, 64, 64), 64),
    ((64, 64, 32), 64), ((65, 64, 64), 16), ((64, 128, 64), 16),
    ((64, 64, 96), 16), ((128, 128, 128), 16)])
def test_the_width_rule_picks_the_rows_a_tile(widths, rows):
    """Row tiles of 64 where every width is at most 64, of 16 above."""
    assert kb.bwd_tile_rows(*widths) == rows


def test_two_stages_fit_a_block_at_every_width():
    """At every width up to 128 the plan's tile keeps two stages of z0 and
    g beside the weights inside a block's shared memory, and at 128 two
    stages of 32-row tiles would not: the rule's reason."""
    widths = (1, 8, 9, 16, 17, 31, 32, 33, 63, 64, 65, 96, 127, 128)
    for din, hid, dout in itertools.product(widths, repeat=3):
        assert kb.bwd_smem_bytes(din, hid, dout) <= SMEM_BYTES
    assert kb.bwd_smem_bytes(64, 64, 64) == 139_520
    assert kb.bwd_smem_bytes(128, 128, 128) == 186_368
    weights = 4 * (128 * 132 * 2 + 128)
    assert weights + 4 * 32 * 6 * 132 > SMEM_BYTES


@pytest.mark.parametrize("n,din,tiles,overlapped", [
    (6656, 64, 104, 0),           # the PCQM cell's ego-nets: 104 blocks
    (9728, 64, 152, 20),          # chip_smoke's ego-nets: 1.15 tiles a block
    (3072, 32, 48, 0),            # chip_smoke's atoms: one tile a block
    (403712, 64, 6308, 6176),     # Peptides ego-nets: ~48 tiles a block
    (22016, 32, 344, 212)])       # Peptides atoms: ~2.6 tiles a block
def test_a_launch_counts_its_tiles(n, din, tiles, overlapped):
    """Every tile but each block's first had a tile before it in its
    block, whose products its gather ran under."""
    assert kb.bwd_tiles(n, din, 64, 64, min(SMS, n // 64)) == (tiles,
                                                               overlapped)


@pytest.mark.parametrize("rows,share", [((2304, 6656), 0.0),
                                        ((3072, 9728), 0.10),
                                        ((22016, 403712), 0.96)])
def test_a_replay_overlaps_as_predicted(rows, share):
    """A GIN pretraining step's 8 launches (4 convs on the atoms, 4 on the
    ego-nets; the first conv takes d_transfer 32): none of the PCQM cell's
    560 tiles overlapped (no launch has more tiles than blocks), ~10% of
    the 800 of chip_smoke's benchmark batch (10-30 atoms), ~96% of the
    Peptides cell's ~26,600."""
    counts = [kb.bwd_tiles(n, din, 64, 64, min(SMS, n // 64))
              for n in rows for din in (32, 64, 64, 64)]
    tiles, overlapped = map(sum, zip(*counts))
    assert abs(overlapped / tiles - share) < 0.01


@functools.lru_cache(maxsize=None)
def _batch():
    graphs = random_dataset(16, seed=5, min_nodes=8, max_nodes=28)
    egos = [extract_egonets(g, 1) for g in graphs]
    return (pack_graphs(graphs, 512, 2048, 16).to("cpu"),
            pack_subgraphs(graphs, egos, 1536, 4096,
                           num_centers=512).to("cpu"))


def test_a_steps_tally_carries_the_backward_tiles(monkeypatch):
    """The card's launch played on the CPU (the plain version, counted as
    a grid of 4 blocks would be): one pretraining step ticks
    ``gin_bwd.tiles`` and ``gin_bwd.overlapped`` for its 8 backward convs,
    and a replay's ``scgib.step.tally`` arguments carry both."""
    plain = kb.gin_bwd

    def launched(blocks, col_off, h, g, w1, b1, w2):
        kb.count_bwd_tiles(h.shape[0], h.shape[1], w1.shape[1],
                           w2.shape[1], 4)
        return plain(blocks, col_off, h, g, w1, b1, w2)
    g, sub = _batch()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        model = PretrainModel(9, hidden=16, d_transfer=8,
                              deterministic=True)
    before = counters.snapshot()
    monkeypatch.setattr(kb, "gin_bwd", launched)
    trainer.pretrain_step_eager(model, trainer.adam_l2(model, 1e-4), g, sub,
                                torch.Generator().manual_seed(1))
    monkeypatch.undo()
    after = counters.snapshot()
    added = {k: after.get(k, 0) - before.get(k, 0)
             for k in set(after) | set(before)}
    added = {k: v for k, v in added.items() if v}
    want = [kb.bwd_tiles(n, 8 if i == 0 else 16, 16, 16, 4)
            for n in (g.num_nodes, sub.num_nodes) for i in range(4)]
    tiles, overlapped = map(sum, zip(*want))
    assert added[("gin_bwd", "tiles")] == tiles == 4 * (512 + 1536) // 64
    assert added[("gin_bwd", "overlapped")] == overlapped == tiles - 8 * 4
    counts = trainer._replay_counts((None, (g, sub), torch.zeros(()),
                                     added))
    tally = counts[profiling.STEP_PARTS[3]]
    assert tally["gin_bwd.tiles"] == tiles
    assert tally["gin_bwd.overlapped"] == overlapped
    counters.add(added, -1)
    assert counters.snapshot() == before
