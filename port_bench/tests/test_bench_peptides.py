"""The peptide-shaped generator: residues of the 20 amino acids, at most 4
neighbours an atom, small 3-hop ego-nets, LRGB's long diameters; and the
bands the port's packer gives such a batch: 512 for the molecules, 256 for
their ego-nets, both banded."""

import collections

import numpy as np

from port_bench import molecules as mol
from port_bench import peptides
from scgib_tpu_torch.data import loader
from scgib_tpu_torch.graph.batching import GraphData

SEED, ATOMS = 2 ** 31 + 23, (120, 182)


def _eccentricity(m, src):
    adj = collections.defaultdict(list)
    for a, b in zip(m.senders, m.receivers):
        adj[a].append(b)
    dist = {src: 0}
    queue = collections.deque([src])
    while queue:
        u = queue.popleft()
        for v in adj[u]:
            if v not in dist:
                dist[v] = dist[u] + 1
                queue.append(v)
    assert len(dist) == m.num_nodes            # one component
    return max(dist.values())


def test_side_chains_are_the_amino_acids():
    heavy = {"G": 0, "A": 1, "S": 2, "C": 2, "V": 3, "T": 3, "P": 3,
             "D": 4, "N": 4, "L": 4, "I": 4, "M": 4, "E": 5, "Q": 5,
             "K": 5, "H": 6, "F": 7, "R": 7, "Y": 8, "W": 10}
    rings = {"P": 1, "H": 1, "F": 1, "Y": 1, "W": 2}
    assert {a: len(n) for a, (n, _) in peptides.SIDE_CHAINS.items()} == heavy
    for a, (names, bonds) in peptides.SIDE_CHAINS.items():
        assert {x for b in bonds for x in b} <= set(names) | {"CA", "N"}
        # a tree on CA and the side chain, plus its rings
        assert len(bonds) == len(names) + rings.get(a, 0), a


def test_peptides_have_lrgbs_shape():
    mols = peptides.corpus(SEED, 48, ATOMS)
    table = mol.sizes(mols, 3)
    assert ATOMS[0] <= table[:, 0].min() and table[:, 0].max() <= ATOMS[1]
    for m in mols:
        assert np.bincount(m.senders).max() <= 4
        # the backbone: N of residue 0 to the OXT, ~3 bonds a residue
        assert _eccentricity(m, 0) >= m.num_nodes // 5
    # 3-hop ego-nets: at most 1 + 4 + 12 + 36 atoms, LRGB-like edge counts
    # (Peptides-func: 150.9 atoms, 307.3 directed edges)
    assert max(int(mol._reach(m, 3).sum(1).max()) for m in mols) <= 53
    assert 1.9 < table[:, 1].sum() / table[:, 0].sum() < 2.2
    assert table[:, 2].sum() / table[:, 0].sum() < 12


def test_the_ports_bands_for_a_batch_of_peptides():
    mols = peptides.corpus(SEED, 8, ATOMS)
    ds = loader.GraphDataset([GraphData(m.senders, m.receivers, m.feat)
                              for m in mols], k=3)
    caps = loader.plan_capacities(ds, 8)
    g, sub = loader.pack_batch(ds, np.arange(8), caps, use_flat=True)
    assert (g.band_width, sub.band_width) == (512, 256)
    assert g.band_col_off is not None and sub.band_col_off is not None
