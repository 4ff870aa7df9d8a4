"""Peptide-shaped molecules: LRGB Peptides-func's topology, from a seed.

Peptides-func (Dwivedi et al., Long Range Graph Benchmark, arXiv:2206.08164)
holds the heavy-atom graphs of peptides: a backbone of residues
(N - CA - C(=O), each C bonded to the next residue's N, an OXT on the last
C) with each residue's side chain on its CA.  ``peptide`` draws residues
uniformly from the 20 standard amino acids, whose side chains below are
their heavy atoms and bonds (proline's ring closes on its own N; the rings
of Phe, Tyr, Trp and His close inside the side chain), until the molecule
reaches its drawn atom count.  Every atom has at most 4 neighbours
and every ring closes between atoms at most 5 bonds apart, so a 3-hop
ego-net holds at most 1 + 4 + 12 + 36 = 53 atoms, against the hubs and
random chords of ``molecules.random_molecule``.  Features are 9 integers in
[0, 10), as there.

The benchmark's traffic draws from ``molecules.corpus``; ``drivers.Data``
would have to pick this generator by a traffic key for a cell to use it.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .molecules import Molecule, _symmetrize

# side chains: atom names after CA, bonds among them and to "CA" or "N"
SIDE_CHAINS = {
    "G": ((), ()),
    "A": (("CB",), (("CA", "CB"),)),
    "S": (("CB", "OG"), (("CA", "CB"), ("CB", "OG"))),
    "C": (("CB", "SG"), (("CA", "CB"), ("CB", "SG"))),
    "V": (("CB", "CG1", "CG2"),
          (("CA", "CB"), ("CB", "CG1"), ("CB", "CG2"))),
    "T": (("CB", "OG1", "CG2"),
          (("CA", "CB"), ("CB", "OG1"), ("CB", "CG2"))),
    "P": (("CB", "CG", "CD"),
          (("CA", "CB"), ("CB", "CG"), ("CG", "CD"), ("CD", "N"))),
    "D": (("CB", "CG", "OD1", "OD2"),
          (("CA", "CB"), ("CB", "CG"), ("CG", "OD1"), ("CG", "OD2"))),
    "N": (("CB", "CG", "OD1", "ND2"),
          (("CA", "CB"), ("CB", "CG"), ("CG", "OD1"), ("CG", "ND2"))),
    "L": (("CB", "CG", "CD1", "CD2"),
          (("CA", "CB"), ("CB", "CG"), ("CG", "CD1"), ("CG", "CD2"))),
    "I": (("CB", "CG1", "CG2", "CD1"),
          (("CA", "CB"), ("CB", "CG1"), ("CB", "CG2"), ("CG1", "CD1"))),
    "M": (("CB", "CG", "SD", "CE"),
          (("CA", "CB"), ("CB", "CG"), ("CG", "SD"), ("SD", "CE"))),
    "E": (("CB", "CG", "CD", "OE1", "OE2"),
          (("CA", "CB"), ("CB", "CG"), ("CG", "CD"), ("CD", "OE1"),
           ("CD", "OE2"))),
    "Q": (("CB", "CG", "CD", "OE1", "NE2"),
          (("CA", "CB"), ("CB", "CG"), ("CG", "CD"), ("CD", "OE1"),
           ("CD", "NE2"))),
    "K": (("CB", "CG", "CD", "CE", "NZ"),
          (("CA", "CB"), ("CB", "CG"), ("CG", "CD"), ("CD", "CE"),
           ("CE", "NZ"))),
    "H": (("CB", "CG", "ND1", "CD2", "CE1", "NE2"),
          (("CA", "CB"), ("CB", "CG"), ("CG", "ND1"), ("CG", "CD2"),
           ("ND1", "CE1"), ("CD2", "NE2"), ("CE1", "NE2"))),
    "F": (("CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ"),
          (("CA", "CB"), ("CB", "CG"), ("CG", "CD1"), ("CG", "CD2"),
           ("CD1", "CE1"), ("CD2", "CE2"), ("CE1", "CZ"), ("CE2", "CZ"))),
    "R": (("CB", "CG", "CD", "NE", "CZ", "NH1", "NH2"),
          (("CA", "CB"), ("CB", "CG"), ("CG", "CD"), ("CD", "NE"),
           ("NE", "CZ"), ("CZ", "NH1"), ("CZ", "NH2"))),
    "Y": (("CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ", "OH"),
          (("CA", "CB"), ("CB", "CG"), ("CG", "CD1"), ("CG", "CD2"),
           ("CD1", "CE1"), ("CD2", "CE2"), ("CE1", "CZ"), ("CE2", "CZ"),
           ("CZ", "OH"))),
    "W": (("CB", "CG", "CD1", "CD2", "NE1", "CE2", "CE3", "CZ2", "CZ3",
           "CH2"),
          (("CA", "CB"), ("CB", "CG"), ("CG", "CD1"), ("CG", "CD2"),
           ("CD1", "NE1"), ("NE1", "CE2"), ("CD2", "CE2"), ("CD2", "CE3"),
           ("CE2", "CZ2"), ("CE3", "CZ3"), ("CZ2", "CH2"),
           ("CZ3", "CH2"))),
}
RESIDUES = tuple(sorted(SIDE_CHAINS))


def peptide(rng: np.random.Generator, min_atoms: int, max_atoms: int,
            feat_dim: int = 9) -> Molecule:
    """Residues drawn uniformly until the molecule reaches an atom count
    drawn uniformly from ``min_atoms`` to ``max_atoms``, then the OXT; a
    residue that would take it past ``max_atoms`` ends it unadded."""
    target = int(rng.integers(min_atoms, max_atoms + 1))
    s: List[int] = []
    r: List[int] = []
    n, prev_c = 0, -1
    while n + 1 < target:
        names, bonds = SIDE_CHAINS[RESIDUES[int(rng.integers(0, 20))]]
        if n + 4 + len(names) + 1 > max_atoms:
            break
        at = {name: n + i for i, name in
              enumerate(("N", "CA", "C", "O") + names)}
        for a, b in (("N", "CA"), ("CA", "C"), ("C", "O")) + bonds:
            s.append(at[a])
            r.append(at[b])
        if prev_c >= 0:
            s.append(prev_c)
            r.append(at["N"])
        prev_c, n = at["C"], n + len(at)
    s.append(prev_c)                     # the C terminus's OXT
    r.append(n)
    n += 1
    senders, receivers = _symmetrize(np.asarray(s), np.asarray(r))
    feat = rng.integers(0, 10, size=(n, feat_dim)).astype(np.float32)
    return Molecule(senders, receivers, feat)


def corpus(seed: int, count: int, atoms: Sequence[int]) -> List[Molecule]:
    """``count`` peptides of ``atoms[0]`` to ``atoms[1]`` atoms (a range
    at least 15 wide) from a generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    return [peptide(rng, atoms[0], atoms[1]) for _ in range(count)]
