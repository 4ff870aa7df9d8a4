"""The frozen molecule generator, the capacities and the batch plan agree
with the port's, and the reference's ego-nets with the port's."""

import numpy as np
import pytest

from port_bench import molecules as mol
from scgib_tpu_torch.data import loader
from scgib_tpu_torch.data.synthetic import random_molecule
from scgib_tpu_torch.graph.batching import GraphData
from scgib_tpu_torch.graph.egonet import extract_egonets


def _port_dataset(mols, k=1):
    return loader.GraphDataset([GraphData(m.senders, m.receivers, m.feat,
                                          m.label) for m in mols], k=k)


@pytest.mark.parametrize("atoms,tasks", [((6, 22), None), ((20, 48), 1)])
def test_generator_is_the_ports(atoms, tasks):
    seed = 2 ** 31 + 17
    ours = mol.corpus(seed, 40, atoms, num_tasks=tasks)
    rng = np.random.default_rng(seed)
    for m in ours:
        p = random_molecule(rng, atoms[0], atoms[1], num_tasks=tasks)
        np.testing.assert_array_equal(m.senders, p.senders)
        np.testing.assert_array_equal(m.receivers, p.receivers)
        np.testing.assert_array_equal(m.feat, p.node_feat)
        if tasks:
            np.testing.assert_array_equal(m.label, p.label)


def test_capacities_and_plan_are_the_ports():
    mols = mol.corpus(5, 300, (6, 22))
    ds = _port_dataset(mols)
    table = mol.sizes(mols, 1)
    caps = mol.capacities(table, 32)
    assert caps.__dict__ == loader.plan_capacities(ds, 32).__dict__
    tight = mol.Caps(caps.nodes // 2, caps.edges, caps.graphs,
                     caps.sub_nodes, caps.sub_edges)
    port_tight = loader.Capacities(**tight.__dict__)
    for shuffle, seed in ((True, 3), (False, 0), (True, 2 ** 33 + 1)):
        for c, pc in ((caps, loader.Capacities(**caps.__dict__)),
                      (tight, port_tight)):
            ours = mol.plan(table, 32, c, shuffle, seed)
            theirs = loader.plan_batches(ds, 32, pc, shuffle, seed)
            assert len(ours) == len(theirs)
            for a, b in zip(ours, theirs):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [1, 2])
def test_ego_nets_are_the_ports(k):
    for m in mol.corpus(9, 20, (6, 22)):
        ego = extract_egonets(GraphData(m.senders, m.receivers, m.feat), k)
        ours = mol.ego_nets(m, k)
        assert mol.sizes([m], k)[0, 2] == sum(len(a) for a, _ in ours)
        for (members, (es, er)), nl, (pe, pr) in zip(
                ours, ego.node_lists, ego.edge_lists):
            np.testing.assert_array_equal(members, nl)
            assert sorted(zip(es.tolist(), er.tolist())) == sorted(
                zip(pe.tolist(), pr.tolist()))
