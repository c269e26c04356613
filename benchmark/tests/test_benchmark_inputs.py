"""The benchmark's inputs and its reference's batching are its own copies:
they hold to what the program does at the seed this copy was taken from."""
import numpy as np
import pytest

from harness.molecules import make_molecules
from reference import batches


@pytest.fixture(scope="module")
def graphs():
    return make_molecules(300, 2 ** 31 + 5, 8)


def test_molecules_are_the_ports(graphs):
    from signnet_basisnet_tpu_torch.data import add_lap_pe, synthetic_zinc
    port = synthetic_zinc(300, 0, 0, seed=2 ** 31 + 5)["train"]
    add_lap_pe(port, 8)
    for a, b in zip(graphs, port):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("tile", [256, None])
def test_batches_are_the_ports(graphs, tile):
    from signnet_basisnet_tpu_torch.data import choose_budgets, pack_batches
    slots = batches.budgets(graphs, 32, 1.1, 8, tile)
    assert slots == choose_budgets(graphs, 32, slack=1.1, align=8, tile=tile)
    groups = batches.epoch_batches(graphs, slots, 77, tile, 4)
    packed = pack_batches(graphs, *slots, shuffle=True, seed=77, k=8,
                          tile=tile)[:4]
    assert len(groups) == 4
    for idx, arrays in zip(groups, packed):
        real = int(arrays["graph_mask"].sum())
        assert real == len(idx)
        np.testing.assert_array_equal(
            arrays["y"][:real, 0], np.array([graphs[i]["y"][0] for i in idx]))
