"""The port's host data path and segment ops against the JAX package.

Same seeds, same graphs: the port's numpy packer must give the JAX packer's
arrays bit for bit (tile ranges and the padding-graph slot included), and
its torch segment ops must match the JAX ones to float32 rounding.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from signnet_basisnet_tpu import spectral as jspec
from signnet_basisnet_tpu.data import batcher as jbatcher
from signnet_basisnet_tpu.data import zinc as jzinc
from signnet_basisnet_tpu.graph import batch_np as jbatch_np
from signnet_basisnet_tpu.graph import segment as jseg

from signnet_basisnet_tpu_torch import spectral as tspec
from signnet_basisnet_tpu_torch.data import batcher as tbatcher
from signnet_basisnet_tpu_torch.data import zinc as tzinc
from signnet_basisnet_tpu_torch.graph import batch_np as tbatch_np
from signnet_basisnet_tpu_torch.graph import from_arrays
from signnet_basisnet_tpu_torch.graph import segment as tseg


def _graphs(n=12, seed=0, k=4):
    gs = tzinc.synthetic_zinc(n, 0, 0, seed=seed)["train"]
    tzinc.add_lap_pe(gs, k)
    return gs


def _assert_same_arrays(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        assert x.dtype == y.dtype, key
        assert x.shape == y.shape, key
        np.testing.assert_array_equal(x, y, err_msg=key)


def test_synthetic_zinc_same_graphs():
    a = tzinc.synthetic_zinc(20, 5, 5, seed=3)
    b = jzinc.synthetic_zinc(20, 5, 5, seed=3)
    for split in ("train", "val", "test"):
        assert len(a[split]) == len(b[split])
        for ga, gb in zip(a[split], b[split]):
            _assert_same_arrays(ga, gb)


def test_lap_pe_same_as_jax():
    gs = tzinc.synthetic_zinc(6, 0, 0, seed=1)["train"]
    for g in gs:
        n = len(g["node_feat"])
        va, Va = tspec.lap_pe_np(g["senders"], g["receivers"], n, 8)
        vb, Vb = jspec.lap_pe_np(g["senders"], g["receivers"], n, 8)
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(Va, Vb)


@pytest.mark.parametrize("tile", [None, 64])
def test_choose_budgets_same_as_jax(tile):
    gs = _graphs()
    assert (tbatcher.choose_budgets(gs, 8, tile=tile)
            == jbatcher.choose_budgets(gs, 8, tile=tile))


@pytest.mark.parametrize("tile,k", [(None, None), (None, 4), (64, 4),
                                    (64, 6)])
def test_batch_np_bit_for_bit(tile, k):
    gs = _graphs(10)
    nb, eb, gc = jbatcher.choose_budgets(gs, len(gs), tile=tile)
    a = tbatch_np(gs, nb, eb, gc, k=k, tile=tile)
    b = jbatch_np(gs, nb, eb, gc, k=k, tile=tile)
    _assert_same_arrays(a, b)
    if tile is not None:
        assert "tile_starts" in a and "tile_ends" in a
    # the last graph slot is the padding graph
    assert a["graph_mask"][-1] == 0 and a["n_node"][-1] == 0


@pytest.mark.parametrize("shuffle,tile", [(False, None), (True, None),
                                          (False, 64), (True, 64)])
def test_pack_batches_bit_for_bit(shuffle, tile):
    gs = _graphs(40, seed=2)
    nb, eb, gc = jbatcher.choose_budgets(gs, 8, tile=tile)
    a = tbatcher.pack_batches(gs, nb, eb, gc, shuffle=shuffle, seed=5, k=4,
                              tile=tile)
    b = jbatcher.pack_batches(gs, nb, eb, gc, shuffle=shuffle, seed=5, k=4,
                              tile=tile)
    assert len(a) == len(b) > 1
    for x, y in zip(a, b):
        _assert_same_arrays(x, y)


def test_from_arrays_and_prefetch_iterator():
    gs = _graphs(30, seed=4)
    nb, eb, gc = tbatcher.choose_budgets(gs, 8, tile=64)
    arrays = tbatcher.pack_batches(gs, nb, eb, gc, k=4, tile=64)
    got = list(tbatcher.iterate_graphbatches(gs, nb, eb, gc, k=4, tile=64))
    assert len(got) == len(arrays)
    for arr, gb in zip(arrays, got):
        assert gb.num_nodes == nb and gb.num_edges == eb
        assert gb.num_graphs == gc
        for key in ("senders", "receivers", "node_mask", "eigvecs"):
            np.testing.assert_array_equal(getattr(gb, key).numpy(), arr[key])
        for key in ("tile_starts", "tile_ends", "node_offset"):
            np.testing.assert_array_equal(gb.extras[key].numpy(), arr[key])
        # the CSR views the SpMM kernel walks: row n's edges
        order = gb.extras["src_order"].numpy()
        dst_ptr = gb.extras["dst_ptr"].numpy()
        src_ptr = gb.extras["src_ptr"].numpy()
        assert (np.diff(arr["senders"][order]) >= 0).all()
        for n in range(0, nb, 7):
            np.testing.assert_array_equal(
                np.nonzero(arr["receivers"] == n)[0],
                np.arange(dst_ptr[n], dst_ptr[n + 1]))
            np.testing.assert_array_equal(
                np.sort(order[src_ptr[n]:src_ptr[n + 1]]),
                np.nonzero(arr["senders"] == n)[0])
        np.testing.assert_array_equal(
            dst_ptr, np.searchsorted(arr["receivers"], np.arange(nb + 1)))
        np.testing.assert_array_equal(
            order, np.argsort(arr["senders"], kind="stable"))
    half = got[0].cast_floats(torch.bfloat16)
    assert half.node_mask.dtype == torch.bfloat16
    assert half.senders.dtype == torch.int32


def _seg_problem(seed=0, n=50, s=7, d=5):
    r = np.random.default_rng(seed)
    data = r.normal(size=(n, d)).astype(np.float32)
    ids = np.sort(r.integers(0, s - 1, n)).astype(np.int32)  # last empty
    mask = (r.random(n) > 0.3).astype(np.float32)
    return data, ids, mask, s


@pytest.mark.parametrize("op", ["sum", "mean", "mean_w", "max", "max_mask"])
def test_segment_ops_match_jax(op):
    data, ids, mask, s = _seg_problem()
    td, ti, tm = map(torch.from_numpy, (data, ids, mask))
    jd, ji, jm = map(jnp.asarray, (data, ids, mask))
    if op == "sum":
        a, b = tseg.segment_sum(td, ti, s), jseg.segment_sum(jd, ji, s)
    elif op == "mean":
        a, b = tseg.segment_mean(td, ti, s), jseg.segment_mean(jd, ji, s)
    elif op == "mean_w":
        a = tseg.segment_mean(td, ti, s, weights=tm)
        b = jseg.segment_mean(jd, ji, s, weights=jm)
    elif op == "max":
        a, b = tseg.segment_max(td, ti, s), jseg.segment_max(jd, ji, s)
    else:
        a = tseg.segment_max(td, ti, s, mask=tm)
        b = jseg.segment_max(jd, ji, s, mask=jm)
    # float32 sums in a different order: 1e-6
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    assert np.isfinite(a.numpy()).all()


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_pool_nodes_match_jax(reduce):
    gs = _graphs(8)
    nb, eb, gc = tbatcher.choose_budgets(gs, len(gs))
    arr = tbatch_np(gs, nb, eb, gc)
    gb = from_arrays(arr)
    x = np.random.default_rng(1).normal(size=(nb, 6)).astype(np.float32)
    a = tseg.pool_nodes(torch.from_numpy(x), gb.graph_id, gc,
                        node_mask=gb.node_mask, reduce=reduce)
    b = jseg.pool_nodes(jnp.asarray(x), jnp.asarray(arr["graph_id"]), gc,
                        node_mask=jnp.asarray(arr["node_mask"]),
                        reduce=reduce)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                               atol=1e-6)
