"""The port's nn blocks and GINConv against the JAX blocks, bridged params.

Each test draws its inputs with numpy from a seed, initialises the flax
block, loads its variables into the port's block through bridge.py, and
compares outputs (and BN running statistics) in float32.  Tolerances are
float32 reduction-order noise: 1e-5 unless stated.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from signnet_basisnet_tpu import models as JM
from signnet_basisnet_tpu import nn as jnn
from signnet_basisnet_tpu.data import add_lap_pe as jadd_lap_pe
from signnet_basisnet_tpu.graph import from_arrays as jfrom_arrays
from signnet_basisnet_tpu.graph import segment as jseg

from signnet_basisnet_tpu_torch import nn as tnn
from signnet_basisnet_tpu_torch.bridge import load_flax_variables, torch_name
from signnet_basisnet_tpu_torch.data import (choose_budgets, pack_batches,
                                             synthetic_zinc)
from signnet_basisnet_tpu_torch.graph import from_arrays
from signnet_basisnet_tpu_torch.graph import segment as tseg
from signnet_basisnet_tpu_torch.models import GINConv, node_mask_like

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _run_flax(module, variables, *args, training=True, **kw):
    out, upd = module.apply(variables, *args, training=training,
                            mutable=["batch_stats"], **kw)
    return np.asarray(out), _np(upd.get("batch_stats", {}))


def _check_stats(tmod, stats):
    for path, a in _flatten(stats).items():
        b = dict(tmod.named_buffers())[torch_name(path)]
        np.testing.assert_allclose(b.numpy(), a, **TOL)


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@pytest.mark.parametrize("shape,masked,training", [
    ((40, 6), True, True), ((40, 6), False, True), ((20, 3, 6), True, True),
    ((40, 6), True, False)])
def test_masked_batchnorm_matches_jax(shape, masked, training):
    r = np.random.default_rng(0)
    x = r.normal(size=shape).astype(np.float32) * 3 + 1
    mask = (r.random(shape[:-1]) > 0.25).astype(np.float32)
    jbn = jnn.MaskedBatchNorm(6)
    var = _np(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    # non-trivial affine and running stats
    var["params"]["scale"] = r.normal(size=6).astype(np.float32)
    var["params"]["bias"] = r.normal(size=6).astype(np.float32)
    var["batch_stats"]["mean"] = r.normal(size=6).astype(np.float32)
    var["batch_stats"]["var"] = r.random(6).astype(np.float32) + 0.5
    tbn = tnn.MaskedBatchNorm(6)
    load_flax_variables(tbn, var)
    m = mask if masked else None
    a, stats = _run_flax(jbn, var, jnp.asarray(x), training=training,
                         mask=None if m is None else jnp.asarray(m))
    tbn.train(training)
    b = tbn(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(b.detach().numpy(), a, **TOL)
    if training:
        _check_stats(tbn, stats)
    if masked:
        assert (b.detach().numpy()[mask == 0] == 0).all()


@pytest.mark.parametrize("shape,num_layers", [((30, 5), 2), ((15, 4, 5), 3),
                                              ((30, 5), 1)])
def test_mlp_matches_jax(shape, num_layers):
    r = np.random.default_rng(1)
    x = r.normal(size=shape).astype(np.float32)
    mask = (r.random(shape[:-1]) > 0.2).astype(np.float32)
    jm = jnn.MLP(hidden=8, out=3, num_layers=num_layers, use_bn=True)
    var = _np(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    tm = tnn.MLP(5, 8, 3, num_layers=num_layers, use_bn=True)
    load_flax_variables(tm, var)
    a, stats = _run_flax(jm, var, jnp.asarray(x), mask=jnp.asarray(mask))
    b = tm(torch.from_numpy(x), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(b.detach().numpy(), a, **TOL)
    _check_stats(tm, stats)


def test_mlp_readout_matches_jax():
    x = np.random.default_rng(2).normal(size=(9, 16)).astype(np.float32)
    jm = jnn.MLPReadout(1)
    var = _np(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    tm = tnn.MLPReadout(16, 1)
    load_flax_variables(tm, var)
    a = np.asarray(jm.apply(var, jnp.asarray(x)))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), a,
                               **TOL)


def test_init_distributions():
    g = torch.Generator().manual_seed(0)
    lin, emb = tnn.Linear(400, 300), tnn.Embedding(500, 40)
    lin.reset_parameters(g)
    emb.reset_parameters(g)
    bound = 1 / np.sqrt(400)
    w = lin.weight.detach().numpy()
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.95 * bound
    assert abs(w.mean()) < 0.01 * bound * 10
    e = emb.weight.detach().numpy()
    assert abs(e.std() - 1) < 0.02 and abs(e.mean()) < 0.02


def _tiled_batch(seed=0, tile=64, k=4):
    gs = synthetic_zinc(10, 0, 0, seed=seed)["train"]
    jadd_lap_pe(gs, k)
    nb, eb, gc = choose_budgets(gs, len(gs), tile=tile)
    return pack_batches(gs, nb, eb, gc, k=k, tile=tile)[0]


@pytest.mark.parametrize("backend,feat_shape", [
    ("xla", (8,)), ("tile_dense", (8,)), ("tile_dense", (4, 8)),
    ("pallas_tile", (8,)), ("pallas_tile", (4, 8))])
def test_ginconv_matches_jax(backend, feat_shape):
    arrays = _tiled_batch()
    n = arrays["node_mask"].shape[0]
    x = np.random.default_rng(3).normal(size=(n,) + feat_shape)
    x = (x * arrays["node_mask"].reshape((n,) + (1,) * len(feat_shape))
         ).astype(np.float32)
    jgb, tgb = jfrom_arrays(arrays), from_arrays(arrays)
    jconv = JM.GINConv(jnn.MLP(hidden=8, out=6, num_layers=2, use_bn=True))
    var = _np(jconv.init(jax.random.PRNGKey(3), jgb, jnp.asarray(x)))
    tconv = GINConv(tnn.MLP(8, 8, 6, num_layers=2, use_bn=True))
    load_flax_variables(tconv.mlp, {
        "params": var["params"]["update_net"],
        "batch_stats": var["batch_stats"]["update_net"]})
    jseg.set_agg_backend(backend)
    tseg.set_agg_backend(backend)
    try:
        with pltpu.force_tpu_interpret_mode():
            a, _ = _run_flax(jconv, var, jgb, jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        b = tconv(tgb, xt)
        b.sum().backward()
    finally:
        jseg.set_agg_backend("xla")
        tseg.set_agg_backend("xla")
    np.testing.assert_allclose(b.detach().numpy(), a, **TOL)
    assert xt.grad is not None and torch.isfinite(xt.grad).all()


def test_node_mask_like_broadcasts():
    arrays = _tiled_batch()
    gb = from_arrays(arrays)
    m = node_mask_like(gb, torch.zeros(gb.num_nodes, 3, 5))
    assert m.shape == (gb.num_nodes, 3)
    np.testing.assert_array_equal(m[:, 2].numpy(), arrays["node_mask"])
