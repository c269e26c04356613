"""The full-graph Transformer (`TransformerNet(full_graph=True)`), its
transform (`data/transforms.py`: `make_full_graph` with `edge_real` and
GraphiT's `k_rw`), the per-edge extras `batch_np` carries, and
`MLPReadout2`, against the JAX package under bridged parameters.

On the full graph each attention layer mixes a real edge's score
(K . Q * E1) with a fake edge's (K2 . Q2 * E2) by `edge_real`, and
reweights by the learnt gamma; it never takes the K2/K3 path, on any
backend, as the JAX layer never takes its fused kernel there.  Neither
package's train_zinc runs it: the JAX one never builds full graphs, and
the port's refuses `model.full_graph` saying so
(tests/test_torch_train_step.py).

Tolerances, float32: the transform and the packer's arrays exactly (the
same numpy); a forward 1e-5; gradients 1e-4 relative plus 1e-6 of the
net's largest gradient (the LayerNorm biases straight before a BatchNorm
have an exact gradient of 0); BN statistics 1e-5.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from signnet_basisnet_tpu import models as JM
from signnet_basisnet_tpu.data import transforms as jtransforms
from signnet_basisnet_tpu.graph import batch_np as jbatch_np
from signnet_basisnet_tpu.graph import from_arrays as jfrom_arrays
from signnet_basisnet_tpu.nn.mlp import MLPReadout2 as JMLPReadout2

from signnet_basisnet_tpu_torch import models as TM
from signnet_basisnet_tpu_torch.bridge import load_flax_variables, torch_name
from signnet_basisnet_tpu_torch.data import make_full_graph, make_full_graphs
from signnet_basisnet_tpu_torch.graph import batch_np, from_arrays
from signnet_basisnet_tpu_torch.graph import segment as tseg
from signnet_basisnet_tpu_torch.models import conv as tconv
from signnet_basisnet_tpu_torch.nn import MLPReadout2
from signnet_basisnet_tpu_torch.nn.dropout import DropoutRNG
from signnet_basisnet_tpu_torch.nn.init import init_parameters

from test_torch_pe import _flat, _port_view, packed, small_graphs

NET = dict(hidden_dim=16, out_dim=16, n_layers=2, num_heads=4,
           layer_norm=True, pe_init="none", lap_method="none",
           full_graph=True)


def _full(n_graphs=6, adaptive=None, seed=3):
    gs = small_graphs(n_graphs, max_nodes=16, seed=seed)
    return make_full_graphs(gs, adaptive)


@pytest.mark.parametrize("adaptive", [None, (1, 0.5), ("half_num_nodes", 0.2),
                                      ("twice_num_nodes", 0.3)])
def test_make_full_graph_matches_jax(adaptive):
    """Every array of the complete graph equals JAX's: senders, receivers,
    the real edges' features, `edge_real`, and `k_rw` (JAX
    tests/test_gap_components.py:113); at p_steps 1, k_rw off the
    diagonal is gamma A_ij / sqrt(d_i d_j)."""
    for g in small_graphs(3, max_nodes=16, seed=1):
        a = make_full_graph(g, adaptive)
        b = jtransforms.make_full_graph(g, adaptive)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
        n = len(g["node_feat"])
        assert len(a["senders"]) == n * (n - 1)
        assert a["edge_real"].sum() == len(g["senders"])
        if adaptive is not None and adaptive[0] == 1:
            A = np.zeros((n, n))
            A[g["senders"], g["receivers"]] = 1.0
            deg = np.clip(A.sum(0), 1, None)
            got = np.zeros((n, n))
            got[a["senders"], a["receivers"]] = a["k_rw"]
            np.testing.assert_allclose(got, 0.5 * A / np.sqrt(
                np.outer(deg, deg)), atol=1e-6)


@pytest.mark.parametrize("tile", [None, 32])
def test_batch_np_carries_the_edge_extras_as_jax(tile):
    """`edge_real` and `k_rw` padded and in the receiver-sorted edge order,
    flat and tiled, equal to JAX's `batch_np`."""
    gs = _full(adaptive=("half_num_nodes", 0.2))
    nodes = 6 * 32 if tile else 128
    edges = sum(len(g["senders"]) for g in gs) + 37
    a = batch_np(gs, nodes, edges, 8, tile=tile)
    b = jbatch_np(gs, nodes, edges, 8, tile=tile)
    for k in ("edge_real", "k_rw", "senders", "receivers", "edge_feat"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["edge_real"].shape == (edges,)
    real = a["edge_mask"] > 0
    assert a["edge_real"][real].sum() == sum(g["edge_real"].sum()
                                             for g in gs)
    assert not a["edge_real"][~real].any()
    gb = from_arrays(a)
    assert gb.extras["edge_real"].dtype == torch.float32


def _full_net_pair(arrays, use_edge):
    net = dict(NET, edge_feat=use_edge)
    jgb = jfrom_arrays(arrays)
    jm = JM.gnn_model("Transformer", **net)
    variables = jax.tree.map(np.asarray, jm.init(
        {"params": jax.random.PRNGKey(0)}, jgb, None, training=False))
    tm = TM.gnn_model("Transformer", **net)
    load_flax_variables(tm, variables)
    return jm, variables, tm


@pytest.mark.parametrize("tile", [None, 32])
@pytest.mark.parametrize("use_edge", [True, False])
def test_full_graph_transformer_matches_jax(use_edge, tile):
    """A training forward of the full-graph net (BN on batch statistics):
    the scores, the gradient of every parameter (gamma, Q_2, K_2 and E_2
    included) and the BN statistics; with use_edge the real and fake
    edges take the two score maps (JAX tests/test_more_models.py:101)."""
    gs = _full()
    arrays = (packed(gs, None, tile=tile) if tile
              else batch_np(gs, 128, sum(len(g["senders"]) for g in gs)
                            + 20, 8))
    jgb, tgb = jfrom_arrays(arrays), from_arrays(arrays)
    assert "edge_real" in tgb.extras
    jm, variables, tm = _full_net_pair(arrays, use_edge)
    names = dict(tm.named_parameters())
    assert ("layer_0.attention.E_2.weight" in names) == use_edge
    assert names["layer_1.attention.gamma"].shape == ()
    c = np.random.default_rng(1).normal(size=len(arrays["graph_mask"])
                                        ).astype(np.float32)

    def loss(params):
        out, upd = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            jgb, None, training=True,
                            mutable=["batch_stats"])
        return (out * c).sum(), (out, upd)

    (_, (jout, upd)), jg = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    tout = tm(tgb)
    (tout * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    grads = _flat(jg)
    top = max(np.abs(g).max() for g in grads.values())
    for path, g in grads.items():
        name = torch_name(path)
        # without edge features the bond embedding feeds nothing: no
        # gradient in the port, zeros in JAX
        got = (torch.zeros_like(names[name]) if names[name].grad is None
               else names[name].grad)
        np.testing.assert_allclose(got.numpy(), _port_view(path, g),
                                   rtol=1e-4,
                                   atol=max(1e-6 * top, 1e-7), err_msg=name)
    assert abs(float(names["layer_0.attention.gamma"].grad)) > 0
    buffers = dict(tm.named_buffers())
    for path, s in _flat(upd["batch_stats"]).items():
        np.testing.assert_allclose(buffers[torch_name(path)].numpy(), s,
                                   rtol=1e-5, atol=1e-5)


def test_full_graph_layer_never_takes_the_kernel_path(monkeypatch):
    """Under `tile_dense` on a tiled batch (where the sparse layer takes
    K2/K3's path) the full-graph layer never calls the kernels' wrapper,
    and gives what it gives under `xla`; gamma outside [0, 1] is
    clipped."""
    arrays = packed(_full(), None, tile=32)
    tgb = from_arrays(arrays)
    layer = tconv.GraphTransformerLayer(16, 4, use_edge=True,
                                        full_graph=True)
    init_parameters(layer, torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.attention.gamma.fill_(1.7)
    r = np.random.default_rng(2)
    h = torch.from_numpy(r.normal(size=(len(arrays["node_mask"]), 16))
                         .astype(np.float32))
    e = torch.from_numpy(r.normal(size=(len(arrays["senders"]), 16))
                         .astype(np.float32))
    want = layer(tgb, h, e)

    def refuse(*args, **kw):
        raise AssertionError("the full-graph layer reached K2/K3's path")

    monkeypatch.setattr(tconv, "edge_softmax_attention_tiled", refuse)
    try:
        tseg.set_agg_backend("tile_dense")
        got = layer(tgb, h, e)
    finally:
        tseg.set_agg_backend("xla")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with torch.no_grad():
        layer.attention.gamma.fill_(1.0)
    torch.testing.assert_close(layer(tgb, h, e), want, rtol=0, atol=0)


def test_mlp_readout2_matches_jax():
    """JAX tests/test_gap_components.py:153: the output at eval equals
    JAX's; in training the dropout (0.5) draws from the model's generator
    before each hidden Linear and the shapes hold."""
    x = np.random.default_rng(3).normal(size=(3, 16)).astype(np.float32)
    jm = JMLPReadout2(1, dropout=0.5)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x), training=False))
    tm = MLPReadout2(16, 1, dropout=0.5, rng=DropoutRNG(0))
    load_flax_variables(tm, v)
    assert [n for n, _ in tm.named_parameters()] == [
        "fc_0.weight", "fc_0.bias", "fc_1.weight", "fc_1.bias",
        "fc_2.weight", "fc_2.bias"]
    tm.eval()
    np.testing.assert_allclose(
        tm(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jm.apply(v, jnp.asarray(x), training=False)),
        rtol=1e-5, atol=1e-6)
    tm.train()
    ones = torch.ones(64, 16)
    out = tm(ones)
    assert out.shape == (64, 1) and torch.isfinite(out).all()
    assert tm.drop.rng.generator is not None
    assert not torch.equal(tm(ones), tm(ones))
