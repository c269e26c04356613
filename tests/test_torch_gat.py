"""The GAT and GCN slice of the port against the JAX package: `GCNConv`,
`GATConv`, `GATNet`'s train and eval steps and the GAT SignNet phi, under
bridged parameters; the gcn phi, which neither package runs.
tests/test_torch_train_step.py runs the three GAT configs through the
port's `train_zinc` on the CPU.

GAT and GCN reach no kernel in either package (their softmax and sums are
segment ops; K2 computes the Transformer's score, not GAT's), so under
`pallas_tile` only the GIN SignNet phi of `gat_zinc_signinv_gin` reaches
the tile-local SpMM (the JAX kernel in interpret mode, the port's plain
version).

Tolerances, float32: the layers' outputs 1e-5; their gradients in f64
(JAX under x64 against the port) 1e-7 relative plus 1e-9 of the largest,
and the port's f32 gradients against its f64 ones 1e-4 relative plus the
larger of 1e-4 of the largest gradient and twice JAX's largest f32 error
on that tensor (tests/test_torch_pna.py: `layer_parity`); the train step
as in tests/test_torch_pe.py's `step_parity` (losses 1e-5 relative,
step-1 gradients 1e-6 + 1e-4 relative, BN statistics 1e-5 / 1e-3 after 1
/ 3 steps, parameters 2e-5 but the elements with a step-1 gradient below
1e-6, 2 * lr per step); eval loss and MAE sums 1e-5 relative each.
"""
import numpy as np
import jax
import pytest
import torch

from signnet_basisnet_tpu import models as JM
from signnet_basisnet_tpu.graph import from_arrays as jfrom_arrays
from signnet_basisnet_tpu.models import conv as jconv

from signnet_basisnet_tpu_torch import models as TM
from signnet_basisnet_tpu_torch.data import add_lap_pe
from signnet_basisnet_tpu_torch.graph import from_arrays
from signnet_basisnet_tpu_torch.models import conv as tconv
from signnet_basisnet_tpu_torch.models import signnet as tsignnet
from signnet_basisnet_tpu_torch.nn.init import init_parameters

import torch_ranks
from test_torch_pe import packed, small_graphs, step_parity
from test_torch_pna import layer_parity

K = 4


def _batch(n_graphs=9, seed=5, extra_nodes=32):
    """A tiled batch with padding nodes (no in-edge) and masked padding
    edges."""
    return packed(small_graphs(n_graphs, seed=seed), 0,
                  extra_nodes=extra_nodes)


def _x(arrays, shape, seed=4):
    r = np.random.default_rng(seed)
    x = r.normal(size=(len(arrays["node_mask"]),) + shape)
    mask = arrays["node_mask"].reshape((-1,) + (1,) * len(shape))
    return (x * mask).astype(np.float32)


@pytest.mark.parametrize("add_self_loops", [True, False])
def test_gcn_conv_matches_jax(add_self_loops):
    """PyG's normalisation (self loops: d + 1 on real nodes) and DGL's
    (none: the padding nodes' d = 0 gives them the bias alone)."""
    arrays = _batch()
    jl = jconv.GCNConv(10, add_self_loops=add_self_loops, activation="relu")
    tl = tconv.GCNConv(12, 10, add_self_loops=add_self_loops,
                       activation="relu")
    out = layer_parity(jl, tl, arrays, [_x(arrays, (12,))])
    pad = arrays["node_mask"] == 0
    bias = torch.relu(tl.bias).detach()
    assert torch.equal(out.detach()[pad], bias.expand(int(pad.sum()), -1))


@pytest.mark.parametrize("shape", [(12,), (3, 12)], ids=["N-D", "N-K-D"])
@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("add_self_loops", [True, False])
def test_gat_conv_matches_jax(add_self_loops, concat, shape):
    """Three heads of 4, concatenated (with ELU) or averaged, with the
    analytic self-loop softmax or the masked segment softmax, on [N, D]
    and on the k-channel [N, K, D] stack."""
    arrays = _batch()
    act = "elu" if concat else None
    kw = dict(num_heads=3, concat=concat, add_self_loops=add_self_loops,
              activation=act)
    jl = jconv.GATConv(4, **kw)
    tl = tconv.GATConv(12, 4, **kw)
    out = layer_parity(jl, tl, arrays, [_x(arrays, shape)])
    assert out.shape == (len(arrays["node_mask"]),) + shape[:-1] + (
        12 if concat else 4,)
    assert tl.attn_src.shape == tl.attn_dst.shape == (1, 3, 4)


def test_gat_conv_attention_sums_to_one_over_real_edges():
    """Without self loops the weights of a node's real in-edges sum to 1
    (0 for a node with none), and a padding edge carries nothing: an
    output built with W = I and one head is each node's weighted
    neighbour mean."""
    arrays = _batch(n_graphs=5)
    gb = from_arrays(arrays)
    tl = tconv.GATConv(6, 6, num_heads=1, concat=False,
                       add_self_loops=False)
    with torch.no_grad():
        tl.weight.weight.copy_(torch.eye(6))
        tl.attn_src.normal_()
        tl.attn_dst.normal_()
    ones = torch.ones(gb.num_nodes, 6)
    out = tl(gb, ones).detach()
    has_edge = gb.in_degrees() > 0
    assert torch.allclose(out[has_edge], torch.ones(1, 6), atol=1e-6)
    assert torch.equal(out[~has_edge], torch.zeros(int((~has_edge).sum()),
                                                   6))


def test_gat_and_gcn_take_the_model_parallel_halo(tmp_path):
    """GAT and GCN read their source rows through `src_features`
    on a model-parallel shard: on a one-rank shard each equals the layer
    on the plain batch (tests/test_torch_mp_halo.py holds the route
    across ranks)."""
    arrays = _batch(n_graphs=3)
    gb = from_arrays(arrays)
    x = torch.randn(gb.num_nodes, 4, generator=torch.Generator().manual_seed(0))
    layers = (tconv.GATConv(4, 2, num_heads=2), tconv.GCNConv(4, 2))
    for layer in layers:
        init_parameters(layer, torch.Generator().manual_seed(1))
    want = [layer(gb, x) for layer in layers]
    with torch_ranks.one_rank_shard(arrays, tmp_path) as shard:
        got = [layer(shard, x) for layer in layers]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


GAT_NET = dict(hidden_dim=16, out_dim=16, n_layers=2, num_heads=4,
               pos_enc_dim=K, lap_method="sign_inv", sign_inv_layers=2,
               pe_aggregate="concat")


def test_gat_net_steps_match_jax_with_the_gin_phi_on_pallas_tile():
    """gat_zinc_signinv_gin's net cut to width 16 and 2 layers (4 heads of
    4, then one head of 16), the GIN phi over k = 4 on a tiled batch: the
    phi's aggregations run the tile-local SpMM (the JAX kernel in
    interpret mode, the port's plain version); the GAT layers run none."""
    gs = small_graphs(11, seed=2)
    add_lap_pe(gs, K)
    step_parity("GAT", dict(GAT_NET, sign_inv_net="gin"), packed(gs, K),
                "sign_inv", backend="pallas_tile", steps=1)


def test_gin_net_with_the_gat_phi_matches_jax():
    """GINNet with the GAT SignNet phi (sign_inv_net gat, as
    tests/test_gap_components.py builds it): four heads averaged in each
    phi layer, over the [N, 2k, D] stack."""
    gs = small_graphs(11, seed=3)
    add_lap_pe(gs, K)
    net = dict(hidden_dim=16, out_dim=16, n_layers=2, pos_enc_dim=K,
               lap_method="sign_inv", sign_inv_net="gat", sign_inv_layers=2,
               phi_out_dim=2)
    tm = TM.gnn_model("GIN", **net)
    assert isinstance(tm.sign_inv_net.enc.conv_0, tconv.GATConv)
    assert tm.sign_inv_net.enc.conv_1.activation is None
    step_parity("GIN", net, packed(gs, K), "sign_inv")


def test_the_gcn_phi_raises_in_both_packages():
    """The JAX package's GCN phi multiplies the [N, 2k, D] stack by a
    [N, 1] degree column and cannot broadcast; the port refuses it when
    the net is built, saying why."""
    gs = small_graphs(4, seed=4)
    add_lap_pe(gs, K)
    arrays = packed(gs, K)
    net = dict(hidden_dim=8, out_dim=8, n_layers=1, pos_enc_dim=K,
               lap_method="sign_inv", sign_inv_net="gcn", sign_inv_layers=2)
    jgb = jfrom_arrays(arrays)
    with pytest.raises(ValueError, match="[Ii]ncompatible shapes"):
        JM.gnn_model("GIN", **net).init(
            {"params": jax.random.PRNGKey(0)}, jgb, jgb.eigvecs,
            training=False)
    with pytest.raises(ValueError, match="cannot broadcast|does not broadcast"):
        TM.gnn_model("GIN", **net)
    with pytest.raises(ValueError, match="gcn"):
        tsignnet.KChannelGNN(1, 8, 4, 2, kind="gcn")
