"""The masked all-eigenvector SignNet path (`sign_inv_net masked_gin` on
full-EVD batches) of the port against the JAX package, under bridged
parameters: configs/gatedgcn_zinc_signinv_masked.json's GatedGCN net
under `pallas_tile` (the phi's aggregations through the tile-local SpMM,
the gate through K4's plain version; the JAX kernels in interpret mode)
and configs/transformer_zinc_signinv_masked.json's Transformer as shipped
(`tile_dense`), both cut to width 16 and 2 layers, with k = the batch's
largest graph.

Tolerances, float32 (tests/test_torch_gatedgcn.py's, as
tests/test_torch_pe.py states them again): losses 1e-5 relative,
gradients at step 1 1e-6 + 1e-4 relative, BN statistics 1e-5 after step 1
and 1e-3 after step 3, parameters 2e-5 after 1 and 3 Adam steps except the
elements whose step-1 gradient is below 1e-6, held to 2 * lr per step; the
eval sums 1e-5 relative; bf16 within twice JAX's own bf16 error against its
f32 scores.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from signnet_basisnet_tpu import models as JM
from signnet_basisnet_tpu.graph import from_arrays as jfrom_arrays
from signnet_basisnet_tpu.training import adam as jadam
from signnet_basisnet_tpu.training import create_state
from signnet_basisnet_tpu.training import make_zinc_predict as jpredict

from signnet_basisnet_tpu_torch import models as TM
from signnet_basisnet_tpu_torch.bridge import load_flax_variables
from signnet_basisnet_tpu_torch.data import add_full_evd
from signnet_basisnet_tpu_torch.graph import from_arrays
from signnet_basisnet_tpu_torch.graph import segment as tseg
from signnet_basisnet_tpu_torch.models import conv as tconv
from signnet_basisnet_tpu_torch.training import make_zinc_predict

from test_torch_pe import packed, small_graphs, step_parity


def _masked(model_name, n_graphs=11, seed=0):
    gs = small_graphs(n_graphs, seed=seed)
    add_full_evd(gs)
    k = max(len(g["node_feat"]) for g in gs)
    net = dict(hidden_dim=16, out_dim=16, n_layers=2, pos_enc_dim=k,
               lap_method="sign_inv", sign_inv_net="masked_gin",
               sign_inv_layers=2, phi_out_dim=16, pe_aggregate="concat")
    if model_name == "Transformer":
        net.update(num_heads=4, layer_norm=True)
    return net, packed(gs, k)


@pytest.mark.parametrize("model_name,backend", [
    ("GatedGCN", "pallas_tile"), ("Transformer", "tile_dense")])
def test_masked_signnet_steps_match_jax(model_name, backend):
    net, arrays = _masked(model_name)
    assert arrays["eigvecs"].shape[1] == net["pos_enc_dim"] > 16
    step_parity(model_name, net, arrays, "sign_inv", backend=backend)


def test_masked_gatedgcn_bf16_predict_close_to_jax(monkeypatch):
    """Whole-model bf16 compute: the port's scores through the plain K1
    and K4 in bf16 within twice JAX's own bf16 error against its f32
    scores (the JAX side on the flat path: its gate kernel refuses bf16)."""
    net, arrays = _masked("GatedGCN")
    jgb = jfrom_arrays(arrays)
    jm = JM.gnn_model("GatedGCN", **net)
    state = create_state(jm, jgb, jadam(),
                         model_kwargs={"pos_enc": jgb.eigvecs})
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    rngs = {"dropout": jax.random.PRNGKey(0)}
    a16, _ = jpredict(jm, lap_method="sign_inv",
                      compute_dtype=jnp.bfloat16)(
        variables, jgb, True, rngs, ["batch_stats"])
    a32, _ = jpredict(jm, lap_method="sign_inv")(
        variables, jgb, True, rngs, ["batch_stats"])
    real = arrays["graph_mask"] > 0
    a16, a32 = np.asarray(a16)[real], np.asarray(a32)[real]
    tm = TM.gnn_model("GatedGCN", **net)
    load_flax_variables(tm, jax.tree.map(np.asarray, variables))
    tm.train()
    calls = []
    spmm = tconv.spmm_tiled

    def spy(x, *args, **kw):
        calls.append(x.shape[1])
        return spmm(x, *args, **kw)

    monkeypatch.setattr(tconv, "spmm_tiled", spy)
    tseg.set_agg_backend("pallas_tile")
    try:
        b = make_zinc_predict(tm, "sign_inv", compute_dtype=torch.bfloat16)(
            from_arrays(arrays))
    finally:
        tseg.set_agg_backend("xla")
    k = net["pos_enc_dim"]
    assert calls == [2 * k, 2 * k * 16]  # the phi's two layers
    assert b.dtype == torch.float32 and torch.isfinite(b).all()
    jax_err = np.abs(a16 - a32).max()
    assert 0 < jax_err < 0.1 * np.abs(a32).max()
    assert np.abs(b.detach().numpy()[real] - a16).max() <= 2 * jax_err


@pytest.mark.parametrize("model_name", ["GatedGCN", "Transformer"])
def test_bridge_sets_every_masked_net_tensor(model_name):
    """sign_inv_net/enc/... (the phi, as conv_i.mlp and bn_i) and
    sign_inv_net/rho/... (an MLP from phi_out to k) of the masked encoder
    land on the port's tensors, and every port tensor is set."""
    net, arrays = _masked(model_name, n_graphs=5)
    jgb = jfrom_arrays(arrays)
    v = JM.gnn_model(model_name, **net).init(
        {"params": jax.random.PRNGKey(0)}, jgb, jgb.eigvecs, training=False)
    tm = TM.gnn_model(model_name, **net)
    load_flax_variables(tm, jax.tree.map(np.asarray, v))
    names = set(dict(tm.named_parameters())) | set(dict(tm.named_buffers()))
    k = net["pos_enc_dim"]
    assert tm.sign_inv_net.rho.lin_0.weight.shape == (16, 16)
    assert tm.sign_inv_net.rho.lin_1.weight.shape == (k, 16)
    assert {"sign_inv_net.enc.conv_0.mlp.lin_0.weight",
            "sign_inv_net.enc.bn_0.running_var",
            "sign_inv_net.rho.bn_0.running_mean",
            "embedding_p.weight", "embedding_hp.weight"} <= names
