"""The transformer SignNet phi (`TransformerDeepSigns`) and the dense node
layout it runs in, against the JAX package under bridged parameters.

The phi folds the k eigenvector channels and both signs into the
attention batch over each graph's nodes padded to `n_max`
(`graph.batch.to_dense_nodes`).  Its attention dropout (0.1, the JAX
default) draws different bits in the two packages, so the module is held
at eval (no BN: `use_bn` is off, as the JAX factory builds it) and the
train steps with the attention dropout off on both sides (flax's Dropout
patched to an identity, the port's set-transformer dropouts at rate 0).

Tolerances, float32: the dense layout exactly (a scatter and a gather);
the phi's output 1e-5 and its gradients 1e-4 relative plus 1e-6 of the
tensor's largest; the train and eval steps as tests/test_torch_pe.py's
`step_parity` holds them; sign invariance 1e-5, as float noise.
"""
import flax
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from signnet_basisnet_tpu import models as JM
from signnet_basisnet_tpu.graph import from_arrays as jfrom_arrays
from signnet_basisnet_tpu.graph.batch import from_dense_nodes as jfrom_dense
from signnet_basisnet_tpu.graph.batch import to_dense_nodes as jto_dense

from signnet_basisnet_tpu_torch import models as TM
from signnet_basisnet_tpu_torch import train_zinc
from signnet_basisnet_tpu_torch.bridge import load_flax_variables, torch_name
from signnet_basisnet_tpu_torch.data import add_lap_pe
from signnet_basisnet_tpu_torch.graph import (batch_np, dense_node_index,
                                              from_arrays, from_dense_nodes,
                                              to_dense_nodes)
from signnet_basisnet_tpu_torch.graph import segment as tseg
from signnet_basisnet_tpu_torch.nn import set_transformer as tst
from signnet_basisnet_tpu_torch.nn.dropout import Dropout, DropoutRNG
from signnet_basisnet_tpu_torch.training import load_config

from test_torch_alchemy import _NoDropout
from test_torch_pe import _flat, _port_view, packed, small_graphs, step_parity

K = 4
N_MAX = 24


def _graphs(seed=3):
    gs = small_graphs(6, max_nodes=N_MAX, seed=seed)
    add_lap_pe(gs, K)
    return gs


def _layouts(gs):
    """The same graphs tiled (node_offset in extras) and flat."""
    return {"tiled": packed(gs, K), "flat": batch_np(gs, 200, 400, 8, k=K)}


@pytest.fixture
def no_attention_dropout(monkeypatch):
    """Attention dropout off in both packages."""
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    monkeypatch.setattr(tst, "Dropout",
                        lambda rate, rng=None: Dropout(0.0, rng))


@pytest.mark.parametrize("layout", ["tiled", "flat"])
@pytest.mark.parametrize("n_max", [N_MAX, 10])
def test_dense_node_layout_matches_jax(layout, n_max):
    """to_dense_nodes and from_dense_nodes give JAX's arrays bit for bit:
    at n_max 10 the larger graphs clamp, and their last node holds the
    last slot, as the JAX scatter's last write leaves it on the CPU."""
    arrays = _layouts(_graphs())[layout]
    jgb, tgb = jfrom_arrays(arrays), from_arrays(arrays)
    x = (np.random.default_rng(0).normal(size=(len(arrays["node_mask"]), 3))
         * arrays["node_mask"][:, None]).astype(np.float32)
    jd, jm = jto_dense(jgb, jnp.asarray(x), n_max)
    td, tm = to_dense_nodes(tgb, torch.from_numpy(x), n_max)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(from_dense_nodes(tgb, td).numpy(),
                                  np.asarray(jfrom_dense(jgb, jd)))
    if n_max == N_MAX:   # every graph fits: a round trip
        np.testing.assert_array_equal(from_dense_nodes(tgb, td).numpy(), x)
        assert float(tm.sum()) == float(arrays["node_mask"].sum())
    gid, idx = dense_node_index(tgb)
    real = arrays["node_mask"] > 0
    assert (idx.numpy()[real] < arrays["n_node"][gid.numpy()[real]]).all()


def _phi_pair(arrays):
    jgb = jfrom_arrays(arrays)
    jm = JM.TransformerDeepSigns(hidden=16, num_layers=2, k=K, n_max=N_MAX)
    variables = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jgb, jgb.eigvecs, training=False))
    tm = TM.TransformerDeepSigns(16, 2, K, N_MAX, rng=DropoutRNG(0))
    load_flax_variables(tm, variables)
    return jm, variables, tm.eval()


def test_transformer_phi_matches_jax():
    """The phi's output, and the gradients of every parameter and of the
    eigenvectors, at eval, on the tiled batch (the padding graph's
    all-masked attention rows included: finite, zero after the mask; the
    flat batch's layout is held bit for bit above)."""
    arrays = _layouts(_graphs())["tiled"]
    jgb, tgb = jfrom_arrays(arrays), from_arrays(arrays)
    jm, variables, tm = _phi_pair(arrays)
    c = np.random.default_rng(1).normal(size=(len(arrays["node_mask"]), K)
                                        ).astype(np.float32)

    def jloss(params, pe):
        out = jm.apply({"params": params}, jgb, pe, training=False)
        return (out * c).sum(), out

    (_, jout), (jg, jgpe) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(variables["params"],
                                             jgb.eigvecs)
    pe = tgb.eigvecs.clone().requires_grad_(True)
    tout = tm(tgb, pe)
    (tout * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    assert np.isfinite(tout.detach().numpy()).all()
    grads = dict(tm.named_parameters())
    for path, g in _flat(jg).items():
        want = _port_view(path, g)
        np.testing.assert_allclose(
            grads[torch_name(path)].grad.numpy(), want, rtol=1e-4,
            atol=1e-6 * max(np.abs(want).max(), 1.0), err_msg=str(path))
    np.testing.assert_allclose(pe.grad.numpy(), np.asarray(jgpe), rtol=1e-4,
                               atol=1e-6 * np.abs(np.asarray(jgpe)).max())


def test_transformer_phi_is_sign_invariant():
    """Flipping the sign of any eigenvector leaves the phi's output as it
    was (JAX tests/test_more_models.py:68), at eval.  (In training the
    attention dropout's masks do not follow a flip from the +v half of
    the attention batch to the -v half: invariant in distribution only,
    in both packages.)"""
    arrays = _layouts(_graphs())["flat"]
    tgb = from_arrays(arrays)
    _, _, tm = _phi_pair(arrays)
    r = np.random.default_rng(2)
    pe = torch.from_numpy((r.normal(size=arrays["eigvecs"].shape)
                           * arrays["node_mask"][:, None]).astype(np.float32))
    flips = torch.from_numpy(np.array([1.0, -1.0, -1.0, 1.0], np.float32))
    np.testing.assert_allclose(tm(tgb, pe).detach().numpy(),
                               tm(tgb, pe * flips).detach().numpy(),
                               atol=1e-5)


def test_gin_with_the_transformer_phi_is_sign_invariant():
    """The GIN net with `sign_inv_net transformer` (max_nodes 24): its
    scores do not change under eigenvector sign flips (JAX
    tests/test_gap_components.py:97, the transformer case)."""
    arrays = _layouts(_graphs())["tiled"]
    tgb = from_arrays(arrays)
    net = TM.gnn_model("GIN", hidden_dim=12, out_dim=12, n_layers=2,
                       pe_init="lap_pe", lap_method="sign_inv",
                       sign_inv_net="transformer", sign_inv_layers=2,
                       pos_enc_dim=K, phi_out_dim=2, max_nodes=N_MAX).eval()
    assert isinstance(net.sign_inv_net, TM.TransformerDeepSigns)
    assert net.sign_inv_net.n_max == N_MAX
    signs = torch.tensor([[-1.0, 1.0, -1.0, -1.0]])
    np.testing.assert_allclose(net(tgb, tgb.eigvecs).detach().numpy(),
                               net(tgb, tgb.eigvecs * signs).detach().numpy(),
                               atol=1e-5)


def test_gin_with_the_transformer_phi_steps_match_jax(no_attention_dropout):
    """Train and eval steps of GIN with the transformer phi (5 encoder
    layers asked, min(5, 4) = 4 built, as in JAX) against JAX's, the
    attention dropout off on both sides."""
    arrays = _layouts(_graphs())["tiled"]
    net = dict(hidden_dim=16, out_dim=16, n_layers=2, pos_enc_dim=K,
               lap_method="sign_inv", sign_inv_net="transformer",
               sign_inv_layers=5, phi_out_dim=2, max_nodes=N_MAX)
    assert sum(n.startswith("sign_inv_net.sab_") and n.endswith("w_1.bias")
               for n, _ in TM.gnn_model("GIN", **net).named_parameters()
               ) == 4
    step_parity("GIN", net, arrays, "sign_inv")


def test_train_zinc_runs_the_transformer_phi_on_cpu(tmp_path):
    """`model.sign_inv_net transformer` through train_zinc.run: the
    flagship config cut to width 8, finite losses and MAE."""
    cfg = load_config("configs/gin_zinc_signinv_gin.json", [
        "model.sign_inv_net", "transformer", "data.agg_backend",
        "pallas_tile", "train.epochs", "2", "train.batch_size", "8",
        "data.synth_train", "24", "data.synth_eval", "8",
        "model.n_layers", "2", "model.hidden_dim", "8", "model.out_dim",
        "8", "model.sign_inv_layers", "2", "out_dir", str(tmp_path),
        "name", "smoke"])
    try:
        res = train_zinc.run(cfg, device="cpu", log=lambda m: None)
    finally:
        tseg.set_agg_backend("xla")
    assert res.epochs_run == 2 and res.train_steps >= 4
    assert all(np.isfinite(h["train_loss"]) for h in res.history)
    assert np.isfinite(res.val_mae) and np.isfinite(res.test_mae)
