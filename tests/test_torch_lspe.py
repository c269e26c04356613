"""LSPE (learnable structural and positional encodings) in the port against
the JAX package: `normalize_p`, `lapeig_loss`, the `GatedGCNLSPELayer`,
the LSPE branches of GINNet and GatedGCNNet with the Laplacian-eigvec loss
(`make_lapeig_loss_fn`), under bridged parameters; and the GIN PE configs
through the port's `train_zinc` on the CPU.

The GatedGCN-LSPE layer runs no kernel in either package (its sums are
segment sums), so under `pallas_tile` only the GIN layers reach the
tile-local SpMM (the JAX kernel in interpret mode, the port's plain
version).

Tolerances, float32 (tests/test_torch_gatedgcn.py's, as
tests/test_torch_pe.py states them again): functions and layers 1e-5;
their gradients 1e-4 relative plus 1e-6 or, where larger, 1e-6 of the
largest gradient; the train step as in tests/test_torch_pe.py's
`step_parity` (losses 1e-5 relative, step-1 gradients 1e-6 + 1e-4
relative, BN statistics 1e-5 / 1e-3 after 1 / 3 steps, parameters 2e-5
but the elements with a step-1 gradient below 1e-6, 2 * lr per step);
eval loss and MAE sums 1e-5 relative each.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from signnet_basisnet_tpu import models as JM
from signnet_basisnet_tpu.graph import from_arrays as jfrom_arrays
from signnet_basisnet_tpu.models import zinc_models as jzm
from signnet_basisnet_tpu.models.conv import \
    GatedGCNLSPELayer as JGatedGCNLSPELayer

from signnet_basisnet_tpu_torch import models as TM
from signnet_basisnet_tpu_torch import train_zinc
from signnet_basisnet_tpu_torch.bridge import load_flax_variables, torch_name
from signnet_basisnet_tpu_torch.data import add_lap_pe, add_rwpe
from signnet_basisnet_tpu_torch.graph import from_arrays
from signnet_basisnet_tpu_torch.graph import segment as tseg
from signnet_basisnet_tpu_torch.models import conv as tconv
from signnet_basisnet_tpu_torch.training import load_config

from test_torch_pe import _flat, _port_view, packed, small_graphs, \
    step_parity

TOL = dict(rtol=1e-5, atol=1e-5)
K = 4
LSPE_NET = dict(hidden_dim=16, out_dim=16, n_layers=2, pos_enc_dim=K,
                pe_init="rand_walk", lap_method="none", use_lspe=True)


def _batch(pe="rwpe", n_graphs=11, seed=0, extra_nodes=32):
    gs = small_graphs(n_graphs, seed=seed)
    (add_rwpe if pe == "rwpe" else add_lap_pe)(gs, K)
    return packed(gs, K, extra_nodes=extra_nodes)


def _p(arrays, seed=1, width=K):
    r = np.random.default_rng(seed)
    return (r.normal(size=(len(arrays["node_mask"]), width))
            * arrays["node_mask"][:, None]).astype(np.float32)


def test_normalize_p_matches_jax_with_padding_graphs():
    """Centred and scaled per graph; the padding graph's all-zero p stays
    finite (1e-12 inside the sqrt), values and gradients."""
    arrays = _batch()
    p = _p(arrays)
    c = _p(arrays, seed=2)
    jgb = jfrom_arrays(arrays)
    want = np.asarray(jzm.normalize_p(jgb, jnp.asarray(p)))
    jgrad = jax.grad(lambda q: (jzm.normalize_p(jgb, q) * c).sum())(
        jnp.asarray(p))
    tp = torch.from_numpy(p).requires_grad_(True)
    got = TM.normalize_p(from_arrays(arrays), tp)
    (got * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-6)
    assert torch.isfinite(tp.grad).all()
    pad = arrays["node_mask"] == 0
    assert (got.detach().numpy()[pad] == 0).all()


def test_lapeig_loss_matches_jax():
    arrays = _batch()
    p = _p(arrays)
    jgb, tgb = jfrom_arrays(arrays), from_arrays(arrays)
    jt, jo = jzm.lapeig_loss(jgb, jnp.asarray(p))
    jgrad = jax.grad(lambda q: sum(jzm.lapeig_loss(jgb, q)))(jnp.asarray(p))
    tp = torch.from_numpy(p).requires_grad_(True)
    tt, to = TM.lapeig_loss(tgb, tp)
    (tt + to).backward()
    np.testing.assert_allclose(tt.item(), float(jt), rtol=1e-5)
    np.testing.assert_allclose(to.item(), float(jo), rtol=1e-5)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-6)
    # trace(p^T L p) of the normalised Laplacian is nonnegative
    assert tt.item() > 0 and to.item() > 0


@pytest.mark.parametrize("features", [16, 12])
def test_lspe_layer_matches_jax(features):
    """h, p and e out, BN running statistics and every gradient (of the
    parameters, h, p and e).  At 16 the residual adds all three; at 12 the
    shapes differ and it does not."""
    arrays = _batch()
    n, ne = len(arrays["node_mask"]), len(arrays["senders"])
    r = np.random.default_rng(3)
    h = _p(arrays, 4, 16)
    p = _p(arrays, 5, 16)
    e = r.normal(size=(ne, 16)).astype(np.float32)
    cs = [r.normal(size=s).astype(np.float32)
          for s in ((n, features), (n, features), (ne, features))]
    jgb = jfrom_arrays(arrays)
    jl = JGatedGCNLSPELayer(features, residual=True)
    var = jax.tree.map(np.asarray, jl.init(
        jax.random.PRNGKey(2), jgb, jnp.asarray(h), jnp.asarray(p),
        jnp.asarray(e), None, training=False))
    tl = tconv.GatedGCNLSPELayer(16, features, residual=True)
    load_flax_variables(tl, var)

    def loss(params, h, p, e):
        outs, upd = jl.apply({"params": params,
                              "batch_stats": var["batch_stats"]}, jgb, h, p,
                             e, None, training=True, mutable=["batch_stats"])
        return sum((o * c).sum() for o, c in zip(outs, cs)), (outs, upd)

    (_, (jouts, upd)), jgrads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(
            var["params"], jnp.asarray(h), jnp.asarray(p), jnp.asarray(e))
    tin = [torch.from_numpy(a).requires_grad_(True) for a in (h, p, e)]
    touts = tl(from_arrays(arrays), *tin)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(touts, cs)
        ).backward()
    for a, b in zip(touts, jouts):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    for t, g in zip(tin, jgrads[1:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-6)
    grads = _flat(jgrads[0])
    floor = 1e-6 * max(np.abs(g).max() for g in grads.values())
    params = dict(tl.named_parameters())
    assert len(params) == len(grads) == 18
    for path, g in grads.items():
        name = torch_name(path)
        np.testing.assert_allclose(params[name].grad.numpy(),
                                   _port_view(path, g), err_msg=name,
                                   rtol=1e-4, atol=max(floor, 1e-6))
    buffers = dict(tl.named_buffers())
    for path, s in _flat(upd["batch_stats"]).items():
        np.testing.assert_allclose(buffers[torch_name(path)].numpy(), s,
                                   **TOL)


def test_lspe_layer_takes_the_model_parallel_halo(tmp_path):
    """The GatedGCN-LSPE layer reads B2 h, A2 [h || p] and C2 p
    of its sources through `src_features` on a model-parallel shard: on a
    one-rank shard it equals the layer on the plain batch
    (tests/test_torch_mp_halo.py holds the route across ranks)."""
    import torch_ranks
    from signnet_basisnet_tpu_torch.nn.init import init_parameters
    arrays = _batch()
    gb = from_arrays(arrays)
    layer = tconv.GatedGCNLSPELayer(8, 8)
    init_parameters(layer, torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(0)
    h, p = (torch.randn(gb.num_nodes, 8, generator=g) for _ in range(2))
    e = torch.randn(gb.num_edges, 8, generator=g)
    want = layer(gb, h, p, e)
    with torch_ranks.one_rank_shard(arrays, tmp_path) as shard:
        got = layer(shard, h, p, torch_ranks.edge_rows(e, shard))
    real = gb.edge_mask > 0
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[2][:gb.num_edges][real], want[2][real],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model_name,pe,backend", [
    ("GIN", "rwpe", "pallas_tile"), ("GatedGCN", "lap_pe", "pallas_tile")])
def test_lspe_steps_match_jax_with_the_lapeig_loss(model_name, pe, backend,
                                                   monkeypatch):
    """The LSPE nets (p_out, normalize_p, Whp over [h || p]; GatedGCN's
    layers update p) with the Laplacian-eigvec loss at alpha 0.5, where its
    terms show: the eval step's loss and MAE differ, and each matches JAX.
    The port's GatedGCN-LSPE layers never call the fused gate."""
    calls = []
    monkeypatch.setattr(tconv, "gatedgcn_gate_tiled",
                        lambda *a: calls.append(1))
    jres, tres = step_parity(model_name, LSPE_NET, _batch(pe, extra_nodes=0),
                             "none", lapeig=(0.5, 1.0, K), backend=backend)
    assert not calls
    assert abs(tres["loss_sum"] - tres["mae_sum"]) > 1e-3 * tres["mae_sum"]
    assert abs(jres["loss_sum"] - jres["mae_sum"]) > 1e-3 * jres["mae_sum"]


@pytest.mark.parametrize("model_name", ["GIN", "GatedGCN"])
def test_bridge_sets_every_lspe_net_tensor(model_name):
    """p_out, Whp and, for GatedGCN, layer_i/{A1, A2, B1, B2, B3, C1, C2,
    bn_h, bn_e} land on the port's tensors; every port tensor is set."""
    arrays = _batch(n_graphs=5)
    jgb = jfrom_arrays(arrays)
    v = JM.gnn_model(model_name, **LSPE_NET).init(
        {"params": jax.random.PRNGKey(0)}, jgb, jgb.eigvecs, training=False)
    tm = TM.gnn_model(model_name, **LSPE_NET)
    load_flax_variables(tm, jax.tree.map(np.asarray, v))
    names = set(dict(tm.named_parameters())) | set(dict(tm.named_buffers()))
    assert {"p_out.weight", "Whp.weight", "embedding_p.weight"} <= names
    assert "embedding_hp.weight" not in names
    assert tm.Whp.weight.shape == (16, 16 + K)
    if model_name == "GatedGCN":
        for i in range(LSPE_NET["n_layers"]):
            for m in ("A1", "A2", "B1", "B2", "B3", "C1", "C2"):
                assert f"layer_{i}.{m}.weight" in names
            assert f"layer_{i}.bn_e.running_var" in names
        assert tm.layer_0.A1.weight.shape == (16, 32)


@pytest.mark.parametrize("config,pe_launch", [
    ("gin_zinc_lappe", True), ("gin_zinc_rwpe_lspe", True),
    ("gin_zinc_rwpe_lspe", False)])
def test_train_zinc_runs_gin_pe_configs_on_cpu(tmp_path, monkeypatch, config,
                                               pe_launch):
    """The GIN LapPE (sign_flip) and LSPE configs cut to width 8, with the
    tile-local SpMM (on the card, K1) on one GIN layer per forward; the
    LSPE config also as shipped (no tiles).  The sign_flip config flips at
    eval too: one draw per eval batch."""
    calls = []
    wrapped = tconv.spmm_tiled

    def spy(*args, **kw):
        calls.append(1)
        return wrapped(*args, **kw)

    monkeypatch.setattr(tconv, "spmm_tiled", spy)
    extra = (["data.tile", "32", "data.agg_backend", "pallas_tile"]
             if pe_launch else [])
    cfg = load_config(f"configs/{config}.json", extra + [
        "train.epochs", "2", "train.batch_size", "8", "data.synth_train",
        "24", "data.synth_eval", "8", "model.n_layers", "2",
        "model.hidden_dim", "8", "model.out_dim", "8",
        "out_dir", str(tmp_path), "name", "smoke"])
    try:
        res = train_zinc.run(cfg, device="cpu", log=lambda m: None)
    finally:
        tseg.set_agg_backend("xla")
    assert res.epochs_run == 2 and res.train_steps >= 4
    assert len(calls) == (2 * (res.train_steps + res.eval_steps)
                          if pe_launch else 0)
    assert res.eval_flip_draws == (res.eval_steps
                                   if cfg.model.lap_method == "sign_flip"
                                   else 0)
    assert np.isfinite(res.val_mae) and np.isfinite(res.test_mae)
    h = res.history[-1]
    if cfg.model.use_lapeig_loss:
        assert h["val_loss"] != h["val_mae"]
    assert (tmp_path / "smoke_results.json").exists()
