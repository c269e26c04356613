"""The second slice: the ZINC Transformer + SignNet (GINDeepSigns) path of
the port against the JAX package, under bridged parameters.

On the CPU the JAX `GraphTransformerAttention` takes its XLA path (every
edge counts) and the port's takes the plain version of K2/K3 (the
tile-locality rule); on packed batches, where every edge is tile-local,
both compute the same function as the kernels.  Both sides run the
`tile_dense` aggregation backend, the shipped config's.

Tolerances, float32 (the same as tests/test_torch_train_step.py, for the
same reasons):
- blocks and layers, 1e-5; their gradients, 1e-4 relative plus 1e-6 or,
  where larger, 1e-6 of the layer's largest gradient (for a gradient that
  is zero in exact arithmetic and float noise here);
- the train step: losses 1e-5 relative, gradients at step 1 1e-6 + 1e-4
  relative, BN statistics 1e-5 after step 1 and 1e-3 after step 3,
  parameters 2e-5 after 1 and 3 Adam steps except the elements whose step-1
  gradient is below 1e-6 (zero in exact arithmetic, e.g. a LayerNorm bias
  that feeds straight into a BatchNorm), held to 2 * lr per step;
- bf16: within twice JAX's own bf16 error against its f32 scores.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from signnet_basisnet_tpu import models as JM
from signnet_basisnet_tpu import nn as jnn
from signnet_basisnet_tpu.graph import from_arrays as jfrom_arrays
from signnet_basisnet_tpu.graph import segment as jseg
from signnet_basisnet_tpu.training import adam as jadam
from signnet_basisnet_tpu.training import build_steps as jbuild_steps
from signnet_basisnet_tpu.training import create_state
from signnet_basisnet_tpu.training import make_zinc_predict as jpredict
from signnet_basisnet_tpu.training.train import l1_graph_loss as jl1

from signnet_basisnet_tpu_torch import models as TM
from signnet_basisnet_tpu_torch import nn as tnn
from signnet_basisnet_tpu_torch import train_zinc
from signnet_basisnet_tpu_torch.bridge import load_flax_variables, torch_name
from signnet_basisnet_tpu_torch.data import (add_lap_pe, choose_budgets,
                                             pack_batches, synthetic_zinc)
from signnet_basisnet_tpu_torch.graph import from_arrays
from signnet_basisnet_tpu_torch.graph import segment as tseg
from signnet_basisnet_tpu_torch.models import conv as tconv
from signnet_basisnet_tpu_torch.training import (adam, build_steps,
                                                 load_config,
                                                 make_zinc_predict)

LR = 1e-3
TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=1e-6)
NET = dict(hidden_dim=16, out_dim=16, n_layers=2, num_heads=4,
           layer_norm=True, pos_enc_dim=4, lap_method="sign_inv",
           sign_inv_layers=2, phi_out_dim=2, pe_aggregate="concat")


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _port_view(path, a):
    return a.T if path[-1] == "kernel" else a


def _packed(n_graphs=13, tile=32, k=4, seed=0):
    gs = synthetic_zinc(n_graphs, 0, 0, seed=seed)["train"]
    add_lap_pe(gs, k)
    nb, eb, gc = choose_budgets(gs, len(gs), tile=tile)
    return pack_batches(gs, nb, eb, gc, k=k, tile=tile)[0]


@pytest.fixture
def tile_dense():
    jseg.set_agg_backend("tile_dense")
    tseg.set_agg_backend("tile_dense")
    yield
    jseg.set_agg_backend("xla")
    tseg.set_agg_backend("xla")


@pytest.mark.parametrize("shape,masked", [((30, 12), True), ((30, 12), False),
                                          ((10, 3, 12), True)])
def test_masked_layernorm_matches_jax(shape, masked):
    r = np.random.default_rng(0)
    x = (r.normal(size=shape) * 3 + 1).astype(np.float32)
    mask = (r.random(shape[:-1]) > 0.25).astype(np.float32)
    jln = jnn.MaskedLayerNorm(12)
    var = jax.tree.map(np.asarray, jln.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    var["params"]["scale"] = r.normal(size=12).astype(np.float32)
    var["params"]["bias"] = r.normal(size=12).astype(np.float32)
    tln = tnn.MaskedLayerNorm(12)
    load_flax_variables(tln, var)
    m = mask if masked else None
    a = jln.apply(var, jnp.asarray(x),
                  mask=None if m is None else jnp.asarray(m))
    b = tln(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("backend,layer_norm,use_edge", [
    ("tile_dense", True, True), ("xla", False, False)])
def test_transformer_layer_matches_jax(backend, layer_norm, use_edge):
    """One GraphTransformerLayer: output, BN running statistics, and the
    gradients of every parameter and of h and e."""
    arrays = _packed()
    n, ne = len(arrays["node_mask"]), len(arrays["senders"])
    r = np.random.default_rng(1)
    h = (r.normal(size=(n, 16)) * arrays["node_mask"][:, None]).astype(
        np.float32)
    e = r.normal(size=(ne, 16)).astype(np.float32)
    c = r.normal(size=(n, 16)).astype(np.float32)
    jgb = jfrom_arrays(arrays)
    jl = JM.GraphTransformerLayer(16, 4, layer_norm=layer_norm,
                                  use_edge=use_edge)
    var = jax.tree.map(np.asarray, jl.init(
        jax.random.PRNGKey(2), jgb, jnp.asarray(h), jnp.asarray(e),
        training=False))
    tl = tconv.GraphTransformerLayer(16, 4, layer_norm=layer_norm,
                                     use_edge=use_edge)
    load_flax_variables(tl, var)
    jseg.set_agg_backend(backend)
    tseg.set_agg_backend(backend)
    try:
        def loss(params, h, e):
            out, upd = jl.apply({"params": params,
                                 "batch_stats": var["batch_stats"]},
                                jgb, h, e, training=True,
                                mutable=["batch_stats"])
            return (out * c).sum(), (out, upd)

        (_, (a, upd)), (gp, gh, ge) = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(
                var["params"], jnp.asarray(h), jnp.asarray(e))
        th = torch.from_numpy(h).requires_grad_(True)
        te = torch.from_numpy(e).requires_grad_(True)
        b = tl(from_arrays(arrays), th, te)
        (b * torch.from_numpy(c)).sum().backward()
    finally:
        jseg.set_agg_backend("xla")
        tseg.set_agg_backend("xla")
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), **TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), **GTOL)
    if use_edge:
        np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), **GTOL)
    else:
        assert te.grad is None and not np.asarray(ge).any()
    # ln1's bias feeds straight into a BatchNorm: its gradient is zero in
    # exact arithmetic and float noise here, so the absolute floor is 1e-6
    # of the layer's largest gradient, not 1e-6
    grads = _flat(gp)
    floor = 1e-6 * max(np.abs(g).max() for g in grads.values())
    params = dict(tl.named_parameters())
    for path, g in grads.items():
        name = torch_name(path)
        np.testing.assert_allclose(params[name].grad.numpy(),
                                   _port_view(path, g), err_msg=name,
                                   rtol=1e-4, atol=max(floor, 1e-6))
    buffers = dict(tl.named_buffers())
    for path, s in _flat(upd["batch_stats"]).items():
        np.testing.assert_allclose(buffers[torch_name(path)].numpy(), s,
                                   **TOL)


@pytest.mark.parametrize("edge_feat,pe_init", [(True, "lap_pe"),
                                               (False, "none")])
def test_bridge_sets_every_transformer_tensor(edge_feat, pe_init):
    """The flax names of a JAX TransformerNet map onto the port's without a
    new rule: load_flax_variables raises on any leaf left over and on any
    port tensor left unset."""
    arrays = _packed()
    net = dict(NET, edge_feat=edge_feat, pe_init=pe_init)
    jm = JM.gnn_model("Transformer", **net)
    jgb = jfrom_arrays(arrays)
    v = jm.init({"params": jax.random.PRNGKey(0)}, jgb, jgb.eigvecs,
                training=False)
    tm = TM.gnn_model("Transformer", **net)
    load_flax_variables(tm, jax.tree.map(np.asarray, v))
    names = dict(tm.named_parameters())
    assert "layer_1.attention.Q.weight" in names
    assert "layer_1.attention.Q.bias" not in names
    assert ("layer_0.attention.E.weight" in names) == edge_feat


@pytest.fixture(scope="module")
def slice_setup():
    arrays = _packed()
    jgb = jfrom_arrays(arrays)
    jm = JM.gnn_model("Transformer", **NET)
    tx = jadam()
    state = create_state(jm, jgb, tx, model_kwargs={"pos_enc": jgb.eigvecs})
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    return dict(arrays=arrays, jgb=jgb, jm=jm, tx=tx, state=state,
                variables=variables)


def _port_model(variables):
    tm = TM.gnn_model("Transformer", **NET)
    load_flax_variables(tm, variables)
    return tm


def test_transformer_train_step_matches_jax_1_and_3_adam_steps(
        slice_setup, tile_dense):
    s = slice_setup
    jgb, state = s["jgb"], s["state"]
    tm = _port_model(s["variables"])
    tgb = from_arrays(s["arrays"])
    predict = jpredict(s["jm"], lap_method="sign_inv")
    tstep, _ = build_steps(tm, make_zinc_predict(tm, "sign_inv"),
                           adam(tm.parameters()))
    key = jax.random.PRNGKey(0)

    def jloss(params):
        pred, _ = predict({"params": params,
                           "batch_stats": state.batch_stats},
                          jgb, True, {"dropout": key}, ["batch_stats"])
        return jl1(pred, jgb)

    jgrads = _flat(jax.grad(jloss)(state.params))
    train_step, _ = jbuild_steps(predict, s["tx"], donate=False)
    jstates, jlosses = [], []
    st = state
    for _ in range(3):
        st, m = train_step(st, jgb, jnp.float32(LR), key)
        jstates.append(st)
        jlosses.append(float(m["loss"]))
    tlosses, tstates = [], []
    for i in range(3):
        tlosses.append(float(tstep(tgb, LR)["loss"]))
        if i == 0:
            tgrads = {n: (torch.zeros_like(p) if p.grad is None
                          else p.grad.clone())
                      for n, p in tm.named_parameters()}
        tstates.append({n: t.detach().clone() for n, t in
                        list(tm.named_parameters())
                        + list(tm.named_buffers())})

    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    for path, g in jgrads.items():
        name = torch_name(path)
        np.testing.assert_allclose(tgrads[name].numpy(), _port_view(path, g),
                                   err_msg=name, **GTOL)
    for step in (1, 3):
        jst, tst = jstates[step - 1], tstates[step - 1]
        for path, a in _flat(jst.params).items():
            name = torch_name(path)
            a = _port_view(path, a)
            d = np.abs(tst[name].numpy() - a)
            noise = np.abs(_port_view(path, jgrads[path])) < 1e-6
            assert d[~noise].max(initial=0) <= 2e-5, (name, step)
            assert d[noise].max(initial=0) <= 2 * LR * step * 1.01, (name,
                                                                     step)
        for path, a in _flat(jst.batch_stats).items():
            name = torch_name(path)
            np.testing.assert_allclose(tst[name].numpy(), a,
                                       atol=1e-5 if step == 1 else 1e-3,
                                       rtol=0, err_msg=f"{name} step {step}")


@pytest.mark.parametrize("bn_mode", ["running", "batch"])
def test_transformer_eval_step_matches_jax(slice_setup, tile_dense, bn_mode):
    s = slice_setup
    tm = _port_model(s["variables"])
    r = np.random.default_rng(1)
    with torch.no_grad():
        for name, b in tm.named_buffers():
            b.copy_(torch.from_numpy(
                (r.random(b.shape) + (0.5 if "var" in name else -0.5))
                .astype(np.float32)))
    bs = {}
    for path, _ in _flat(s["variables"]["batch_stats"]).items():
        node = bs
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(
            dict(tm.named_buffers())[torch_name(path)].numpy())
    state = s["state"].replace(batch_stats=bs)
    predict = jpredict(s["jm"], lap_method="sign_inv")
    _, jeval = jbuild_steps(predict, s["tx"], donate=False,
                            eval_bn_mode=bn_mode)
    a = jax.tree.map(float, jeval(state, s["jgb"]))
    before = {n: b.clone() for n, b in tm.named_buffers()}
    _, teval = build_steps(tm, make_zinc_predict(tm, "sign_inv"),
                           adam(tm.parameters()), eval_bn_mode=bn_mode)
    b = {k: float(v) for k, v in teval(from_arrays(s["arrays"])).items()}
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    for n, t in tm.named_buffers():
        torch.testing.assert_close(t, before[n], rtol=0, atol=0)


def test_transformer_bf16_predict_close_to_jax(slice_setup, tile_dense):
    """Whole-model bf16 compute (params and batch floats cast, BN stats
    f32): the port's bf16 scores within twice JAX's own bf16 error against
    its f32 scores.  The two round at different places: JAX's XLA attention
    rounds each product and sum to bf16, the port's plain version (like
    K2) accumulates in f32."""
    s = slice_setup
    tm = _port_model(s["variables"])
    variables = {"params": s["state"].params,
                 "batch_stats": s["state"].batch_stats}
    rngs = {"dropout": jax.random.PRNGKey(0)}
    a16, _ = jpredict(s["jm"], lap_method="sign_inv",
                      compute_dtype=jnp.bfloat16)(
        variables, s["jgb"], True, rngs, ["batch_stats"])
    a32, _ = jpredict(s["jm"], lap_method="sign_inv")(
        variables, s["jgb"], True, rngs, ["batch_stats"])
    real = s["arrays"]["graph_mask"] > 0
    a16, a32 = np.asarray(a16)[real], np.asarray(a32)[real]
    tm.train()
    b = make_zinc_predict(tm, "sign_inv", compute_dtype=torch.bfloat16)(
        from_arrays(s["arrays"]))
    assert b.dtype == torch.float32 and torch.isfinite(b).all()
    jax_err = np.abs(a16 - a32).max()
    assert 0 < jax_err < 0.1 * np.abs(a32).max()
    assert np.abs(b.detach().numpy()[real] - a16).max() <= 2 * jax_err
    b.sum().backward()
    grads = [p.grad for p in tm.parameters() if p.grad is not None]
    assert grads and all(g.dtype == torch.float32 for g in grads)


def test_train_zinc_runs_transformer_config_on_cpu(tmp_path, monkeypatch):
    """configs/transformer_zinc_signinv_gin.json as shipped (tile_dense),
    cut to a tiny size: every layer's attention goes through the tile-local
    wrapper (on the card, K2 and K3), once per layer per forward."""
    calls = []
    wrapped = tconv.edge_softmax_attention_tiled

    def spy(*args, **kw):
        calls.append(1)
        return wrapped(*args, **kw)

    monkeypatch.setattr(tconv, "edge_softmax_attention_tiled", spy)
    cfg = load_config("configs/transformer_zinc_signinv_gin.json", [
        "train.epochs", "2", "train.batch_size", "8", "data.synth_train",
        "24", "data.synth_eval", "8", "model.n_layers", "2",
        "model.hidden_dim", "16", "model.out_dim", "16", "model.num_heads",
        "4", "model.pos_enc_dim", "4", "model.sign_inv_layers", "2",
        "out_dir", str(tmp_path), "name", "smoke"])
    assert cfg.data.agg_backend == "tile_dense" and cfg.data.tile == 256
    assert cfg.model.layer_norm and not cfg.model.full_graph
    try:
        res = train_zinc.run(cfg, device="cpu", log=lambda m: None)
    finally:
        tseg.set_agg_backend("xla")
    assert res.epochs_run == 2 and res.train_steps >= 4
    assert len(calls) == 2 * (res.train_steps + res.eval_steps)
    assert np.isfinite(res.val_mae) and np.isfinite(res.test_mae)
    assert (tmp_path / "smoke_results.json").exists()


@pytest.mark.parametrize("config,extra", [
    ("transformer_zinc_lappe", ["data.tile", "32", "data.agg_backend",
                                "tile_dense"]),
    ("transformer_zinc_signinv_masked", ["model.sign_inv_layers", "2",
                                         "model.phi_out_dim", "4"])])
def test_train_zinc_runs_the_pe_transformer_configs_on_cpu(
        tmp_path, monkeypatch, config, extra):
    """The LapPE (sign_flip, with the tile overrides that reach the fused
    attention) and masked SignNet (full EVD, k = 37, tile_dense as shipped)
    Transformer configs, cut to width 16: every layer's attention goes
    through the tile-local wrapper (on the card, K2 and K3), once per layer
    per forward; the sign_flip config draws once per eval batch."""
    calls = []
    wrapped = tconv.edge_softmax_attention_tiled

    def spy(*args, **kw):
        calls.append(1)
        return wrapped(*args, **kw)

    monkeypatch.setattr(tconv, "edge_softmax_attention_tiled", spy)
    cfg = load_config(f"configs/{config}.json", extra + [
        "train.epochs", "2", "train.batch_size", "8", "data.synth_train",
        "24", "data.synth_eval", "8", "model.n_layers", "2",
        "model.hidden_dim", "16", "model.out_dim", "16", "model.num_heads",
        "4", "out_dir", str(tmp_path), "name", "smoke"])
    try:
        res = train_zinc.run(cfg, device="cpu", log=lambda m: None)
    finally:
        tseg.set_agg_backend("xla")
    assert res.epochs_run == 2 and res.train_steps >= 4
    assert len(calls) == 2 * (res.train_steps + res.eval_steps)
    assert res.eval_flip_draws == (res.eval_steps
                                   if cfg.model.lap_method == "sign_flip"
                                   else 0)
    assert np.isfinite(res.val_mae) and np.isfinite(res.test_mae)
