"""The third slice: the ZINC GatedGCN + SignNet (GINDeepSigns) path of the
port against the JAX package, under bridged parameters.

Under the `pallas_tile` backend on a tiled batch the JAX `GatedGCNLayer`
runs its fused gate kernel (K4, here in Pallas interpret mode) and the
port's runs `gatedgcn_gate_tiled` (on CPU tensors K4's plain version, with
the JAX backward's formulas); the SignNet phi runs the tile-local SpMM (K1)
on both sides.  Otherwise both take the flat reference form.

Tolerances, float32 (the same as tests/test_torch_train_step.py and
tests/test_torch_transformer.py, for the same reasons):
- layers, 1e-5; their gradients, 1e-4 relative plus 1e-6 or, where larger,
  1e-6 of the layer's largest gradient (a bias that feeds straight into a
  BatchNorm has a gradient that is zero in exact arithmetic);
- the train step: losses 1e-5 relative, gradients at step 1 1e-6 + 1e-4
  relative, BN statistics 1e-5 after step 1 and 1e-3 after step 3,
  parameters 2e-5 after 1 and 3 Adam steps except the elements whose step-1
  gradient is below 1e-6, held to 2 * lr per step;
- bf16: within twice JAX's own bf16 error against its f32 scores.  The JAX
  gate kernel refuses bf16 (tests/test_torch_gatedgcn_gate.py), so the JAX
  side of that test takes the flat path; the port's takes K4's plain
  version in bf16.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from signnet_basisnet_tpu import models as JM
from signnet_basisnet_tpu.graph import from_arrays as jfrom_arrays
from signnet_basisnet_tpu.graph import segment as jseg
from signnet_basisnet_tpu.training import adam as jadam
from signnet_basisnet_tpu.training import build_steps as jbuild_steps
from signnet_basisnet_tpu.training import create_state
from signnet_basisnet_tpu.training import make_zinc_predict as jpredict
from signnet_basisnet_tpu.training.train import l1_graph_loss as jl1

from signnet_basisnet_tpu_torch import models as TM
from signnet_basisnet_tpu_torch import train_zinc
from signnet_basisnet_tpu_torch.bridge import load_flax_variables, torch_name
from signnet_basisnet_tpu_torch.data import (add_lap_pe, choose_budgets,
                                             pack_batches, synthetic_zinc)
from signnet_basisnet_tpu_torch.graph import from_arrays
from signnet_basisnet_tpu_torch.graph import segment as tseg
from signnet_basisnet_tpu_torch.models import conv as tconv
from signnet_basisnet_tpu_torch.nn.init import init_parameters
from signnet_basisnet_tpu_torch.training import (adam, build_steps,
                                                 load_config,
                                                 make_zinc_predict)

import torch_ranks

LR = 1e-3
TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=1e-6)
NET = dict(hidden_dim=16, out_dim=16, n_layers=2, pos_enc_dim=4,
           lap_method="sign_inv", sign_inv_layers=2, phi_out_dim=2,
           pe_aggregate="concat")


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


def _backend(name):
    jseg.set_agg_backend(name)
    tseg.set_agg_backend(name)


@pytest.fixture
def pallas_tile():
    _backend("pallas_tile")
    with pltpu.force_tpu_interpret_mode():
        yield
    _backend("xla")


@pytest.mark.parametrize("backend,features,graph_norm", [
    ("pallas_tile", 16, False), ("xla", 12, True)])
def test_gatedgcn_layer_matches_jax(backend, features, graph_norm):
    """One GatedGCNLayer on both branches: h and e out, BN running
    statistics, and the gradients of every parameter and of h and e.  At
    features 16 the residual adds h and e; at 12 the shapes differ and it
    does not; with graph norm the layer scales h by snorm_n."""
    arrays = _packed()
    n, ne = len(arrays["node_mask"]), len(arrays["senders"])
    r = np.random.default_rng(1)
    h = (r.normal(size=(n, 16)) * arrays["node_mask"][:, None]).astype(
        np.float32)
    e = r.normal(size=(ne, 16)).astype(np.float32)
    c1 = r.normal(size=(n, features)).astype(np.float32)
    c2 = r.normal(size=(ne, features)).astype(np.float32)
    snorm = (r.random((n, 1)) + 0.5).astype(np.float32) if graph_norm \
        else None
    jgb = jfrom_arrays(arrays)
    jl = JM.GatedGCNLayer(features, residual=True, graph_norm=graph_norm)
    jsn = None if snorm is None else jnp.asarray(snorm)
    var = jax.tree.map(np.asarray, jl.init(
        jax.random.PRNGKey(2), jgb, jnp.asarray(h), jnp.asarray(e), jsn,
        training=False))
    tl = tconv.GatedGCNLayer(16, features, residual=True,
                             graph_norm=graph_norm)
    load_flax_variables(tl, var)
    _backend(backend)
    try:
        def loss(params, h, e):
            (ho, eo), upd = jl.apply(
                {"params": params, "batch_stats": var["batch_stats"]}, jgb,
                h, e, jsn, training=True, mutable=["batch_stats"])
            return (ho * c1).sum() + (eo * c2).sum(), (ho, eo, upd)

        with pltpu.force_tpu_interpret_mode():
            (_, (ja, je, upd)), (gp, gh, ge) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True))(
                    var["params"], jnp.asarray(h), jnp.asarray(e))
        th = torch.from_numpy(h).requires_grad_(True)
        te = torch.from_numpy(e).requires_grad_(True)
        ta, tb = tl(from_arrays(arrays), th, te,
                    None if snorm is None else torch.from_numpy(snorm))
        ((ta * torch.from_numpy(c1)).sum()
         + (tb * torch.from_numpy(c2)).sum()).backward()
    finally:
        _backend("xla")
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(tb.detach().numpy(), np.asarray(je), **TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), **GTOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), **GTOL)
    grads = _flat(gp)
    floor = 1e-6 * max(np.abs(g).max() for g in grads.values())
    params = dict(tl.named_parameters())
    assert len(params) == len(grads) == 14
    for path, g in grads.items():
        name = torch_name(path)
        np.testing.assert_allclose(params[name].grad.numpy(),
                                   _port_view(path, g), err_msg=name,
                                   rtol=1e-4, atol=max(floor, 1e-6))
    buffers = dict(tl.named_buffers())
    for path, s in _flat(upd["batch_stats"]).items():
        np.testing.assert_allclose(buffers[torch_name(path)].numpy(), s,
                                   **TOL)


def test_gatedgcn_layer_takes_the_model_parallel_halo(tmp_path):
    """On a one-rank model-parallel shard, with the exchanged rows
    through B and D appended, it equals the layer on the plain batch
    (tests/test_torch_mp_halo.py holds the route across ranks)."""
    arrays = _packed()
    gb = from_arrays(arrays)
    layer = tconv.GatedGCNLayer(16, 16)
    init_parameters(layer, torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(0)
    h = torch.randn(gb.num_nodes, 16, generator=g)
    e = torch.randn(gb.num_edges, 16, generator=g)
    want_h, want_e = layer(gb, h, e)
    with torch_ranks.one_rank_shard(arrays, tmp_path) as shard:
        got_h, got_e = layer(shard, h, torch_ranks.edge_rows(e, shard))
    real = gb.edge_mask > 0
    torch.testing.assert_close(got_h, want_h, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_e[:gb.num_edges][real], want_e[real],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("edge_feat,pe_init", [(True, "lap_pe"),
                                               (False, "none")])
def test_bridge_sets_every_gatedgcn_tensor(edge_feat, pe_init):
    """The flax names of a JAX GatedGCNNet (layer_i/{A..E}, bn_h and bn_e
    with their batch_stats) map onto the port's without a new rule:
    load_flax_variables raises on any leaf left over and on any port tensor
    left unset."""
    arrays = _packed()
    net = dict(NET, edge_feat=edge_feat, pe_init=pe_init)
    jm = JM.gnn_model("GatedGCN", **net)
    jgb = jfrom_arrays(arrays)
    v = jm.init({"params": jax.random.PRNGKey(0)}, jgb, jgb.eigvecs,
                training=False)
    tm = TM.gnn_model("GatedGCN", **net)
    load_flax_variables(tm, jax.tree.map(np.asarray, v))
    names = set(dict(tm.named_parameters())) | set(dict(tm.named_buffers()))
    for i in range(NET["n_layers"]):
        for m in "ABCDE":
            assert {f"layer_{i}.{m}.weight", f"layer_{i}.{m}.bias"} <= names
        for bn in ("bn_h", "bn_e"):
            assert {f"layer_{i}.{bn}.{t}" for t in (
                "weight", "bias", "running_mean", "running_var")} <= names
    assert ("sign_inv_net.enc.conv_1.mlp.lin_0.weight" in names
            ) == (pe_init == "lap_pe")


@pytest.fixture(scope="module")
def slice_setup():
    arrays = _packed()
    jgb = jfrom_arrays(arrays)
    jm = JM.gnn_model("GatedGCN", **NET)
    tx = jadam()
    state = create_state(jm, jgb, tx, model_kwargs={"pos_enc": jgb.eigvecs})
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    return dict(arrays=arrays, jgb=jgb, jm=jm, tx=tx, state=state,
                variables=variables)


def _port_model(variables):
    tm = TM.gnn_model("GatedGCN", **NET)
    load_flax_variables(tm, variables)
    return tm


def test_gatedgcn_train_step_matches_jax_1_and_3_adam_steps(
        slice_setup, pallas_tile):
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

    jgrads = _flat(jax.jit(jax.grad(jloss))(state.params))
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
def test_gatedgcn_eval_step_matches_jax(slice_setup, pallas_tile, bn_mode):
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


def test_gatedgcn_bf16_predict_close_to_jax(slice_setup, monkeypatch):
    """Whole-model bf16 compute (params and batch floats cast, BN stats
    f32): the port's bf16 scores, through K4's plain version in bf16,
    within twice JAX's own bf16 error against its f32 scores.  The two
    round at different places: JAX's flat gate rounds each product and sum
    to bf16, the port's (like K4) computes the gate in f32."""
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
    calls = []
    wrapped = tconv.gatedgcn_gate_tiled

    def spy(*args):
        calls.append(args[0].dtype)
        return wrapped(*args)

    monkeypatch.setattr(tconv, "gatedgcn_gate_tiled", spy)
    tseg.set_agg_backend("pallas_tile")
    try:
        b = make_zinc_predict(tm, "sign_inv", compute_dtype=torch.bfloat16)(
            from_arrays(s["arrays"]))
    finally:
        tseg.set_agg_backend("xla")
    assert calls == [torch.bfloat16] * NET["n_layers"]
    assert b.dtype == torch.float32 and torch.isfinite(b).all()
    jax_err = np.abs(a16 - a32).max()
    assert 0 < jax_err < 0.1 * np.abs(a32).max()
    assert np.abs(b.detach().numpy()[real] - a16).max() <= 2 * jax_err
    b.sum().backward()
    grads = [p.grad for p in tm.parameters() if p.grad is not None]
    assert grads and all(g.dtype == torch.float32 for g in grads)


TILED = ["data.tile", "32", "data.agg_backend", "pallas_tile"]


@pytest.mark.parametrize("config,extra,gate_calls", [
    ("gatedgcn_zinc_signinv_gin", TILED + ["model.pos_enc_dim", "4",
                                           "model.sign_inv_layers", "2"],
     True),
    ("gatedgcn_zinc_nope", [], False),
    ("gatedgcn_zinc_lappe", TILED, True),
    ("gatedgcn_zinc_lappe_abs", [], False),
    ("gatedgcn_zinc_lappe_canonical", TILED, True),
    ("gatedgcn_zinc_rwpe_lspe", TILED, False),
    ("gatedgcn_zinc_signinv_masked", ["data.agg_backend", "pallas_tile",
                                      "model.sign_inv_layers", "2",
                                      "model.phi_out_dim", "8"], True)])
def test_train_zinc_runs_gatedgcn_configs_on_cpu(tmp_path, monkeypatch,
                                                 config, extra, gate_calls):
    """The GatedGCN configs cut to a tiny size.  With the slice's overrides
    every layer's gate goes through the tile-local wrapper (on the card,
    K4), once per layer per forward; the NoPE and abs LapPE configs as
    shipped have no tiles and take the flat gate, and the LSPE layers run
    no gate kernel at all.  The masked config (full EVD, k = 37) is tiled
    as shipped."""
    calls = []
    wrapped = tconv.gatedgcn_gate_tiled

    def spy(*args, **kw):
        calls.append(1)
        return wrapped(*args, **kw)

    monkeypatch.setattr(tconv, "gatedgcn_gate_tiled", spy)
    cfg = load_config(f"configs/{config}.json", extra + [
        "train.epochs", "2", "train.batch_size", "8", "data.synth_train",
        "24", "data.synth_eval", "8", "model.n_layers", "2",
        "model.hidden_dim", "16", "model.out_dim", "16",
        "out_dir", str(tmp_path), "name", "smoke"])
    assert cfg.model.model == "GatedGCN"
    try:
        res = train_zinc.run(cfg, device="cpu", log=lambda m: None)
    finally:
        tseg.set_agg_backend("xla")
    assert res.epochs_run == 2 and res.train_steps >= 4
    assert len(calls) == (2 * (res.train_steps + res.eval_steps)
                          if gate_calls else 0)
    assert np.isfinite(res.val_mae) and np.isfinite(res.test_mae)
    assert (tmp_path / "smoke_results.json").exists()
