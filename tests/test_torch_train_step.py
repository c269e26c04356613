"""The whole slice: the GIN + SignNet (GINDeepSigns) ZINC train step of the
port against the JAX `train_step`, under bridged parameters, with the
`pallas_tile` aggregation backend on both sides (the JAX kernel in Pallas
interpret mode, the port's wrapper on CPU tensors = its plain version).

Tolerances, float32:
- losses, 1e-5 relative; gradients at step 1, 1e-6 + 1e-4 relative;
- BN running statistics after step 1, 1e-5;
- parameters after 1 and 3 Adam steps, 2e-5, except the elements whose
  step-1 gradient is below 1e-6 (zero in exact arithmetic, e.g. a bias that
  feeds straight into a BatchNorm): there Adam's m/sqrt(v) turns float noise
  into a step of up to lr in either direction, so two correct trajectories
  may differ by up to 2*lr per step;
- BN running statistics after 3 steps, 1e-3: they see the forward of the
  drifted elements above.

The batch holds an odd number of graphs: with an even count and half the
residuals positive, the L1 gradient of the output bias is exactly zero, the
same Adam noise moves every prediction by up to lr, and the two trajectories
part at the next step for a reason that is no fault of either package.
"""
import os

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
from signnet_basisnet_tpu_torch.parallel.mesh import spawn_ranks
from signnet_basisnet_tpu_torch.training import (adam, build_steps,
                                                 load_config,
                                                 make_zinc_predict)

import torch_ranks

LR = 1e-3
NET = dict(hidden_dim=12, out_dim=12, n_layers=3, pos_enc_dim=4,
           lap_method="sign_inv", sign_inv_layers=2, phi_out_dim=2,
           pe_aggregate="concat", dropout=0.0)


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


@pytest.fixture(scope="module")
def slice_setup():
    gs = synthetic_zinc(13, 0, 0, seed=0)["train"]
    add_lap_pe(gs, NET["pos_enc_dim"])
    nb, eb, gc = choose_budgets(gs, len(gs), tile=64)
    arrays = pack_batches(gs, nb, eb, gc, k=NET["pos_enc_dim"], tile=64)[0]
    jgb = jfrom_arrays(arrays)
    jm = JM.gnn_model("GIN", **NET)
    tx = jadam()
    state = create_state(jm, jgb, tx, model_kwargs={"pos_enc": jgb.eigvecs})
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    return dict(arrays=arrays, jgb=jgb, jm=jm, tx=tx, state=state,
                variables=variables)


def _port_model(variables):
    tm = TM.gnn_model("GIN", **NET)
    load_flax_variables(tm, variables)
    return tm


def test_slice_train_step_matches_jax_1_and_3_adam_steps(slice_setup):
    s = slice_setup
    jgb, state = s["jgb"], s["state"]
    tm = _port_model(s["variables"])
    tgb = from_arrays(s["arrays"])
    predict = jpredict(s["jm"], lap_method="sign_inv")
    opt = adam(tm.parameters())
    tstep, _ = build_steps(tm, make_zinc_predict(tm, "sign_inv"), opt)
    key = jax.random.PRNGKey(0)

    def jloss(params):
        pred, _ = predict({"params": params,
                           "batch_stats": state.batch_stats},
                          jgb, True, {"dropout": key}, ["batch_stats"])
        return jl1(pred, jgb)

    jseg.set_agg_backend("pallas_tile")
    tseg.set_agg_backend("pallas_tile")
    try:
        with pltpu.force_tpu_interpret_mode():
            jgrads = _flat(jax.jit(jax.grad(jloss))(state.params))
            train_step, _ = jbuild_steps(predict, s["tx"], donate=False)
            jstates, jlosses = [], []
            st = state
            for _ in range(3):
                st, m = train_step(st, jgb, jnp.float32(LR), key)
                jstates.append(st)
                jlosses.append(float(m["loss"]))
        tlosses = []
        tstates = []
        for i in range(3):
            tlosses.append(float(tstep(tgb, LR)["loss"]))
            if i == 0:
                tgrads = {n: (torch.zeros_like(p) if p.grad is None
                              else p.grad.clone())
                          for n, p in tm.named_parameters()}
            tstates.append({n: t.detach().clone() for n, t in
                            list(tm.named_parameters())
                            + list(tm.named_buffers())})
    finally:
        jseg.set_agg_backend("xla")
        tseg.set_agg_backend("xla")

    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    for path, g in jgrads.items():
        np.testing.assert_allclose(tgrads[torch_name(path)].numpy(),
                                   _port_view(path, g), rtol=1e-4, atol=1e-6,
                                   err_msg=torch_name(path))
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
def test_slice_eval_step_matches_jax(slice_setup, bn_mode):
    s = slice_setup
    jgb = s["jgb"]
    tm = _port_model(s["variables"])
    # non-trivial running statistics
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
    a = jax.tree.map(float, jeval(state, jgb))
    before = {n: b.clone() for n, b in tm.named_buffers()}
    _, teval = build_steps(tm, make_zinc_predict(tm, "sign_inv"),
                           adam(tm.parameters()), eval_bn_mode=bn_mode)
    b = {k: float(v) for k, v in teval(from_arrays(s["arrays"])).items()}
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    for n, t in tm.named_buffers():     # eval never moves running stats
        torch.testing.assert_close(t, before[n], rtol=0, atol=0)


def test_slice_bf16_predict_close_to_jax(slice_setup):
    """Whole-model bf16 compute (params and batch floats cast, BN stats
    f32).  The two packages round at different places, so the port's bf16
    scores are held to JAX's bf16 scores within twice JAX's own bf16 error
    against its f32 scores."""
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


def test_train_zinc_runs_flagship_config_on_cpu(tmp_path):
    cfg = load_config("configs/gin_zinc_signinv_gin.json", [
        "data.agg_backend", "pallas_tile", "train.epochs", "2",
        "train.batch_size", "8", "data.synth_train", "24",
        "data.synth_eval", "8", "model.n_layers", "2", "model.hidden_dim",
        "8", "model.out_dim", "8", "model.sign_inv_layers", "2",
        "out_dir", str(tmp_path), "name", "smoke"])
    assert cfg.data.tile == 256 and cfg.model.pe_aggregate == "concat"
    try:
        res = train_zinc.run(cfg, device="cpu", log=lambda m: None)
    finally:
        tseg.set_agg_backend("xla")
    assert res.epochs_run == 2 and res.train_steps >= 4
    assert np.isfinite(res.val_mae) and np.isfinite(res.test_mae)
    assert (tmp_path / "smoke_results.json").exists()


@pytest.mark.parametrize("override", [
    ["model.sign_inv_net", "masked_gin"], ["model.lap_method", "sign_flip"]])
def test_train_zinc_runs_the_flagship_with_the_pe_options_on_cpu(tmp_path,
                                                                override):
    """The masked SignNet (on the flagship's k = 8 Laplacian PE) and the
    sign_flip baseline on the flagship config, through the tile-local SpMM
    (plain here): each runs, and sign_flip flips once per train step and
    once per eval batch."""
    cfg = load_config("configs/gin_zinc_signinv_gin.json", override + [
        "data.agg_backend", "pallas_tile", "train.epochs", "2",
        "train.batch_size", "8", "data.synth_train", "24",
        "data.synth_eval", "8", "model.n_layers", "2", "model.hidden_dim",
        "8", "model.out_dim", "8", "model.sign_inv_layers", "2",
        "out_dir", str(tmp_path), "name", "smoke"])
    try:
        res = train_zinc.run(cfg, device="cpu", log=lambda m: None)
    finally:
        tseg.set_agg_backend("xla")
    assert res.epochs_run == 2 and res.train_steps >= 4
    assert res.eval_flip_draws == (res.eval_steps
                                   if cfg.model.lap_method == "sign_flip"
                                   else 0)
    assert np.isfinite(res.val_mae) and np.isfinite(res.test_mae)


@pytest.mark.parametrize("override,match", [
    (["train.num_microbatches", "2"], "JAX train_zinc never reads it"),
    (["model.model", "Transformer", "model.full_graph", "true"],
     "never calls data/transforms.py make_full_graph")])
def test_train_zinc_refuses_unported_options(override, match):
    cfg = load_config("configs/gin_zinc_signinv_gin.json", override + [
        "data.synth_train", "8", "data.synth_eval", "4",
        "model.n_layers", "1", "model.hidden_dim", "4", "model.out_dim", "4",
        "model.sign_inv_layers", "1", "out_dir", ""])
    with pytest.raises(NotImplementedError, match=match):
        train_zinc.run(cfg, device="cpu", log=lambda m: None)


@pytest.mark.parametrize("config", [
    "pna_zinc_nope", "pna_zinc_lappe", "pna_zinc_signinv_gin",
    "pna_zinc_signinv_masked", "gat_zinc_nope", "gat_zinc_lappe",
    "gat_zinc_signinv_gin"])
def test_train_zinc_runs_the_pna_and_gat_configs_on_cpu(config, tmp_path):
    """Each PNA and GAT config as shipped (the masked PNA one on its full
    EVDs, tiled, `tile_dense`), cut to width 8, one layer, one SignNet
    layer, 8 graphs a split and one epoch."""
    logs = []
    cfg = load_config(f"configs/{config}.json", [
        "train.epochs", "1", "train.batch_size", "8", "data.synth_train",
        "8", "data.synth_eval", "8", "model.n_layers", "1",
        "model.hidden_dim", "8", "model.out_dim", "8",
        "model.sign_inv_layers", "1", "out_dir", str(tmp_path)])
    res = train_zinc.run(cfg, device="cpu", log=logs.append)
    assert np.isfinite(res.val_mae) and np.isfinite(res.test_mae)
    assert any(f"model: {cfg.model.model} " in m for m in logs)


MP_RUN = ["train.epochs", "2", "train.batch_size", "8", "data.synth_train",
          "32", "data.synth_eval", "8", "model.n_layers", "2",
          "model.hidden_dim", "8", "model.out_dim", "8",
          "model.sign_inv_layers", "2", "out_dir", ""]


def test_train_zinc_trains_model_parallel_on_cpu_ranks(tmp_path):
    """train.mp 2 on two gloo ranks (the flagship config at width 8, 2
    epochs): the shards' budgets are logged by rank 0 alone, both ranks
    end with the same history, and it is the single-device run's within
    1e-4 (the mp step is the single-device step up to f32 rounding, which
    Adam turns into steps of up to lr on the weights whose exact gradient
    is 0: the runs part by 2e-5 here); the checkpoint directory holds the
    last epoch's state, written by rank 0.  In a process outside a world
    of two ranks it refuses."""
    cfg = load_config("configs/gin_zinc_signinv_gin.json", MP_RUN)
    try:
        single = train_zinc.run(cfg, device="cpu", log=lambda m: None)
    finally:
        tseg.set_agg_backend("xla")
    case = dict(kind="train_zinc", config="configs/gin_zinc_signinv_gin.json",
                overrides=MP_RUN + [
                    "train.mp", "2", "train.keep_checkpoints", "1",
                    "train.checkpoint_dir", str(tmp_path / "ckpt")])
    ranks = spawn_ranks(torch_ranks.run_cases, 2, ([case],), device="cpu",
                        timeout=300)
    (r0,), (r1,) = ranks
    assert any(m.startswith("mp=2: edge shard ") for m in r0["logs"])
    key = ("train_loss", "train_mae", "val_loss", "val_mae", "lr")
    hist = lambda h: [[rec[k] for k in key] for rec in h]
    assert r1["logs"] == [] and hist(r1["history"]) == hist(r0["history"])
    np.testing.assert_allclose(hist(r0["history"]), hist(single.history),
                               rtol=1e-4)
    np.testing.assert_allclose([r0["val_mae"], r0["test_mae"]],
                               [single.val_mae, single.test_mae], rtol=1e-4)
    assert os.listdir(tmp_path / "ckpt") == ["epoch_1.pt"]
    mp_cfg = load_config("configs/gin_zinc_signinv_gin.json",
                         MP_RUN + ["train.mp", "2"])
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        train_zinc.run(mp_cfg, device="cpu", log=lambda m: None)
