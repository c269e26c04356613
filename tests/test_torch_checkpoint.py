"""What train_zinc took on in the port's eighth slice, on the CPU:
checkpoints and resume, the real ZINC pickles, StepLR, dropout, the
eval_bn_mode gate and the matmul precisions, against the JAX package where
it has a counterpart.

Tolerances: a resumed run against an uninterrupted one, 1e-6 (the same
float ops in the same order: only the process state in between differs);
the loaders and StepLR, exact; the forward at dropout rate 0 against JAX
under bridged weights, 1e-5 relative (f32 sums in other orders); the
dropped share at rate 0.3 over 10^5 units, 0.3 +- 0.03 (about 20 standard
deviations of a binomial share, so a correct draw fails it with
negligible probability).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from signnet_basisnet_tpu import models as JM
from signnet_basisnet_tpu.data.zinc import load_zinc_pickle as jload_pickle
from signnet_basisnet_tpu.graph import from_arrays as jfrom_arrays
from signnet_basisnet_tpu.training import adam as jadam
from signnet_basisnet_tpu.training import create_state
from signnet_basisnet_tpu.training import make_zinc_predict as jpredict
from signnet_basisnet_tpu.training.optim import StepLR as JStepLR

from signnet_basisnet_tpu_torch import models as TM
from signnet_basisnet_tpu_torch import train_zinc
from signnet_basisnet_tpu_torch.bridge import load_flax_variables
from signnet_basisnet_tpu_torch.data import (add_lap_pe, choose_budgets,
                                             load_zinc, load_zinc_pickle,
                                             pack_batches, synthetic_zinc)
from signnet_basisnet_tpu_torch.graph import from_arrays
from signnet_basisnet_tpu_torch.nn.dropout import Dropout, DropoutRNG
from signnet_basisnet_tpu_torch.training import (Checkpointer, StepLR, adam,
                                                 load_config,
                                                 load_train_state,
                                                 make_zinc_predict,
                                                 train_state)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
TINY = ["data.synth_train", "24", "data.synth_eval", "8",
        "train.batch_size", "8", "model.n_layers", "2", "model.hidden_dim",
        "8", "model.out_dim", "8", "model.sign_inv_layers", "2",
        "model.pos_enc_dim", "4", "train.print_epoch_interval", "100"]


def _cfg(tmp_path, *extra):
    return load_config("configs/gin_zinc_signinv_gin.json", TINY + [
        "out_dir", str(tmp_path), *extra])


def _quiet(msg):
    pass


def test_resume_continues_as_an_uninterrupted_run(tmp_path):
    whole = train_zinc.run(_cfg(tmp_path, "train.epochs", "4", "name", "a",
                                "train.checkpoint_dir",
                                str(tmp_path / "a")),
                           device="cpu", log=_quiet)
    first = train_zinc.run(_cfg(tmp_path, "train.epochs", "2", "name", "b",
                                "train.checkpoint_dir",
                                str(tmp_path / "b")),
                           device="cpu", log=_quiet)
    logs = []
    resumed = train_zinc.run(_cfg(tmp_path, "train.epochs", "4", "name", "b",
                                  "train.checkpoint_dir",
                                  str(tmp_path / "b"), "train.resume",
                                  "true"),
                             device="cpu", log=logs.append)
    assert any("resumed from checkpoint epoch 1" in m for m in logs), logs
    assert [h["epoch"] for h in first.history] == [0, 1]
    assert [h["epoch"] for h in resumed.history] == [2, 3]
    assert resumed.epochs_run == whole.epochs_run == 4
    for got, want in zip(first.history + resumed.history, whole.history):
        for k in ("epoch", "lr", "train_loss", "train_mae", "val_loss",
                  "val_mae"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    np.testing.assert_allclose(resumed.test_mae, whole.test_mae, rtol=1e-6)
    with open(tmp_path / "b_results.json") as f:
        assert json.load(f)["epochs"] == 4


def test_resume_restores_the_saved_lr_and_epoch(tmp_path):
    cfg = _cfg(tmp_path, "train.epochs", "1", "train.checkpoint_dir",
               str(tmp_path / "c"))
    train_zinc.run(cfg, device="cpu", log=_quiet)
    ck = Checkpointer(str(tmp_path / "c"))
    state = ck.restore()
    assert state["epoch"] == 0 and ck.latest_step() == 0
    state["lr"] = 2.5e-4
    ck.save(0, state)
    res = train_zinc.run(_cfg(tmp_path, "train.epochs", "2",
                              "train.checkpoint_dir", str(tmp_path / "c"),
                              "train.resume", "true"),
                         device="cpu", log=_quiet)
    assert [h["epoch"] for h in res.history] == [1]
    assert res.history[0]["lr"] == pytest.approx(2.5e-4)


def test_checkpointer_keeps_the_last_n(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    assert ck.latest_step() is None and ck.restore() is None
    for step in range(5):
        ck.save(step, {"epoch": step, "x": torch.full((3,), float(step))})
    assert ck.steps() == [3, 4] and ck.latest_step() == 4
    assert torch.equal(ck.restore()["x"], torch.full((3,), 4.0))
    assert ck.restore(3)["epoch"] == 3
    assert sorted(os.listdir(tmp_path)) == ["epoch_3.pt", "epoch_4.pt"]
    res = train_zinc.run(_cfg(tmp_path, "train.epochs", "3",
                              "train.checkpoint_dir", str(tmp_path / "k"),
                              "train.keep_checkpoints", "1"),
                         device="cpu", log=_quiet)
    assert res.epochs_run == 3
    assert Checkpointer(str(tmp_path / "k")).steps() == [2]


def test_train_state_round_trip_in_place(tmp_path):
    """Parameters, BN statistics, Adam's moments and step, the LR and the
    dropout generator come back into the same tensors."""
    net = dict(hidden_dim=8, out_dim=8, n_layers=2, pos_enc_dim=4,
               lap_method="sign_inv", sign_inv_layers=2, phi_out_dim=2,
               dropout=0.2, seed=3)
    gs = synthetic_zinc(10, 0, 0, seed=0)["train"]
    add_lap_pe(gs, 4)
    nb, eb, gc = choose_budgets(gs, 10)
    gb = from_arrays(pack_batches(gs, nb, eb, gc, k=4)[0])
    m1 = TM.gnn_model("GIN", **net)
    o1 = adam(m1.parameters())
    from signnet_basisnet_tpu_torch.training import build_steps
    step = build_steps(m1, make_zinc_predict(m1, "sign_inv"), o1)[0]
    for _ in range(2):
        step(gb, 1e-3)
    ck = Checkpointer(str(tmp_path))
    ck.save(7, train_state(m1, o1, 5e-4, 7))
    m2 = TM.gnn_model("GIN", **dict(net, seed=4))
    o2 = adam(m2.parameters())
    build_steps(m2, make_zinc_predict(m2, "sign_inv"), o2)[0](gb, 1e-3)
    assert load_train_state(m2, o2, ck.restore()) == 5e-4
    for (n, a), (_, b) in zip(m1.state_dict().items(),
                              m2.state_dict().items()):
        assert torch.equal(a, b), n
    assert len(o1.state) == len(o2.state) > 0
    for p1, p2 in zip(m1.parameters(), m2.parameters()):
        assert (p1 in o1.state) == (p2 in o2.state)
        for k in o1.state[p1] if p1 in o1.state else ():
            assert torch.equal(o1.state[p1][k], o2.state[p2][k]), k
    assert torch.equal(m1.dropout_rng.generator.get_state(),
                       m2.dropout_rng.generator.get_state())


@pytest.mark.parametrize("name,subset", [("zinc_pkl", True),
                                         ("zinc_split", True),
                                         ("zinc_split", False)])
def test_load_zinc_pickle_matches_the_jax_loader(name, subset):
    d = os.path.join(FIXTURES, name)
    want = jload_pickle(d, subset=subset)
    got = load_zinc_pickle(d, subset=subset)
    assert got.keys() == want.keys()
    for split in want:
        assert len(got[split]) == len(want[split]) > 0
        for g, w in zip(got[split], want[split]):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                assert g[k].dtype == w[k].dtype
    splits, real = load_zinc(d, subset=subset)
    assert real and len(splits["train"]) == len(want["train"])


def test_train_zinc_reads_the_fixture_pickles(tmp_path):
    logs = []
    res = train_zinc.run(_cfg(tmp_path, "train.epochs", "1", "data.data_dir",
                              os.path.join(FIXTURES, "zinc_split"),
                              "data.subset", "true"),
                         device="cpu", log=logs.append)
    assert any("ZINC (real) train=4 val=4 test=4" in m for m in logs), logs
    assert np.isfinite(res.test_mae)


@pytest.mark.parametrize("step_size,gamma", [(3, 0.5), (1, 0.9), (5, 0.1)])
def test_steplr_sequence_matches_jax(step_size, gamma):
    j, t = JStepLR(step_size, gamma, lr=1e-3), StepLR(step_size, gamma,
                                                     lr=1e-3)
    assert [t.step() for _ in range(12)] == [j.step() for _ in range(12)]
    assert not t.converged


@pytest.mark.parametrize("model", ["GIN", "GatedGCN"])
def test_dropout_rate_zero_matches_jax_under_bridged_weights(model):
    net = dict(hidden_dim=16, out_dim=16, n_layers=2, pos_enc_dim=4,
               lap_method="sign_inv", sign_inv_layers=2, phi_out_dim=2,
               dropout=0.0, in_feat_dropout=0.0)
    gs = synthetic_zinc(9, 0, 0, seed=2)["train"]
    add_lap_pe(gs, 4)
    nb, eb, gc = choose_budgets(gs, len(gs))
    arrays = pack_batches(gs, nb, eb, gc, k=4)[0]
    jgb = jfrom_arrays(arrays)
    jm = JM.gnn_model(model, **net)
    state = create_state(jm, jgb, jadam(),
                         model_kwargs={"pos_enc": jgb.eigvecs})
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    want, _ = jpredict(jm, lap_method="sign_inv")(
        variables, jgb, True, {"dropout": jax.random.PRNGKey(1)},
        ["batch_stats"])
    tm = TM.gnn_model(model, **net)
    load_flax_variables(tm, variables)
    tm.train()
    got = make_zinc_predict(tm, "sign_inv")(from_arrays(arrays))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert tm.dropout_rng.generator is None  # rate 0 draws nothing


def test_dropout_drops_its_rate_in_distribution():
    rng = DropoutRNG(0)
    drop = Dropout(0.3, rng).train()
    y = drop(torch.ones(100_000))
    dropped = float((y == 0).float().mean())
    assert abs(dropped - 0.3) < 0.03
    kept = y[y != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.7))
    assert not torch.equal(y, drop(torch.ones(100_000)))  # a fresh mask
    assert torch.equal(drop.eval()(torch.ones(5)), torch.ones(5))
    again = Dropout(0.3, DropoutRNG(0)).train()(torch.ones(100_000))
    assert torch.equal(y, again)  # one seed, one mask
    with pytest.raises(ValueError):
        Dropout(0.3)


def test_a_model_with_dropout_trains_through_train_zinc(tmp_path):
    res = train_zinc.run(_cfg(tmp_path, "train.epochs", "1", "model.dropout",
                              "0.2", "model.in_feat_dropout", "0.1"),
                         device="cpu", log=_quiet)
    assert np.isfinite(res.test_mae)


@pytest.mark.parametrize("knob", ["model.dropout", "model.in_feat_dropout"])
def test_batch_stat_eval_refuses_dropout_as_the_jax_trainer(tmp_path, knob):
    cfg = _cfg(tmp_path, "train.epochs", "1", "train.eval_bn_mode", "batch",
               knob, "0.1")
    with pytest.raises(ValueError, match="eval_bn_mode='batch' requires "
                                         "dropout=0 and in_feat_dropout=0"):
        train_zinc.run(cfg, device="cpu", log=_quiet)


@pytest.mark.parametrize("name,want", sorted(
    train_zinc.MATMUL_PRECISION.items(), key=str))
def test_matmul_precision_maps_and_is_restored(name, want):
    before = torch.get_float32_matmul_precision()
    with train_zinc.matmul_precision(name):
        assert torch.get_float32_matmul_precision() == want
        assert torch.backends.cudnn.allow_tf32 == (want != "highest")
    assert torch.get_float32_matmul_precision() == before


def test_matmul_precision_refuses_names_without_a_counterpart(tmp_path):
    before = torch.get_float32_matmul_precision()
    with pytest.raises(NotImplementedError, match="no torch counterpart"):
        train_zinc.run(_cfg(tmp_path, "train.matmul_precision", "fastest"),
                       device="cpu", log=_quiet)
    res = train_zinc.run(_cfg(tmp_path, "train.epochs", "1",
                              "train.matmul_precision", "tensorfloat32"),
                         device="cpu", log=_quiet)
    assert np.isfinite(res.test_mae)
    assert torch.get_float32_matmul_precision() == before
