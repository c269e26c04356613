"""The GINE-ZINC slice of the port against the JAX package: the GIN-family
convs (`GINConv` with a learnt eps, `GINEConv`, `MaskedGINConv`,
`MaskedGINEConv` and its width check), `SimplifiedPNAConv`, `GNN` under
every `make_conv` type and under mean pooling with the size embedder,
`round_eigvals` and `distinct_eig_stats`, and `SignNetGNN`'s train and eval
steps in the GINE-ZINC trainer's shape, under bridged parameters; then
`train_zinc_gine.run` on the CPU.  The shared helpers and tolerances are
tests/test_torch_alchemy.py's (its docstring says why every eigenvector
entry gets N(0, 1e-2) noise and why the attention dropout is off on both
sides).

Tolerances, float32: `round_eigvals` and `distinct_eig_stats` bit for bit;
the modules' outputs and BN statistics 1e-5; their gradients in f64
against JAX's under x64 (1e-7 relative plus 1e-9 of the largest) and the
port's f32 ones against its f64 ones (1e-4 relative plus the larger of
1e-4 of the largest and twice JAX's largest f32 error on the tensor); the
train step as tests/test_torch_alchemy.py holds it; a resumed run equals
an uninterrupted one within 1e-6.
"""
import json

import jax
import numpy as np
import pytest
import torch

from signnet_basisnet_tpu import models as JM
from signnet_basisnet_tpu.data import zinc as jzinc
from signnet_basisnet_tpu.nn import mlp as jmlp
from signnet_basisnet_tpu.spectral import projectors as jproj
from signnet_basisnet_tpu.train_zinc_gine import \
    distinct_eig_stats as jdistinct

from signnet_basisnet_tpu_torch import models as TM
from signnet_basisnet_tpu_torch import train_zinc_gine
from signnet_basisnet_tpu_torch.data import add_full_evd, synthetic_zinc
from signnet_basisnet_tpu_torch.graph import from_arrays
from signnet_basisnet_tpu_torch.models import conv as tconv
from signnet_basisnet_tpu_torch.nn import mlp as tmlp
from signnet_basisnet_tpu_torch.spectral import round_eigvals
from signnet_basisnet_tpu_torch.training import Checkpointer

from test_torch_alchemy import (jbatch, jx, module_parity, no_jax_dropout,
                                off_the_kink, one_batch)
from test_torch_pe import step_parity

__all__ = ["no_jax_dropout"]  # a fixture, used by name below


def zinc_graphs(n, seed=0, max_nodes=24):
    gs = [g for g in synthetic_zinc(4 * n, 0, 0, seed=seed)["train"]
          if len(g["node_feat"]) <= max_nodes][:n]
    add_full_evd(gs, normalization=None)
    return off_the_kink(gs, seed)


def _inputs(arrays, width=12, seed=4):
    """h [N, width] (zero on padding rows) and e [E, width]."""
    r = np.random.default_rng(seed)
    h = (r.normal(size=(len(arrays["node_mask"]), width))
         * arrays["node_mask"][:, None]).astype(np.float32)
    e = r.normal(size=(len(arrays["senders"]), width)).astype(np.float32)
    return h, e


# ------------------------------------------------------------ host code

def test_round_eigvals_and_distinct_stats_match_jax_bit_for_bit():
    gs = synthetic_zinc(30, 0, 0, seed=3)["train"]
    add_full_evd(gs, normalization=None)
    for g in gs[:5]:
        np.testing.assert_array_equal(round_eigvals(g["eigvals"]),
                                      jproj.round_eigvals(g["eigvals"]))
        np.testing.assert_array_equal(round_eigvals(g["eigvals"], 2),
                                      jproj.round_eigvals(g["eigvals"], 2))
    got = train_zinc_gine.distinct_eig_stats(gs)
    assert got == jdistinct(gs) and 0 < got < 1
    assert train_zinc_gine.distinct_eig_stats([]) == jdistinct([]) == 0


# ---------------------------------------------------------------- convs

@pytest.mark.parametrize("kind", ["gin", "gine"])
def test_pyg_gin_and_gine_convs_match_jax(kind):
    """GINConv (learnt eps, ElementsMLP without norm: biases) and GINEConv
    (learnt eps, normed ElementsMLP) on [N, 12] with padding rows."""
    arrays = one_batch(zinc_graphs(6, seed=1), extra_nodes=5)
    tgb = from_arrays(arrays)
    h, e = _inputs(arrays)
    if kind == "gin":
        jl = JM.GINConv(jmlp.ElementsMLP(12, num_layers=2,
                                         with_final_activation=False,
                                         with_norm=False), learn_eps=True)
        tl = tconv.GINConv(tmlp.ElementsMLP(12, 12, num_layers=2,
                                            with_final_activation=False,
                                            with_norm=False),
                           learn_eps=True)
    else:
        jl = JM.GINEConv(jmlp.ElementsMLP(12, num_layers=2,
                                          with_final_activation=False))
        tl = tconv.GINEConv(tmlp.ElementsMLP(12, 12, num_layers=2,
                                             with_final_activation=False))
    out = module_parity(jl, lambda dt: (jbatch(arrays, dt), jx(h, dt),
                                        jx(e, dt)), tl,
                        lambda dt: (tgb.cast_floats(dt),
                                    torch.from_numpy(h).to(dt))
                        + ((torch.from_numpy(e).to(dt),) if kind == "gine"
                           else ()))
    assert out.shape == h.shape
    assert isinstance(tl.eps, torch.nn.Parameter) and tl.eps.shape == ()


@pytest.mark.parametrize("kind", ["masked_gin", "masked_gine",
                                  "masked_gine_layer0"])
def test_masked_gin_convs_match_jax(kind):
    """The SignNet phi convs on the sign-fused [N, 2k, D] stack with its
    mask: MaskedGINConv on D = 1 (layer 0), MaskedGINEConv on D = 8 and
    on D = 1 against 8-wide encoded edges (layer 0's broadcast)."""
    arrays = one_batch(zinc_graphs(5, seed=2), extra_nodes=4)
    tgb = from_arrays(arrays)
    v = np.concatenate([arrays["eigvecs"], -arrays["eigvecs"]], -1)
    mask = np.concatenate([arrays["eig_mask"]] * 2, -1)
    r = np.random.default_rng(5)
    if kind == "masked_gine":
        x = (r.normal(size=v.shape + (8,)) * mask[..., None]).astype(
            np.float32)
    else:
        x = v[..., None].astype(np.float32)
    e = r.normal(size=(len(arrays["senders"]), 8)).astype(np.float32)
    if kind == "masked_gin":
        jl, tl = JM.MaskedGINConv(8, hidden=8), tconv.MaskedGINConv(
            1, 8, hidden=8)
        targs = lambda dt: (tgb.cast_floats(dt), torch.from_numpy(x).to(dt))
        jargs = lambda dt: (jbatch(arrays, dt), jx(x, dt))
    else:
        jl, tl = JM.MaskedGINEConv(8, hidden=8), tconv.MaskedGINEConv(
            8, 8, hidden=8)
        targs = lambda dt: (tgb.cast_floats(dt), torch.from_numpy(x).to(dt),
                            torch.from_numpy(e).to(dt))
        jargs = lambda dt: (jbatch(arrays, dt), jx(x, dt), jx(e, dt))
    out = module_parity(jl, jargs, tl, targs,
                        jkw=lambda dt: {"mask": jx(mask, dt)},
                        tkw=lambda dt: {"mask": torch.from_numpy(mask)})
    assert (out[torch.from_numpy(mask) == 0] == 0).all()


def test_masked_gine_conv_refuses_other_width_mismatches():
    arrays = one_batch(zinc_graphs(3, seed=3))
    tgb = from_arrays(arrays)
    n, k = arrays["eigvecs"].shape
    conv = tconv.MaskedGINEConv(8, 8)
    e = torch.zeros(len(arrays["senders"]), 8)
    with pytest.raises(ValueError, match="only D=1 may broadcast"):
        conv(tgb, torch.zeros(n, k, 4), e)
    with pytest.raises(ValueError, match="only D=1 may broadcast"):
        JM.MaskedGINEConv(8).init({"params": jax.random.PRNGKey(0)},
                                  jbatch(arrays), jx(np.zeros((n, k, 4))),
                                  jx(np.zeros((len(arrays["senders"]), 8))))


def test_simplified_pna_conv_matches_jax():
    """pre_nn over [x_i, x_j, e], the mean aggregator, the degree embedding
    (a degree past max_degree - 1 clipped: max_degree 3 here), post_nn."""
    arrays = one_batch(zinc_graphs(6, seed=6), extra_nodes=3)
    tgb = from_arrays(arrays)
    h, e = _inputs(arrays, width=10)
    assert np.bincount(arrays["receivers"][arrays["edge_mask"] > 0]
                       ).max() > 2
    module_parity(JM.SimplifiedPNAConv(10, max_degree=3),
                  lambda dt: (jbatch(arrays, dt), jx(h, dt), jx(e, dt)),
                  tconv.SimplifiedPNAConv(10, 10, max_degree=3,
                                          edge_features=10),
                  lambda dt: (tgb.cast_floats(dt), torch.from_numpy(h).to(dt),
                              torch.from_numpy(e).to(dt)))


# ------------------------------------------------------------------ GNN

@pytest.mark.parametrize("gnn_type,pooling", [
    ("GINEConv", "add"), ("GINConv", "add"), ("GCNConv", "add"),
    ("GATConv", "add"), ("SimplifiedPNAConv", "add"), ("GINEConv", "mean")])
def test_gnn_matches_jax(gnn_type, pooling):
    """GNN (2 layers of 12) with the PE merged, under each make_conv type
    (add pooling: the head's BN over every graph slot, the padding one
    included) and under mean pooling with the graph-size embedder (the
    head without norm)."""
    arrays = one_batch(zinc_graphs(5, seed=7), extra_nodes=4,
                       extra_graphs=1)
    tgb = from_arrays(arrays)
    pos, _ = _inputs(arrays, width=12, seed=8)
    kw = dict(gnn_type=gnn_type, pooling=pooling, node_vocab=28,
              edge_vocab=4, use_size_embedder=pooling == "mean")
    tm = TM.GNN(12, 3, 2, additional_features=12, **kw)
    out = module_parity(JM.GNN(12, 3, 2, **kw),
                        lambda dt: (jbatch(arrays, dt), jx(pos, dt)), tm,
                        lambda dt: (tgb.cast_floats(dt),
                                    torch.from_numpy(pos).to(dt)))
    assert out.shape == (len(arrays["graph_mask"]), 3)
    names = set(dict(tm.named_parameters()))
    assert ("size_embedder.weight" in names) == (pooling == "mean")
    assert ("output_encoder.bn_0.weight" in names) == (pooling == "add")


def test_make_conv_refuses_an_unknown_type():
    with pytest.raises(ValueError, match="gnn_type"):
        TM.make_conv("GraphSAGE", 8, True)


# ------------------------------------------------------------ the step

GINE_NET = dict(n_hid=16, n_out=1, nl_signnet=2, nl_gnn=2, nl_rho=1,
                ignore_eigval=True, gnn_type="GINEConv", node_vocab=28,
                edge_vocab=4)


@pytest.mark.parametrize("phi", ["MaskedGINConv", "MaskedGINEConv"])
def test_gine_zinc_signnetgnn_steps_match_jax(phi, no_jax_dropout):
    """train_zinc_gine's net (eigenvalues ignored, a 1-layer rho, GINE
    base, one target) at width 16 and 2 layers on an all-n batch with
    padding: one Adam step and an eval step, attention dropout off."""
    arrays = one_batch(zinc_graphs(7, seed=9), extra_nodes=4)
    net = dict(GINE_NET, phi_gnn_type=phi)

    def port():
        m = TM.SignNetGNN(**net)
        TM.set_attention_dropout(m, 0.0)
        return m

    jres, tres = step_parity(None, None, arrays, "none", steps=1,
                             modules=(JM.SignNetGNN(**net), port),
                             exact_grads=True)
    assert jres["loss_sum"] == pytest.approx(jres["mae_sum"])


# --------------------------------------------------------- the trainer

def _gine_args(tmp_path, epochs, name, *extra):
    return train_zinc_gine.build_parser().parse_args([
        "--device", "cpu", "--epochs", str(epochs), "--batch_size", "8",
        "--synth_train", "24", "--synth_eval", "8", "--hidden", "8",
        "--nl_signnet", "2", "--nl_gnn", "2", "--lr_step", "1",
        "--data_dir", str(tmp_path / "none"), "--log_every", "1",
        "--out_dir", str(tmp_path / name), *extra])


def test_train_zinc_gine_resumes_as_an_uninterrupted_run(tmp_path):
    """train_zinc_gine.run at width 8 on the CPU (StepLR halving every
    epoch): 1 epoch, then resumed to 2, against 2 epochs in one run,
    within 1e-6: the checkpoint carries best_val, best_test and the
    dropout generator, and StepLR is replayed to the start epoch.  The
    GINE phi too."""
    quiet = lambda m: None
    ck = str(tmp_path / "ck")
    whole = train_zinc_gine.run(_gine_args(tmp_path, 2, "a"), log=quiet)
    train_zinc_gine.run(_gine_args(tmp_path, 1, "b", "--ckpt_dir", ck),
                        log=quiet)
    saved = Checkpointer(ck).restore()
    assert {"best_val", "best_test", "dropout_rng"} <= set(saved)
    resumed = train_zinc_gine.run(_gine_args(
        tmp_path, 2, "c", "--ckpt_dir", ck, "--resume"), log=quiet)
    read = lambda n: json.load(open(tmp_path / n / "zinc_gine_s0.json"))
    a, b, c = read("a"), read("b"), read("c")
    assert [h["epoch"] for h in c["history"]] == [1]
    assert [h["lr"] for h in a["history"]] == [5e-4, 2.5e-4]
    for got, want in zip(b["history"] + c["history"], a["history"]):
        for k in ("lr", "train_loss", "val_mae", "best_val", "best_test"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    np.testing.assert_allclose(resumed, whole, rtol=1e-6)
    assert np.isfinite(whole) and whole == a["test_at_best_val"]
    gine = train_zinc_gine.run(_gine_args(
        tmp_path, 1, "d", "--phi_gnn_type", "MaskedGINEConv"), log=quiet)
    assert np.isfinite(gine)


def test_train_zinc_gine_reads_the_zinc_pickles(tmp_path):
    """The real-format pickles of tests/fixtures/zinc_pkl (subset .index
    files) instead of the stand-in."""
    import os
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures", "zinc_pkl")
    lines = []
    args = _gine_args(tmp_path, 1, "p")
    args.data_dir = fixtures
    res = train_zinc_gine.run(args, log=lines.append)
    assert lines[0] == "dataset: ZINC (real)" and np.isfinite(res)


def test_train_zinc_gine_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = train_zinc_gine.build_parser().parse_args([])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_zinc_gine.run(args, log=lambda m: None)


def test_jax_zinc_synthetic_graphs_are_the_ports():
    """The GINE-ZINC trainer's stand-in is the ZINC one of both packages."""
    t = synthetic_zinc(5, 2, 2, seed=4)
    j = jzinc.synthetic_zinc(5, 2, 2, seed=4)
    for split in t:
        for a, b in zip(t[split], j[split]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
