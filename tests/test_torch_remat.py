"""Remat (`model.remat`): each conv layer of GIN, GatedGCN, PNA and the
Transformer under `nn.remat.checkpoint`, its activations recomputed in
the backward pass, as the JAX nets wrap the same layers in `nn.remat`.

A remat train step must equal the plain one from the same weights: the
loss, every gradient, the BatchNorm running statistics (which move once:
the recompute leaves them alone) and the parameters after Adam, with
dropout 0 and 0.1 (the recompute replays the layer's dropout masks from
the model's generator, which ends where the plain step leaves it).  The
recompute runs the same ops on the same inputs, so the two agree to
float32 rounding of a reordered backward at most: 1e-6 relative plus
1e-7 of the tensor's largest.  Against JAX (its `nn.remat` GIN, as
tests/test_gap_components.py:238 holds remat to plain) the train and
eval steps are held as tests/test_torch_pe.py's `step_parity` holds
them.  Names do not change with remat, so a checkpoint loads either way;
a kernel the layer launches (K1, K2, K4) launches again in the recompute.
"""
import numpy as np
import pytest
import torch

from signnet_basisnet_tpu_torch import models as TM
from signnet_basisnet_tpu_torch import train_zinc
from signnet_basisnet_tpu_torch.data import add_lap_pe
from signnet_basisnet_tpu_torch.graph import from_arrays
from signnet_basisnet_tpu_torch.graph import segment as tseg
from signnet_basisnet_tpu_torch.models import conv as tconv
from signnet_basisnet_tpu_torch.nn import remat
from signnet_basisnet_tpu_torch.training import (adam, build_steps,
                                                 capture_train_step,
                                                 load_config,
                                                 make_zinc_predict)

from test_torch_pe import packed, small_graphs, step_parity

K = 4
PE = dict(pos_enc_dim=K, lap_method="sign_inv", sign_inv_layers=2,
          phi_out_dim=2)
NETS = {
    "GIN": (dict(hidden_dim=12, out_dim=12, **PE), "pallas_tile"),
    "GatedGCN": (dict(hidden_dim=12, out_dim=12, **PE), "pallas_tile"),
    "Transformer": (dict(hidden_dim=16, out_dim=16, num_heads=4,
                         layer_norm=True, **PE), "tile_dense"),
    "PNA": (dict(hidden_dim=16, out_dim=16, towers=2, pe_init="none"),
            "xla"),
}
# the wrapper of each net's layer kernel, called once per layer forward
KERNEL_CALL = {"GIN": "spmm_tiled", "GatedGCN": "gatedgcn_gate_tiled",
               "Transformer": "edge_softmax_attention_tiled"}


@pytest.fixture(scope="module")
def arrays():
    gs = small_graphs(8, max_nodes=24, seed=5)
    add_lap_pe(gs, K)
    return packed(gs, K)


@pytest.fixture
def backend():
    yield tseg.set_agg_backend
    tseg.set_agg_backend("xla")


def _step(name, arrays, remat_on, dropout, spy=None):
    """One train step of a fresh net (seed 0): (loss, gradients, state
    after Adam, the dropout generator's state after the step, the kernel
    wrapper's calls)."""
    kw, _ = NETS[name]
    model = TM.gnn_model(name, n_layers=2, dropout=dropout, remat=remat_on,
                         seed=0, **kw)
    opt = adam(model.parameters())
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.clone()))
        for n, p in model.named_parameters()]
    step = build_steps(model, make_zinc_predict(model, model.lap_method),
                       opt)[0]
    loss = float(step(from_arrays(arrays), 1e-3)["loss"])
    for h in hooks:
        h.remove()
    state = {n: t.detach().clone() for n, t in
             list(model.named_parameters()) + list(model.named_buffers())}
    gen = model.dropout_rng.generator
    return loss, grads, state, None if gen is None else gen.get_state()


def _close(a, b, what):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                               atol=1e-7 * max(float(b.abs().max()), 1.0),
                               err_msg=what)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("name", list(NETS))
def test_remat_step_equals_the_plain_step(name, dropout, arrays, backend):
    backend(NETS[name][1])
    loss0, grads0, state0, gen0 = _step(name, arrays, False, dropout)
    loss1, grads1, state1, gen1 = _step(name, arrays, True, dropout)
    np.testing.assert_allclose(loss1, loss0, rtol=1e-6)
    assert grads1.keys() == grads0.keys() and len(grads0) > 10
    for n in grads0:
        _close(grads1[n], grads0[n], f"grad {n}")
    assert state1.keys() == state0.keys()
    for n in state0:   # parameters after Adam, BN running statistics
        _close(state1[n], state0[n], n)
    if dropout:
        assert gen0 is not None and torch.equal(gen1, gen0)


@pytest.mark.parametrize("name", list(NETS))
def test_remat_keeps_every_tensor_name(name):
    kw, _ = NETS[name]
    plain = TM.gnn_model(name, n_layers=2, **kw).state_dict()
    rm = TM.gnn_model(name, n_layers=2, remat=True, **kw)
    assert rm.state_dict().keys() == plain.keys()
    rm.load_state_dict(plain)


@pytest.mark.parametrize("name", list(KERNEL_CALL))
def test_remat_repeats_each_layers_kernel_call(name, arrays, backend,
                                               monkeypatch):
    """The layer kernel's wrapper is called once per layer in the forward
    and once more per layer in the recompute: GIN's K1 2 + 2 base and 2
    phi forwards a remat train step (the phi is not wrapped), GatedGCN's
    K4 and the Transformer's K2 2 + 2; an eval step as without remat."""
    backend(NETS[name][1])
    calls = []
    wrapped = getattr(tconv, KERNEL_CALL[name])

    def spy(*a, **kw):
        calls.append(1)
        return wrapped(*a, **kw)

    monkeypatch.setattr(tconv, KERNEL_CALL[name], spy)
    kw, _ = NETS[name]
    phi = 2 if name == "GIN" else 0   # the GIN phi's layers reach K1 too
    for remat_on in (False, True):
        model = TM.gnn_model(name, n_layers=2, remat=remat_on, **kw)
        train, evaluate = build_steps(
            model, make_zinc_predict(model, model.lap_method),
            adam(model.parameters()))
        gb = from_arrays(arrays)
        calls.clear()
        train(gb, 1e-3)
        assert len(calls) == 2 * (1 + remat_on) + phi, remat_on
        calls.clear()
        evaluate(gb)
        assert len(calls) == 2 + phi


def test_remat_gin_steps_match_jax():
    """GIN with remat and the GIN phi: the port's train and eval steps
    against JAX's `nn.remat` net."""
    gs = small_graphs(8, max_nodes=24, seed=5)
    add_lap_pe(gs, K)
    net = dict(hidden_dim=16, out_dim=16, n_layers=2, remat=True, **PE)
    step_parity("GIN", net, packed(gs, K), "sign_inv")


def test_recompute_scope_is_left_on_the_way_out(arrays, backend):
    """After a remat step no recompute is in progress, so a plain forward
    moves the BN running statistics again."""
    backend("xla")
    _step("GIN", arrays, True, 0.0)
    assert not remat.recomputing()


def test_capture_refuses_a_remat_model_with_dropout(arrays):
    model = TM.gnn_model("GIN", n_layers=2, dropout=0.1, remat=True,
                         **NETS["GIN"][0])
    with pytest.raises(NotImplementedError, match="remat"):
        capture_train_step(model, make_zinc_predict(model, "sign_inv"),
                           adam(model.parameters(), capturable=True),
                           from_arrays(arrays))


@pytest.mark.parametrize("config,extra", [
    ("gin_zinc_signinv_gin", ["model.dropout", "0.1"]),
    ("gatedgcn_zinc_signinv_gin", ["data.tile", "256"])])
def test_train_zinc_runs_with_remat_on_cpu(config, extra, tmp_path):
    """`model.remat true` through train_zinc.run, the tiled kernels'
    plain versions on the CPU: finite losses and MAE."""
    cfg = load_config(f"configs/{config}.json", extra + [
        "model.remat", "true", "data.agg_backend", "pallas_tile",
        "train.epochs", "2", "train.batch_size", "8", "data.synth_train",
        "24", "data.synth_eval", "8", "model.n_layers", "2",
        "model.hidden_dim", "8", "model.out_dim", "8",
        "model.sign_inv_layers", "2", "out_dir", str(tmp_path),
        "name", "smoke"])
    try:
        res = train_zinc.run(cfg, device="cpu", log=lambda m: None)
    finally:
        tseg.set_agg_backend("xla")
    assert res.epochs_run == 2 and res.train_steps >= 4
    assert all(np.isfinite(h["train_loss"]) for h in res.history)
    assert np.isfinite(res.val_mae) and np.isfinite(res.test_mae)
