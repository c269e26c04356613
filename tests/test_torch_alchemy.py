"""The Alchemy slice of the port against the JAX package: the Alchemy
loaders, the encoders and MLPs, the masked set transformer, the SignNet
encoder (GNN3d phi, set-transformer rho, eigenvalue encoder), Set2Set and
NetGINE, the metrics, the k-fold loop and `SignNetGNN`'s train and eval
steps in the Alchemy trainer's shape, under bridged parameters; then
`train_alchemy.run` on the CPU.  tests/test_torch_gine.py holds the GIN
convs, `GNN` and the GINE-ZINC trainer.

No kernel lies on this path in either package: the trainers pack untiled
batches, so the phi's aggregation is the flat gather + segment sum.

Exact eigenvectors put the phi's first layer on ReLU's kink, where each
package takes the side its summation order gives: the outputs agree, the
gradients part, in f64 too (a BN bias by up to 5x, the first `eps` by
0.5 %).  The sign-fused stack [v, -v] has mean 0, and its first conv's
input (1 + eps) v_i + sum_j v_j = (1 + eps + d_i - lambda) v_i is 0 up to
rounding wherever v_i is (168 of the 1514 real entries of one test batch:
symmetric atoms) and, at eps = 0, wherever lambda = d_i + 1 (integer
eigenvalues are common in these trees).  So the tests add N(0, 1e-2)
noise to every eigenvector entry (`off_the_kink`) before packing; the
nets are not changed.

The set transformer's attention dropout (0.1, hard-coded in JAX) draws
different bits in the two packages, so every comparison runs it off: on
the JAX side `flax.linen.Dropout` is patched to an identity for the test
(`no_jax_dropout`), in the port its rate is set to 0
(`models.set_attention_dropout`).  The port's dropout itself is tested
apart, in distribution.

Tolerances, float32: the loaders, `standardize_targets` and
`k_fold_split` bit for bit (the same numpy calls); the modules' outputs
and BN statistics 1e-5 (1e-4 relative plus 1e-5 for the SignNet
encoders, whose BatchNorms see many equal rows: the masked slots and the
padding).  Their gradients are held in f64, JAX under x64 against the
port, at 1e-7 relative plus 1e-9 of the largest; the port's f32 gradients
against its f64 ones at 1e-4 relative plus the larger of 1e-4 of the
largest gradient and twice JAX's largest f32 error on that tensor.  Both
packages' f32 gradients stray alike from the exact ones where a BatchNorm
makes the loss blind to a weight's scale (the eigenvalue encoder's 1x1
`lin_0`: its exact gradient is 0) or where a sum cancels (the phi's first
`eps`, 22.12 in f32 in both packages against 23.20 in f64).  Metrics 1e-6;
the k-fold aggregation 1e-6 relative (the port's `evaluate` sums in f32).
The train step as in tests/test_torch_pe.py's `step_parity`, one Adam step
with `exact_grads` (losses 1e-5 relative; gradients 1e-4 relative plus the
larger of 1e-6 of the largest and twice JAX's own distance from the
port's f64 gradient, element by element: the biases straight before a
BatchNorm have an exact gradient of 0 and f32 noise of up to 2e-6; BN
statistics 1e-5, parameters 2e-5 but the elements with a gradient below
1e-6, 2 * lr; eval sums 1e-5 relative): after more steps the scale-blind weight above
moves by +-lr a step on its f32 noise in each package, and the BN
statistics below it part.  A resumed run equals an uninterrupted one
within 1e-6.
"""
import copy
import json
import os
from typing import Optional

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signnet_basisnet_tpu import models as JM
from signnet_basisnet_tpu.data import alchemy as jalchemy
from signnet_basisnet_tpu.graph import from_arrays as jfrom_arrays
from signnet_basisnet_tpu.nn import encoders as jenc
from signnet_basisnet_tpu.nn import mlp as jmlp
from signnet_basisnet_tpu.nn import set2set as jset2set
from signnet_basisnet_tpu.nn import set_transformer as jst
from signnet_basisnet_tpu.training import metrics as JMET
from signnet_basisnet_tpu.training import train as jtrain

from signnet_basisnet_tpu_torch import models as TM
from signnet_basisnet_tpu_torch import train_alchemy
from signnet_basisnet_tpu_torch.bridge import load_flax_variables, torch_name
from signnet_basisnet_tpu_torch.data import (add_full_evd, choose_budgets,
                                             load_alchemy, load_tudataset,
                                             pack_batches,
                                             standardize_targets,
                                             synthetic_alchemy)
from signnet_basisnet_tpu_torch.graph import from_arrays
from signnet_basisnet_tpu_torch.nn import encoders as tenc
from signnet_basisnet_tpu_torch.nn import mlp as tmlp
from signnet_basisnet_tpu_torch.nn import set2set as tset2set
from signnet_basisnet_tpu_torch.nn import set_transformer as tst
from signnet_basisnet_tpu_torch.nn.dropout import DropoutRNG
from signnet_basisnet_tpu_torch.nn.init import init_parameters
from signnet_basisnet_tpu_torch.training import metrics as TMET
from signnet_basisnet_tpu_torch.training import train as ttrain
from signnet_basisnet_tpu_torch.training import (adam, build_steps,
                                                 make_module_predict)

from test_torch_pe import _flat, _port_view, step_parity

TOL = dict(rtol=1e-5, atol=1e-5)
SIGNNET_TOL = dict(rtol=1e-4, atol=1e-5)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
ALCHEMY = os.path.join(FIXTURES, "alchemy_tu")


class _NoDropout(flax.linen.Module):
    """flax's Dropout with every draw off (the input passes unchanged)."""
    rate: float
    broadcast_dims: tuple = ()
    deterministic: Optional[bool] = None
    rng_collection: str = "dropout"

    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)


def off_the_kink(graphs, seed=0):
    """Add N(0, 1e-2) noise to every eigenvector entry, in place (see the
    module docstring: exact eigenvectors put the phi's first layer on the
    ReLU's kink)."""
    r = np.random.default_rng(seed)
    for g in graphs:
        v = g["eigvecs"]
        v += r.normal(scale=1e-2, size=v.shape).astype(v.dtype)
    return graphs


def alchemy_graphs(n, seed=0):
    gs = synthetic_alchemy(n, 0, 0, seed=seed)["train"]
    add_full_evd(gs, normalization=None)
    return off_the_kink(gs, seed)


def one_batch(gs, extra_nodes=0, extra_graphs=0):
    """`gs` in one untiled batch (k = the largest graph), with room for
    `extra_nodes` more padding nodes and `extra_graphs` more padding
    graph slots."""
    nb, eb, gc = choose_budgets(gs, len(gs))
    out = pack_batches(gs, nb + extra_nodes, eb, gc + extra_graphs)
    assert len(out) == 1
    return out[0]


def jx(a, dt=np.float32):
    """A JAX array of numpy `a`, its floats in `dt`."""
    a = np.asarray(a)
    return jnp.asarray(a.astype(dt) if a.dtype.kind == "f" else a)


def jbatch(arrays, dt=np.float32):
    """The JAX GraphBatch of `arrays`, its floats in `dt`."""
    return jfrom_arrays({k: v.astype(dt) if v.dtype.kind == "f" else v
                         for k, v in arrays.items()})


def module_parity(jm, jargs, tm, targs, *, jkw=None, tkw=None, out_tol=TOL,
                  seed=9, check_eval=True):
    """jm(*jargs(dt)) against tm(*targs(dt)) under the flax init's bridged
    parameters, in training mode, for the loss sum(out * c): in f32 the
    output and the BN statistics (and with `check_eval` the eval-mode
    output from the updated statistics) within `out_tol`; in f64 (JAX under
    x64) the gradients of every parameter, within 1e-7 relative plus 1e-9
    of the largest; the port's f32 gradients against its f64 ones within
    1e-4 relative plus the larger of 1e-4 of the largest gradient and twice
    JAX's largest f32 error on the tensor.  `jkw` and `tkw` map a dtype to
    keyword arguments.  Returns the port's f32 output."""
    jkw = jkw or (lambda dt: {})
    tkw = tkw or (lambda dt: {})
    var = jax.tree.map(np.asarray, jax.jit(
        lambda key: jm.init({"params": key}, *jargs(np.float32),
                            training=False, **jkw(np.float32)))(
        jax.random.PRNGKey(2)))
    load_flax_variables(tm, var)
    t64 = copy.deepcopy(tm).double()

    def fwd(params, stats, args, kw, training=True):
        return jm.apply({"params": params, **stats}, *args,
                        training=training, mutable=["batch_stats"], **kw)

    stats = {k: v for k, v in var.items() if k == "batch_stats"}
    c = np.random.default_rng(seed).normal(size=jax.eval_shape(
        lambda p: fwd(p, stats, jargs(np.float32), jkw(np.float32))[0],
        var["params"]).shape)

    def grad(dt):
        args, kw = jargs(dt), jkw(dt)
        cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dt), t)

        def loss(params):
            out, upd = fwd(params, cast(stats), args, kw)
            return (out * c.astype(dt)).sum(), (out, upd)
        return jax.jit(jax.value_and_grad(loss, has_aux=True))(
            cast(var["params"]))

    (_, (jout, upd)), jg32 = grad(np.float32)
    with jax.enable_x64(True):
        _, jg64 = grad(np.float64)
        jg64 = jax.tree.map(np.asarray, jg64)
    for model, dt in ((tm, torch.float32), (t64, torch.float64)):
        model.train()
        out = model(*targs(dt), **tkw(dt))
        (out * torch.from_numpy(c).to(dt)).sum().backward()
        if dt == torch.float32:
            tout = out
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **out_tol)
    buffers = dict(tm.named_buffers())
    jstats = _flat(upd.get("batch_stats", {}))
    assert len(buffers) == len(jstats)
    for path, s in jstats.items():
        np.testing.assert_allclose(buffers[torch_name(path)].numpy(), s,
                                   err_msg=torch_name(path), **out_tol)
    g32, g64 = _flat(jg32), _flat(jg64)
    top = max([np.abs(g).max() for g in g64.values()] + [0.0])
    params, exact = dict(tm.named_parameters()), dict(t64.named_parameters())
    assert len(params) == len(g32)
    for path in g32:
        name = torch_name(path)
        want32, want64 = _port_view(path, g32[path]), _port_view(path,
                                                                 g64[path])
        grads = [t.grad for t in (params[name], exact[name])]
        got, ref = (np.zeros_like(want64) if g is None else g.numpy()
                    for g in grads)
        np.testing.assert_allclose(ref, want64, rtol=1e-7, atol=1e-9 * top,
                                   err_msg=name)
        bar = 1e-4 * np.abs(ref) + max(1e-4 * top,
                                       2 * np.abs(want32 - ref).max())
        err = np.abs(got - ref)
        assert (err <= bar).all(), (name, float((err - bar).max()))
    if check_eval:
        jev, _ = jax.jit(lambda p, st: fwd(
            p, st, jargs(np.float32), jkw(np.float32), training=False))(
            var["params"], upd if stats else {})
        tm.eval()
        with torch.no_grad():
            tev = tm(*targs(torch.float32), **tkw(torch.float32))
        np.testing.assert_allclose(tev.numpy(), np.asarray(jev), **out_tol)
    return tout


# ---------------------------------------------------------------- loaders

def _same_graphs(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        assert ga.keys() == gb.keys()
        for k in ga:
            np.testing.assert_array_equal(ga[k], gb[k], err_msg=k)
            assert np.asarray(ga[k]).dtype == np.asarray(gb[k]).dtype, k


def test_alchemy_loaders_match_jax_bit_for_bit():
    """The TUDataset fixture (8 molecules), the `*_al_10.index` splits, the
    synthetic stand-in and the standardisation, array by array."""
    _same_graphs(load_tudataset(ALCHEMY), jalchemy.load_tudataset(ALCHEMY))
    (ts, treal), (js, jreal) = (load_alchemy(ALCHEMY),
                                jalchemy.load_alchemy(ALCHEMY))
    assert treal and jreal and ts.keys() == js.keys() == {"train", "val",
                                                          "test"}
    for split in ts:
        _same_graphs(ts[split], js[split])
    tstat, jstat = standardize_targets(ts), jalchemy.standardize_targets(js)
    for k in ("mean", "std"):
        np.testing.assert_array_equal(tstat[k], jstat[k])
    for split in ts:
        _same_graphs(ts[split], js[split])
    t, j = synthetic_alchemy(7, 3, 2, seed=5), jalchemy.synthetic_alchemy(
        7, 3, 2, seed=5)
    for split in ("train", "val", "test"):
        _same_graphs(t[split], j[split])
    assert t["train"][0]["node_feat"].shape[1] == 6
    fell_back, real = load_alchemy(os.path.join(FIXTURES, "missing"),
                                   synth_sizes=(3, 1, 1))
    assert not real and len(fell_back["train"]) == 3
    with pytest.raises(FileNotFoundError):
        load_alchemy(os.path.join(FIXTURES, "missing"),
                     synthetic_fallback=False)


# --------------------------------------------------------------- encoders

@pytest.mark.parametrize("codes", ["1d", "2d"])
def test_discrete_encoder_matches_jax(codes):
    """1-D codes take emb_0; a [N, 12] code matrix sums emb_0..emb_9 (the
    first max_num_features columns)."""
    r = np.random.default_rng(0)
    x = (r.integers(0, 6, size=(40,)) if codes == "1d"
         else r.integers(0, 6, size=(40, 12))).astype(np.int32)
    tm = tenc.DiscreteEncoder(16, num_features=1 if codes == "1d" else 12)
    assert tm.n_emb == (1 if codes == "1d" else 10)
    module_parity(jenc.DiscreteEncoder(16), lambda dt: (jx(x),), tm,
                  lambda dt: (torch.from_numpy(x),))


@pytest.mark.parametrize("kind", ["elements", "elements_no_norm",
                                  "elements_final", "masked", "masked_3d"])
def test_elements_and_masked_mlp_match_jax(kind):
    """ElementsMLP with and without norm and final activation (its bias
    rule), and MaskedMLP on [N, D] and [N, K, D] with a mask: padded slots
    zero after every Linear, BN statistics over the real ones."""
    r = np.random.default_rng(1)
    shape = (30, 5, 7) if kind == "masked_3d" else (30, 7)
    x = r.normal(size=shape).astype(np.float32)
    mask = (r.random(shape[:-1]) > 0.3).astype(np.float32)
    x = x * mask[..., None]
    kw = dict(num_layers=3, hidden=9)
    if kind == "elements":
        jm, tm = jmlp.ElementsMLP(6, **kw), tmlp.ElementsMLP(7, 6, **kw)
    elif kind == "elements_no_norm":
        jm = jmlp.ElementsMLP(6, with_norm=False, **kw)
        tm = tmlp.ElementsMLP(7, 6, with_norm=False, **kw)
    elif kind == "elements_final":
        jm = jmlp.ElementsMLP(6, with_final_activation=False, **kw)
        tm = tmlp.ElementsMLP(7, 6, with_final_activation=False, **kw)
    else:
        jm = jmlp.MaskedMLP(6, with_final_activation=False, **kw)
        tm = tmlp.MaskedMLP(7, 6, with_final_activation=False, **kw)
    biases = {n for n, _ in tm.named_parameters() if n.startswith("lin_")
              and n.endswith("bias")}
    assert biases == {"elements": set(), "elements_no_norm": {
        "lin_0.bias", "lin_1.bias", "lin_2.bias"}}.get(kind, {"lin_2.bias"})
    out = module_parity(
        jm, lambda dt: (jx(x, dt),), tm,
        lambda dt: (torch.from_numpy(x).to(dt),),
        jkw=lambda dt: {"mask": jx(mask, dt)},
        tkw=lambda dt: {"mask": torch.from_numpy(mask)})
    if kind.startswith("masked"):
        assert (out[mask == 0] == 0).all()


# ------------------------------------------------------- set transformer

def _set_inputs(n=12, k=6, d=16, seed=3):
    """x [n, k, d] with a mask that pads each row's tail, one row all
    masked (a padding node) and one full; x is zero at masked slots."""
    r = np.random.default_rng(seed)
    lens = r.integers(1, k + 1, size=n)
    lens[0], lens[1] = 0, k
    mask = (np.arange(k)[None] < lens[:, None]).astype(np.float32)
    x = r.normal(size=(n, k, d)).astype(np.float32) * mask[..., None]
    return x, mask


def test_multi_head_attention_matches_jax_with_masked_rows():
    """Padded slots and an all-masked row (uniform softmax, then zeroed
    by the pair mask, as in JAX; an -inf fill would give NaN)."""
    x, mask = _set_inputs()
    out = module_parity(
        jst.MultiHeadAttention(4, 16, attn_dropout=0.0),
        lambda dt: (jx(x, dt),) * 3,
        tst.MultiHeadAttention(4, 16, attn_dropout=0.0),
        lambda dt: (torch.from_numpy(x).to(dt),) * 3,
        jkw=lambda dt: {"mask": jx(mask, dt)},
        tkw=lambda dt: {"mask": torch.from_numpy(mask)})
    assert torch.isfinite(out).all()
    assert (out[mask == 0] == 0).all() and (out[0] == 0).all()


@pytest.mark.parametrize("width", [16, 18])
def test_set_transformer_matches_jax(width, no_jax_dropout):
    """Two encoder layers of 4 heads (width 18: heads of 4, projections of
    16 features), positions added, the sum over k, out_lin and out_bn,
    whose statistics run over every row, the all-masked one included."""
    x, mask = _set_inputs(d=width)
    pos = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    tm = tst.SetTransformer(width, 2, rng=DropoutRNG(0))
    TM.set_attention_dropout(tm, 0.0)
    assert tm.layer_0.slf_attn.w_qs.weight.shape == (4 * (width // 4), width)
    module_parity(jst.SetTransformer(width, 2),
                  lambda dt: (jx(x, dt), jx(pos, dt)), tm,
                  lambda dt: (torch.from_numpy(x).to(dt),
                              torch.from_numpy(pos).to(dt)),
                  jkw=lambda dt: {"mask": jx(mask, dt)},
                  tkw=lambda dt: {"mask": torch.from_numpy(mask)})


def test_positional_encoding_matches_jax():
    pos = np.random.default_rng(5).random((7, 5)).astype(np.float32) * 2
    mask = (np.random.default_rng(6).random((7, 5)) > 0.4).astype(np.float32)
    want = jst.PositionalEncoding(8)(jnp.asarray(pos), jnp.asarray(mask))
    got = tst.PositionalEncoding(8)(torch.from_numpy(pos),
                                    torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_dropout_draws_from_the_models_generator():
    """Rate 0.1 in training: about a tenth of the softmax dropped (within
    six standard deviations), the rest scaled by 1/0.9, a fresh mask each
    call; nothing drawn at eval or at rate 0; a SignNetGNN's attention
    dropouts share its `dropout_rng`, which a captured step registers."""
    x, mask = _set_inputs(n=64, k=8, d=16)
    rng = DropoutRNG(3)
    m = tst.MultiHeadAttention(4, 16, rng=rng)
    init_parameters(m, torch.Generator().manual_seed(0))
    keep = []
    m.attn_drop.register_forward_hook(
        lambda mod, i, o: keep.append((o, i[0])))
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    a, b = m(xt, xt, xt, mask=mt), m(xt, xt, xt, mask=mt)
    assert not torch.equal(a, b)
    out, inp = keep[0]
    dropped = (out == 0) & (inp != 0)
    share = dropped.sum().item() / (inp != 0).sum().item()
    n = (inp != 0).sum().item()
    assert abs(share - 0.1) < 6 * np.sqrt(0.09 / n), share
    kept = ~dropped & (inp != 0)
    torch.testing.assert_close(out[kept], inp[kept] / 0.9)
    m.eval()
    keep.clear()
    e1 = m(xt, xt, xt, mask=mt)
    assert torch.equal(keep[0][0], keep[0][1])
    m0 = copy.deepcopy(m)
    m0.attn_drop.rate = 0.0
    assert torch.isfinite(e1).all()
    assert torch.equal(e1, m0(xt, xt, xt, mask=mt))
    net = TM.SignNetGNN(8, 12, 1, 1, nl_rho=2, seed=4)
    drops = [mm for mm in net.modules()
             if isinstance(mm, tst.MultiHeadAttention)]
    assert len(drops) == 2 and all(d.attn_drop.rng is net.dropout_rng
                                   and d.attn_drop.rate == 0.1
                                   for d in drops)
    assert ttrain._step_rngs(net) == [net.dropout_rng]
    TM.set_attention_dropout(net, 0.0)
    assert ttrain._step_rngs(net) == []


# ---------------------------------------------------------------- SignNet

@pytest.mark.parametrize("phi,ignore_eigval", [("MaskedGINConv", False),
                                               ("MaskedGINEConv", True)])
def test_signnet_matches_jax(phi, ignore_eigval, no_jax_dropout):
    """SignNet (2-layer GNN3d phi, 2-layer rho) on an Alchemy batch with 6
    padding nodes and all-n eigenvectors: output, BN statistics, gradients
    and the eval output.  The phi's output is zero at the masked slots and
    the rho's pre-BN sum at the padding nodes; the output is invariant
    under random sign flips of each graph's eigenvectors."""
    arrays = one_batch(alchemy_graphs(6, seed=1), extra_nodes=6)
    tgb = from_arrays(arrays)
    kw = dict(nl_rho=2, ignore_eigval=ignore_eigval, phi_gnn_type=phi,
              edge_vocab=10)
    tm = TM.SignNet(16, 2, rng=DropoutRNG(0), **kw)
    TM.set_attention_dropout(tm, 0.0)
    seen = {}
    tm.phi.register_forward_hook(lambda m, i, o: seen.__setitem__("phi", o))
    tm.rho.out_lin.register_forward_hook(
        lambda m, i, o: seen.__setitem__("sum", o))
    out = module_parity(JM.SignNet(16, 2, **kw),
                        lambda dt: (jbatch(arrays, dt),), tm,
                        lambda dt: (tgb.cast_floats(dt),),
                        out_tol=SIGNNET_TOL)
    assert ("eigen_encoder.lin_0.weight" in dict(tm.named_parameters())) \
        == (not ignore_eigval)
    m2 = torch.cat([tgb.eig_mask] * 2, dim=-1)
    assert (seen["phi"][m2 == 0] == 0).all()
    assert (seen["sum"][tgb.node_mask == 0] == 0).all()
    assert int((tgb.node_mask == 0).sum()) >= 6
    # sign invariance: flip each graph's eigenvector columns at random
    r = np.random.default_rng(8)
    flips = r.choice([-1.0, 1.0], size=arrays["eigvals"].shape)
    flipped = dict(arrays, eigvecs=(arrays["eigvecs"] * flips[
        arrays["graph_id"]]).astype(np.float32))
    tm.eval()
    with torch.no_grad():
        a = tm(tgb)
        b = tm(from_arrays(flipped))
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert out.shape == (tgb.num_nodes, 16)


def test_gnn3d_refuses_an_unknown_conv():
    with pytest.raises(ValueError, match="gnn_type"):
        TM.GNN3d(1, 8, 2, gnn_type="GINConv")


def test_signplus_sums_both_signs():
    inner = torch.nn.Linear(5, 3)
    sp = TM.SignPlus(inner)
    v, x = torch.randn(4, 3), torch.randn(4, 2)
    torch.testing.assert_close(sp(v, x), inner(torch.cat([v, x], -1))
                               + inner(torch.cat([-v, x], -1)))
    sp2 = TM.SignPlus(torch.nn.Linear(3, 3))
    torch.testing.assert_close(sp2(v), sp2(-v))


# ------------------------------------------------------ Set2Set, NetGINE

def test_set2set_matches_jax():
    """Three processing steps of one LSTM cell over a batch with padding
    nodes and a padding graph slot (masked softmax per graph); NetGINE's
    test runs six."""
    arrays = one_batch(alchemy_graphs(5, seed=2), extra_nodes=5)
    x = np.random.default_rng(7).normal(
        size=(len(arrays["node_mask"]), 8)).astype(np.float32)
    gid, G = arrays["graph_id"], len(arrays["graph_mask"])
    tm = tset2set.Set2Set(8, processing_steps=3)
    assert {n.split(".")[1] for n, _ in tm.named_parameters()} == {
        "ii", "if", "ig", "io", "hi", "hf", "hg", "ho"}
    module_parity(
        jset2set.Set2Set(8, processing_steps=3), lambda dt: (
            jx(x, dt), jx(gid), G, jx(arrays["node_mask"], dt)), tm,
        lambda dt: (torch.from_numpy(x).to(dt), torch.from_numpy(gid), G,
                    torch.from_numpy(arrays["node_mask"])))


def test_s2s_readout_matches_jax():
    arrays = one_batch(alchemy_graphs(4, seed=3))
    x = np.random.default_rng(8).normal(
        size=(len(arrays["node_mask"]), 6)).astype(np.float32)
    gid, G = arrays["graph_id"], len(arrays["graph_mask"])
    module_parity(
        jset2set.S2SReadout(6, 3, processing_steps=3),
        lambda dt: (jx(x, dt), jx(gid), G, jx(arrays["node_mask"], dt)),
        tset2set.S2SReadout(6, 3, processing_steps=3),
        lambda dt: (torch.from_numpy(x).to(dt), torch.from_numpy(gid), G,
                    torch.from_numpy(arrays["node_mask"])))


def test_netgine_matches_jax():
    """NetGINE at hidden 16 and 2 layers on an Alchemy batch: [N, 6] node
    codes as floats, 1-D bond codes one-hot over 4 types."""
    arrays = one_batch(alchemy_graphs(6, seed=4), extra_nodes=3)
    tgb = from_arrays(arrays)
    out = module_parity(JM.NetGINE(hidden=16, num_layers=2),
                        lambda dt: (jbatch(arrays, dt),),
                        TM.NetGINE(hidden=16, num_layers=2), lambda dt: (
                            tgb.cast_floats(dt),))
    assert out.shape == (len(arrays["graph_mask"]), 12)


# ---------------------------------------------------------------- metrics

def test_metrics_match_jax():
    r = np.random.default_rng(9)
    G, T, C = 11, 12, 4
    pred, target = (r.normal(size=(G, T)).astype(np.float32)
                    for _ in range(2))
    mask = (r.random(G) > 0.3).astype(np.float32)
    logits = r.normal(size=(G, C)).astype(np.float32)
    labels = r.integers(0, C, size=G).astype(np.int32)
    p1, t1 = r.random(G).astype(np.float32), r.random(G).astype(np.float32)
    J = lambda *a: [jnp.asarray(v) for v in a]
    T_ = lambda *a: [torch.from_numpy(v) for v in a]
    cases = [
        ("masked_l1", (pred, target, mask), ()),
        ("masked_mae", (pred, target, mask), ()),
        ("masked_mse_sum", (pred, target, mask), ()),
        ("masked_r2", (pred, target, mask), ()),
        ("masked_l1_per_target", (pred, target, mask), ()),
        ("accuracy", (logits, labels, mask), ()),
        ("binary_f1", (p1, t1, mask), ()),
        ("accuracy_sbm", (logits, labels, mask), (C,)),
        ("weighted_f1", (logits, labels, mask), (C,)),
    ]
    for name, args, extra in cases:
        want = np.asarray(getattr(JMET, name)(*J(*args), *extra))
        got = getattr(TMET, name)(*T_(*args), *extra).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


# ----------------------------------------------------------------- k-fold

@pytest.mark.parametrize("n,k,seed", [(10, 3, 0), (37, 10, 4), (5, 5, 1)])
def test_k_fold_split_matches_jax(n, k, seed):
    for (a, b), (c, d) in zip(ttrain.k_fold_split(n, k, seed),
                              jtrain.k_fold_split(n, k, seed)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_run_k_fold_aggregates_as_jax():
    """Both loops over the same stand-in steps, whose test MAE is a
    function of the fold, the LRs of the steps so far and the graphs seen:
    the same fold bests, curve statistics and best epoch, so the same
    StepLR, epoch loop and aggregation."""
    graphs = [{"w": float(i)} for i in range(13)]

    def fold_state(fold):
        return {"fold": fold, "lrs": 0.0, "seen": 0.0}

    def mae(st):
        return (0.3 * st["fold"] + 1.0 / (1.0 + 1e3 * st["lrs"])
                + 0.01 * np.sin(st["seen"]))

    def jmake(fold):
        st = fold_state(fold)

        def train_step(state, gb, lr, rng):
            st["lrs"] += lr
            st["seen"] += sum(g["w"] for g in gb)
            return state, {}

        def eval_step(state, gb):
            return {"loss_sum": 0.0, "mae_sum": mae(st) * len(gb),
                    "n": float(len(gb))}
        return None, train_step, eval_step

    def tmake(fold):
        st = fold_state(fold)

        def train_step(gb, lr):
            st["lrs"] += lr
            st["seen"] += sum(g["w"] for g in gb)

        def eval_step(gb, flip_rng=None):
            n = float(len(gb))
            return {k: torch.tensor(v, dtype=torch.float64) for k, v in
                    (("loss_sum", 0.0), ("mae_sum", mae(st) * n), ("n", n))}
        return train_step, eval_step

    def batches(gs, shuffle_seed):
        return [gs[i:i + 2] for i in range(0, len(gs), 2)]

    kw = dict(k=3, epochs=5, init_lr=1e-3, lr_decay=0.5, lr_patience=2,
              seed=3, logger=lambda m: None)
    want = jtrain.run_k_fold(graphs, jmake, batches, **kw)
    got = ttrain.run_k_fold(graphs, tmake, batches, **kw)
    # the port's evaluate sums in float32
    np.testing.assert_allclose(got.fold_best, want.fold_best, rtol=1e-6)
    for f in ("mean", "std", "curve_mean", "curve_std"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-6, err_msg=f)
    assert got.best_epoch == want.best_epoch


def test_run_k_fold_trains_signnetgnn():
    """k = 3, 1 epoch of the Alchemy net at width 8 on 24 graphs: a fresh
    model per fold, a finite best per fold, the aggregations consistent."""
    gs = alchemy_graphs(24, seed=6)
    standardize_targets({"train": gs})
    nb, eb, gc = choose_budgets(gs, 8)
    made = []

    def make_steps(fold):
        m = TM.SignNetGNN(8, 12, 1, 1, nl_rho=1, node_vocab=10,
                          edge_vocab=10, node_code_dims=6, seed=fold)
        made.append(m)
        return build_steps(m, make_module_predict(m), adam(m.parameters()))

    def batches(graphs, seed):
        return [from_arrays(a) for a in pack_batches(
            graphs, nb, eb, gc, shuffle=seed is not None, seed=seed or 0)]

    res = ttrain.run_k_fold(gs, make_steps, batches, k=3, epochs=1,
                            logger=lambda m: None)
    assert len(made) == 3 and len(res.fold_best) == 3
    assert np.isfinite(res.fold_best).all() and res.best_epoch == 0
    np.testing.assert_allclose(res.mean, np.mean(res.fold_best))
    np.testing.assert_allclose(res.curve_mean, res.mean)


# --------------------------------------------------------------- the step

ALCHEMY_NET = dict(n_hid=16, n_out=12, nl_signnet=2, nl_gnn=2, nl_rho=2,
                   gnn_type="GINEConv", node_vocab=10, edge_vocab=10)


@pytest.mark.parametrize("phi", ["MaskedGINConv", "MaskedGINEConv"])
def test_alchemy_signnetgnn_steps_match_jax(phi, no_jax_dropout):
    """train_alchemy's net (GINE base, 12 targets, eigenvalue encoder) at
    width 16 and 2 layers, on a standardised synthetic batch with padding
    nodes: three Adam steps and an eval step, the attention dropout off
    on both sides."""
    gs = alchemy_graphs(7, seed=5)
    standardize_targets({"train": gs})
    arrays = one_batch(gs, extra_nodes=4)
    net = dict(ALCHEMY_NET, phi_gnn_type=phi)

    def port():
        m = TM.SignNetGNN(node_code_dims=6, **net)
        TM.set_attention_dropout(m, 0.0)
        return m

    jres, tres = step_parity(None, None, arrays, "none", steps=1,
                             modules=(JM.SignNetGNN(**net), port),
                             exact_grads=True)
    assert jres["loss_sum"] == pytest.approx(jres["mae_sum"])


def test_bridge_sets_every_signnetgnn_and_netgine_tensor():
    """A real flax init of SignNetGNN and of NetGINE lands on every port
    tensor (load_flax_variables raises otherwise): the GINE layers' update
    nets `conv_i_nn` as `conv_i.mlp`, the LSTM cell's eight Linears, eps.
    The step tests bridge the other SignNetGNN forms: both phi types with
    the eigenvalue encoder here, both without it in
    tests/test_torch_gine.py."""
    arrays = one_batch(alchemy_graphs(4, seed=7))
    jgb = jfrom_arrays(arrays)
    net = dict(ALCHEMY_NET, phi_gnn_type="MaskedGINEConv",
               ignore_eigval=True)
    v = jax.jit(lambda key: JM.SignNetGNN(**net).init(
        {"params": key}, jgb, training=False))(jax.random.PRNGKey(0))
    tm = TM.SignNetGNN(node_code_dims=6, **net)
    load_flax_variables(tm, jax.tree.map(np.asarray, v))
    names = set(dict(tm.named_parameters()))
    assert {"gnn.conv_0.mlp.lin_0.weight", "gnn.conv_0.eps",
            "sign_net.phi.conv_1.nn.lin_1.bias",
            "sign_net.phi.edge_enc_0.emb_0.weight",
            "gnn.input_encoder.emb_5.weight"} <= names
    assert not any(n.startswith("sign_net.eigen_encoder") for n in names)
    v = jax.jit(lambda key: JM.NetGINE(hidden=8, num_layers=2).init(
        {"params": key}, jgb, training=False))(jax.random.PRNGKey(1))
    tm = TM.NetGINE(hidden=8, num_layers=2)
    load_flax_variables(tm, jax.tree.map(np.asarray, v))
    assert "conv_1.mlp_2.weight" in dict(tm.named_parameters())


# ------------------------------------------------------------ the trainer

def _alchemy_args(tmp_path, epochs, name, *extra):
    return train_alchemy.build_parser().parse_args([
        "--device", "cpu", "--seeds", "1", "--epochs", str(epochs),
        "--batch_size", "8", "--synth_train", "24", "--synth_eval", "8",
        "--hidden", "8", "--nl_signnet", "2", "--nl_gnn", "2", "--nl_rho",
        "1", "--data_dir", str(tmp_path / "none"), "--log_every", "1",
        "--out_dir", str(tmp_path / name), *extra])


def test_train_alchemy_resumes_as_an_uninterrupted_run(tmp_path):
    """train_alchemy.run at width 8 on the CPU: 1 epoch, then resumed from
    its checkpoint to 2, against 2 epochs in one run, within 1e-6 (the
    checkpoint carries the attention dropout's generator); per-target
    test MAE and logMAE of the final state; a finished seed is skipped."""
    quiet = lambda m: None
    ck = str(tmp_path / "ck")
    whole = train_alchemy.run(_alchemy_args(tmp_path, 2, "a"), log=quiet)
    train_alchemy.run(_alchemy_args(tmp_path, 1, "b", "--ckpt_dir", ck),
                      log=quiet)
    resumed = train_alchemy.run(_alchemy_args(
        tmp_path, 2, "c", "--ckpt_dir", ck, "--resume"), log=quiet)
    read = lambda n: json.load(open(tmp_path / n / "alchemy_s0.json"))
    a, b, c = read("a"), read("b"), read("c")
    assert [h["epoch"] for h in c["history"]] == [1]
    for got, want in zip(b["history"] + c["history"], a["history"]):
        for k in ("lr", "train_loss", "train_mae", "val_loss", "val_mae"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    np.testing.assert_allclose(resumed, whole, rtol=1e-6, atol=1e-6)
    assert len(a["per_target_mae"]) == 12
    np.testing.assert_allclose(a["logmae"],
                               np.log(a["per_target_mae"]).mean(), rtol=1e-6)
    assert a["test_mae"] == whole[0, 0]
    again = train_alchemy.run(_alchemy_args(tmp_path, 2, "a"), log=quiet)
    np.testing.assert_array_equal(again, whole)


def test_train_alchemy_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = train_alchemy.build_parser().parse_args(["--seeds", "1"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_alchemy.run(args, log=lambda m: None)
