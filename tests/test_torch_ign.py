"""BasisNet's building blocks in the port against the JAX package: the four
IGN contraction bases, `EquivariantLayer` at each rank pair,
`BasicEquivariantLayer`, `IGN2to1`, the eigenspace layout and projectors,
`IGNBasisInv`, `IGNShared` and `basis_features` in both layouts, the
equivariant DeepSets encoder and `MaskedBatchNorm(track_running_stats=
False)`, under bridged parameters.  No Pallas kernel is on this path in
either package (plain reductions and einsums).

Projector inputs are the eigenspace projectors of a 6x6 grid with N(0,
1e-2) noise (`off_the_kink`): exact projectors give contractions that are
0 up to rounding by the grid's symmetry (row sums of antisymmetric
eigenvectors), where the first ReLU sits on its kink and each package
takes the side its summation order gives.

Tolerances: the contraction bases 1e-6 in f32 and 1e-12 in f64; the
layout and projector stacks bit for bit (the same numpy calls); the
modules' outputs and BN statistics 1e-5 in f32; their gradients in f64,
JAX under x64 against the port, 1e-7 relative plus 1e-9 of the largest;
the port's f32 gradients against its f64 ones 1e-4 relative plus the
larger of 1e-4 of the largest gradient and twice JAX's largest f32 error
on the tensor (`module_parity`).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signnet_basisnet_tpu import models as JM
from signnet_basisnet_tpu import spectral as jspec
from signnet_basisnet_tpu.nn import deepsets as jds
from signnet_basisnet_tpu.nn import ign as jign
from signnet_basisnet_tpu.nn import norm as jnorm

from signnet_basisnet_tpu_torch import models as TM
from signnet_basisnet_tpu_torch import spectral as tspec
from signnet_basisnet_tpu_torch.bridge import (load_flax_variables,
                                               port_value, torch_name)
from signnet_basisnet_tpu_torch.nn import deepsets as tds
from signnet_basisnet_tpu_torch.nn import ign as tign
from signnet_basisnet_tpu_torch.nn import norm as tnorm
from signnet_basisnet_tpu_torch.nn.init import init_parameters

from test_torch_pe import _flat

TOL = dict(rtol=1e-5, atol=1e-5)


def module_parity(jm, jargs, tm, targs, *, jkw=None, tkw=None, out_tol=TOL,
                  seed=9, check_eval=True):
    """jm(*jargs(dt)) against tm(*targs(dt)) under the flax init's bridged
    parameters, in training mode, for the loss sum(out * c): in f32 the
    output and the BN statistics (and with `check_eval` the eval-mode
    output from the updated statistics) within `out_tol`; in f64 (JAX under
    x64) the gradients of every parameter within 1e-7 relative plus 1e-9 of
    the largest; the port's f32 gradients against its f64 ones within 1e-4
    relative plus the larger of 1e-4 of the largest gradient and twice
    JAX's largest f32 error on the tensor.  `jkw` and `tkw` map a dtype to
    keyword arguments.  Returns the port's f32 output and the flax
    variables."""
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
        want32, want64 = port_value(path, g32[path]), port_value(path,
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
    return tout, var


def grid_spectrum(side=6):
    """Eigenvalues and eigenvectors of a side x side grid's sym-normalised
    Laplacian (float32, as the 2D-grid loader keeps them)."""
    n = side * side
    A = np.zeros((n, n))
    for i in range(side):
        for j in range(side):
            u = i * side + j
            if j + 1 < side:
                A[u, u + 1] = A[u + 1, u] = 1
            if i + 1 < side:
                A[u, u + side] = A[u + side, u] = 1
    return tspec.eigh_np(tspec.sym_laplacian_np(A), fix_sign=False)


def off_the_kink(projs, seed=0):
    """The projector stacks with N(0, 1e-2) noise on every entry (see the
    module docstring)."""
    r = np.random.default_rng(seed)
    return {m: (P + r.normal(scale=1e-2, size=P.shape)).astype(np.float32)
            for m, P in projs.items()}


def grid_projs(side=6):
    vals, vecs = grid_spectrum(side)
    layout = tspec.eigenspace_layout(vals)
    projs = off_the_kink(tspec.projectors_by_multiplicity(vecs, layout))
    return vals, layout, {m: P[:, None] for m, P in projs.items()}


def jdict(projs, dt):
    return {m: jnp.asarray(P.astype(dt)) for m, P in projs.items()}


def tdict(projs, dt):
    return {m: torch.from_numpy(P).to(dt) for m, P in projs.items()}


# ---------------------------------------------------------------- bases

@pytest.mark.parametrize("rank", ["2_to_2", "2_to_1", "1_to_2", "1_to_1"])
def test_contraction_bases_match_jax(rank):
    r = np.random.default_rng(0)
    shape = (3, 2, 7, 7) if rank.startswith("2") else (3, 2, 7)
    x = r.normal(size=shape)
    jfn = getattr(jign, f"contractions_{rank}")
    tfn = getattr(tign, f"contractions_{rank}")
    for dt, tol in ((np.float32, 1e-6), (np.float64, 1e-12)):
        with jax.enable_x64(dt == np.float64):
            want = np.asarray(jfn(jnp.asarray(x.astype(dt))))
        got = tfn(torch.from_numpy(x.astype(dt))).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # the 'inf' normalisation: summed ops over m and m^2
    unnorm = tfn(torch.from_numpy(x), normalize=False).numpy()
    np.testing.assert_allclose(
        unnorm, np.asarray(jfn(jnp.asarray(x.astype(np.float32)),
                               normalize=False)), rtol=1e-5, atol=1e-5)


def _wrap_flax(module):
    """A flax module that calls `module` as its child `inner`, taking and
    ignoring `training` (the bare layers take none)."""
    from flax import linen as nn

    class Wrap(nn.Module):
        inner: nn.Module

        @nn.compact
        def __call__(self, x, training: bool = True):
            return self.inner(x)
    return Wrap(module)


class _Wrapped(torch.nn.Module):
    """The port's counterpart of `_wrap_flax`: the layer as `inner`."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        return self.inner(x)


@pytest.mark.parametrize("ranks", [(2, 2), (2, 1), (1, 2), (1, 1)])
def test_equivariant_layer_matches_jax(ranks):
    r = np.random.default_rng(1)
    shape = (3, 4, 6, 6) if ranks[0] == 2 else (3, 4, 6)
    x = r.normal(size=shape)
    _, var = module_parity(
        _wrap_flax(jign.EquivariantLayer(5, *ranks)),
        lambda dt: (jnp.asarray(x.astype(dt)),),
        _Wrapped(tign.EquivariantLayer(4, 5, *ranks)),
        lambda dt: (torch.from_numpy(x).to(dt),), check_eval=False)
    assert set(var["params"]["inner"]) == (
        {"coeffs", "bias", "diag_bias"} if ranks == (2, 2)
        else {"coeffs", "bias"})


def test_basic_equivariant_layer_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 3, 5, 5))
    module_parity(_wrap_flax(jign.BasicEquivariantLayer(4)),
                  lambda dt: (jnp.asarray(x.astype(dt)),),
                  _Wrapped(tign.BasicEquivariantLayer(3, 4)),
                  lambda dt: (torch.from_numpy(x).to(dt),),
                  check_eval=False)


def test_coeff_init_scale():
    """coeffs ~ randn * sqrt(2) / (D + S), bias and diag_bias 0."""
    layer = tign.EquivariantLayer(40, 60, 2, 2)
    init_parameters(layer, torch.Generator().manual_seed(0))
    std = float(layer.coeffs.detach().std())
    assert abs(std - np.sqrt(2.0) / 100) < 0.05 * np.sqrt(2.0) / 100
    assert not layer.bias.any() and not layer.diag_bias.any()


@pytest.mark.parametrize("use_bn", [True, False])
def test_ign2to1_matches_jax(use_bn):
    """Forward, gradients and (with BN) running statistics and the eval
    output from them."""
    _, _, projs = grid_projs()
    P = projs[2]                                   # [S, 1, 36, 36]
    module_parity(jign.IGN2to1(8, 3, use_bn=use_bn),
                  lambda dt: (jnp.asarray(P.astype(dt)),),
                  tign.IGN2to1(8, 3, use_bn=use_bn),
                  lambda dt: (torch.from_numpy(P).to(dt),))


def test_ign2to1_makes_no_batchnorm_for_fc1():
    names = {n for n, _ in tign.IGN2to1(8, 2).named_modules()}
    assert {"bn_0", "bn_1", "bn_2"} <= names and "bn_3" not in names
    assert sum(p.numel() for p in tign.IGN2to1(16, 1).parameters()) == (
        96 + 32 + 528 + 32 + 528 + 32 + 272 + 17)


def test_ign_is_permutation_equivariant():
    """Permuting the nodes of every projector permutes the IGN's node
    outputs (BN over the rows is order-blind)."""
    _, _, projs = grid_projs()
    P = torch.from_numpy(projs[2]).double()
    perm = torch.from_numpy(np.random.default_rng(3).permutation(
        P.shape[-1]))
    tm = tign.IGN2to1(8, 2).double()
    init_parameters(tm, torch.Generator().manual_seed(0))
    out = tm(P)
    out_p = tm(P[:, :, perm][:, :, :, perm])
    np.testing.assert_allclose(out_p.detach().numpy(),
                               out[:, :, perm].detach().numpy(),
                               rtol=1e-10, atol=1e-10)
    for rank in ("2_to_2", "2_to_1"):
        fn = getattr(tign, f"contractions_{rank}")
        a, b = fn(P), fn(P[:, :, perm][:, :, :, perm])
        want = a[..., perm, :][..., perm] if rank == "2_to_2" else \
            a[..., perm]
        np.testing.assert_allclose(b.numpy(), want.numpy(), atol=1e-12)


# ---------------------------------------------------------------- layout

def test_eigenspace_layout_and_projectors_match_jax_bit_for_bit():
    vals, vecs = grid_spectrum(8)
    jl, tl = jspec.eigenspace_layout(vals), tspec.eigenspace_layout(vals)
    for f in ("uniq_vals", "counts", "sections"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f))
    assert tl.uniq_mults == jl.uniq_mults
    assert tl.spaces_per_mult == jl.spaces_per_mult
    assert tl.num_spaces == jl.num_spaces
    assert tspec.prop_higher_mult(tl, 64) == jspec.prop_higher_mult(jl, 64)
    jp = jspec.projectors_by_multiplicity(vecs, jl)
    tp = tspec.projectors_by_multiplicity(vecs, tl)
    assert sorted(tp) == sorted(jp)
    for m in jp:
        assert tp[m].dtype == np.float32
        np.testing.assert_array_equal(tp[m], jp[m])
    np.testing.assert_array_equal(tspec.round_eigvals(vals),
                                  jspec.round_eigvals(vals))


# ---------------------------------------------------------------- BasisNet

class _BasisFeatures:
    """flax and port wrappers: the encoder's outputs as basis features in
    both layouts, side by side."""

    @staticmethod
    def flax(enc, n):
        from flax import linen as nn

        class F(nn.Module):
            enc: nn.Module

            @nn.compact
            def __call__(self, projs, training: bool = True):
                outs = self.enc(projs, training=training)
                return jnp.concatenate([JM.basis_features(outs, n, layout=l)
                                        for l in ("reference", "aligned")],
                                       -1)
        return F(enc)

    class Port(torch.nn.Module):
        def __init__(self, enc, n):
            super().__init__()
            self.enc, self.n = enc, n

        def forward(self, projs):
            outs = self.enc(projs)
            return torch.cat([TM.basis_features(outs, self.n, layout=l)
                              for l in ("reference", "aligned")], -1)


@pytest.mark.parametrize("shared", [False, True])
def test_basisnet_encoders_and_features_match_jax(shared):
    _, lay, projs = grid_projs()
    mults = tuple(lay.uniq_mults)
    if shared:
        jenc, tenc = JM.IGNShared(mults, hidden=8), TM.IGNShared(mults, 8)
    else:
        jenc, tenc = JM.IGNBasisInv(mults, hidden=8), TM.IGNBasisInv(mults, 8)
    out, var = module_parity(_BasisFeatures.flax(jenc, 36),
                             lambda dt: (jdict(projs, dt),),
                             _BasisFeatures.Port(tenc, 36),
                             lambda dt: (tdict(projs, dt),))
    assert out.shape == (36, 2 * sum(m * s for m, s in
                                     lay.spaces_per_mult.items()))
    want = ({"enc"} | {f"fc_m{m}" for m in mults} if shared
            else {f"enc_m{m}" for m in mults})
    assert {p[1] for p in _flat(var["params"])} == want


def test_basis_features_layouts():
    """reference = the raw reshape of each [S, m, n] block; aligned = node
    i's own outputs; buckets in sorted order."""
    r = np.random.default_rng(4)
    outs = {2: r.normal(size=(3, 2, 5)).astype(np.float32),
            1: r.normal(size=(4, 1, 5)).astype(np.float32)}
    t = {m: torch.from_numpy(v).transpose(1, 2).contiguous().transpose(1, 2)
         for m, v in outs.items()}
    for layout in ("reference", "aligned"):
        want = np.asarray(JM.basis_features(
            {m: jnp.asarray(v) for m, v in outs.items()}, 5, layout=layout))
        got = TM.basis_features(t, 5, layout=layout).numpy()
        np.testing.assert_array_equal(got, want)
    ref = TM.basis_features(t, 5).numpy()
    np.testing.assert_array_equal(ref[:, :4], outs[1].reshape(5, -1))
    aligned = TM.basis_features(t, 5, layout="aligned").numpy()
    np.testing.assert_array_equal(aligned[:, 4:],
                                  outs[2].transpose(2, 0, 1).reshape(5, -1))


# ---------------------------------------------------------------- DeepSets

@pytest.mark.parametrize("use_bn,use_ln,layers", [
    (False, False, 3), (True, False, 3), (True, True, 2), (False, False, 1)])
def test_eq_deepsets_encoder_matches_jax(use_bn, use_ln, layers):
    x = np.random.default_rng(5).normal(size=(4, 9, 3))
    jm = jds.EqDeepSetsEncoder(hidden=8, out=2, num_layers=layers,
                               use_bn=use_bn, use_ln=use_ln)
    tm = tds.EqDeepSetsEncoder(3, hidden=8, out=2, num_layers=layers,
                               use_bn=use_bn, use_ln=use_ln)
    # BN without running statistics: the eval output uses batch statistics
    # too, so the eval check holds it against the train output's
    out, _ = module_parity(jm, lambda dt: (jnp.asarray(x.astype(dt)),), tm,
                           lambda dt: (torch.from_numpy(x).to(dt),))
    if use_bn:
        tm.eval()
        with torch.no_grad():
            np.testing.assert_array_equal(
                tm(torch.from_numpy(x).float()).numpy(),
                out.detach().numpy())


def test_batchnorm_without_running_stats_in_eval():
    """Batch statistics in eval, buffers never move (and still registered
    at mean 0 and var 1, as flax creates them)."""
    x = np.random.default_rng(6).normal(loc=3.0, size=(20, 4))
    bn = tnorm.MaskedBatchNorm(4, track_running_stats=False)
    jbn = jnorm.MaskedBatchNorm(4, track_running_stats=False)
    var = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32),
                   training=False)
    load_flax_variables(bn, jax.tree.map(np.asarray, var))
    for training in (True, False):
        bn.train(training)
        got = bn(torch.from_numpy(x).float())
        want, upd = jbn.apply(var, jnp.asarray(x, jnp.float32),
                              training=training, mutable=["batch_stats"])
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
        np.testing.assert_array_equal(bn.running_mean.numpy(), 0.0)
        np.testing.assert_array_equal(bn.running_var.numpy(), 1.0)
        np.testing.assert_array_equal(
            np.asarray(upd["batch_stats"]["mean"]), 0.0)
    np.testing.assert_allclose(got.detach().numpy().mean(0), 0.0, atol=1e-5)
