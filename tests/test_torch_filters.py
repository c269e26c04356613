"""The LearningFilters slice of the port against the JAX package:
`FilterModel` under every `lap_method` (the SignNet
PE with each phi, the BasisNet PE with each IGN; the eval output where BN
keeps running statistics, the IGN's) and the bridge over every
`FilterModel` variant, under bridged parameters.  tests/test_torch_ign.py
holds the IGN, BasisNet and DeepSets blocks;
tests/test_torch_filter_nets.py the nine nets alone;
tests/test_torch_filters_run.py Adam steps of `train_filters`' train step,
the 2D-grid loader and the `train_filters` entry point.

No kernel lies on this path in either package: `propagate` is a gather
and a segment sum (XLA in JAX), `TransformerNet`'s attention dense einsums.

Graph: a 6x6 grid (36 nodes) with random images; eigenvectors and
projectors of its Laplacian with N(0, 1e-2) noise (`off_the_kink`): exact
ones put first layers on ReLU's kink through the grid's symmetry (zero
entries, zero row sums), where each package takes the side its summation
order gives.

Tolerances as in tests/test_torch_ign.py (`module_parity`): outputs and
BN statistics 1e-5 in f32, gradients 1e-7 relative in f64 (JAX under
x64), the port's f32 gradients within 1e-4 relative plus twice JAX's f32
error of its f64 ones; the sign-flip model's eval output bit for bit the
unflipped model's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signnet_basisnet_tpu import train_filters as JF
from signnet_basisnet_tpu.graph import from_arrays as jfrom_arrays

from signnet_basisnet_tpu_torch import train_filters as TF
from signnet_basisnet_tpu_torch.bridge import (load_flax_variables,
                                               port_value, torch_name)
from signnet_basisnet_tpu_torch.graph import batch_np, from_arrays
from signnet_basisnet_tpu_torch.training import count_params

from test_torch_ign import (TOL, grid_projs, grid_spectrum, jdict,
                            module_parity, tdict)
from test_torch_pe import _flat

N = 36


def grid_arrays(side=6):
    """The side x side grid as one batch (no padding node or edge)."""
    n = side * side
    s, r = [], []
    for i in range(side):
        for j in range(side):
            u = i * side + j
            for v in ([u + 1] if j + 1 < side else []) + (
                    [u + side] if i + 1 < side else []):
                s += [u, v]
                r += [v, u]
    return batch_np([dict(senders=np.array(s), receivers=np.array(r),
                          node_feat=np.zeros((n, 1), np.float32))],
                    num_nodes=n, num_edges=len(s), num_graphs=2)


ARRAYS = grid_arrays()


def jgb(dt):
    return jfrom_arrays({k: v.astype(dt) if v.dtype.kind == "f" else v
                         for k, v in ARRAYS.items()})


def tgb(dt):
    return from_arrays(ARRAYS).cast_floats(dt)


def inputs(k=5, seed=0):
    """Image [36, 1], the first k eigenvectors (with N(0, 1e-2) noise) and
    eigenvalues, and the noisy projector stacks of all of them."""
    r = np.random.default_rng(seed)
    vals, vecs = grid_spectrum()
    vecs = (vecs + r.normal(scale=1e-2, size=vecs.shape)).astype(np.float32)
    _, layout, projs = grid_projs()
    x = r.random((N, 1)).astype(np.float32)
    return dict(x=x, vecs=vecs[:, :k], vals=vals[:k], layout=layout,
                projs=projs, all_vals=vals)


def fm_kwargs(inp, lap_method):
    """(dtype, for JAX?) -> the model's eigen inputs, in that package's
    arrays: eigenvectors and eigenvalues, or (basis_inv) all eigenvalues
    and the projector stacks."""
    def kw(dt, J):
        arr = ((lambda a: jnp.asarray(a.astype(dt))) if J
               else (lambda a: torch.from_numpy(a).to(dt)))
        if lap_method == "basis_inv":
            return dict(eigvals=arr(inp["all_vals"]),
                        projs=(jdict if J else tdict)(inp["projs"], dt))
        return dict(eigvecs=arr(inp["vecs"]), eigvals=arr(inp["vals"]))
    return kw


def models(inp, net="DS", lap_method="none", sign_inv_net="DS",
           basis_inv_net="IGN", hidden=8, use_eig=True):
    """The JAX FilterModel and the port's, of one variant."""
    lay = inp["layout"]
    k = len(inp["all_vals"]) if lap_method == "basis_inv" else \
        inp["vecs"].shape[1]
    kw = dict(net=net, hidden=hidden, num_layers=2, use_eig=use_eig,
              lap_method=lap_method, sign_inv_net=sign_inv_net,
              basis_inv_net=basis_inv_net, mult_list=tuple(lay.uniq_mults),
              k=k, ign_hidden=8)
    return (JF.FilterModel(**kw),
            TF.FilterModel(**kw, spaces_per_mult=lay.spaces_per_mult))


def _dt(dt):
    return torch.float64 if dt in (np.float64, torch.float64) else \
        torch.float32


# ---------------------------------------------------------------- FilterModel

VARIANTS = [
    ("MLP", "none", "DS", "IGN"),
    ("GcnNet", "abs_val", "DS", "IGN"),
    ("DS", "sign_inv", "DS", "IGN"),
    ("Transformer", "sign_inv", "MLP", "IGN"),
    ("MLP", "sign_inv", "Transformer", "IGN"),
    ("DS", "basis_inv", "DS", "IGN"),
    ("ChebNet", "basis_inv", "DS", "IGNShared"),
]


@pytest.mark.parametrize("net,lap_method,sign_inv_net,basis_inv_net",
                         VARIANTS)
def test_filter_model_matches_jax(net, lap_method, sign_inv_net,
                                  basis_inv_net):
    inp = inputs()
    jm, tm = models(inp, net, lap_method, sign_inv_net, basis_inv_net)
    kw = fm_kwargs(inp, lap_method)
    x = inp["x"]
    out, var = module_parity(
        jm, lambda dt: (jgb(dt), jnp.asarray(x.astype(dt))), tm,
        lambda dt: (tgb(_dt(dt)), torch.from_numpy(x).to(_dt(dt))),
        jkw=lambda dt: kw(dt, True), tkw=lambda dt: kw(_dt(dt), False),
        check_eval=lap_method == "basis_inv")
    assert out.shape == (N, 1)
    assert count_params(tm) == sum(a.size for a in
                                   _flat(var["params"]).values())


def test_sign_flip_model():
    """Eval: the unflipped features, bit for bit the `none` model's output
    from the same weights, and JAX's within 1e-5.  Training: each
    eigenvector column the base net sees is + or - the unflipped one, with
    both signs drawn over a few steps."""
    inp = inputs()
    jm, tm = models(inp, "MLP", "sign_flip")
    _, tnone = models(inp, "MLP", "none")
    gb, x = tgb(torch.float32), torch.from_numpy(inp["x"])
    kw = fm_kwargs(inp, "sign_flip")
    var = _init(jm, inp, "sign_flip")
    load_flax_variables(tm, var)
    load_flax_variables(tnone, var)
    tm.eval()
    tnone.eval()
    with torch.no_grad():
        got = tm(gb, x, **kw(torch.float32, False))
        np.testing.assert_array_equal(
            got.numpy(), tnone(gb, x, **kw(torch.float32, False)).numpy())
    want = jm.apply(var, jgb(np.float32), jnp.asarray(inp["x"]),
                    training=False, **kw(np.float32, True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    seen = []
    hook = tm.base.register_forward_pre_hook(
        lambda mod, args: seen.append(args[1].detach().clone()))
    tm.train()
    for _ in range(6):
        tm(gb, x, **kw(torch.float32, False))
    hook.remove()
    v = inp["vecs"]
    k = v.shape[1]
    signs = []
    for feats in seen:
        np.testing.assert_array_equal(feats[:, :1].numpy(), inp["x"])
        cols = feats[:, 1:1 + k].numpy()
        s = np.sign(cols[0] * v[0])
        np.testing.assert_array_equal(cols, v * s[None, :])
        np.testing.assert_array_equal(feats[:, 1 + k:].numpy(),
                                      np.broadcast_to(inp["vals"], (N, k)))
        signs.append(s)
    assert (np.array(signs) < 0).any() and (np.array(signs) > 0).any()
    assert tm.flip_rng.seed == 2


# ---------------------------------------------------------------- bridge

def _init(jm, inp, lap_method):
    kw = fm_kwargs(inp, lap_method)(np.float32, True)
    return jax.tree.map(np.asarray, jax.jit(lambda key: jm.init(
        {"params": key}, jgb(np.float32), jnp.asarray(inp["x"]),
        training=False, **kw))(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("variant", [
    ("Transformer", "sign_inv", "Transformer", "IGN"),
    ("GatNet", "sign_flip", "DS", "IGN"), ("BernNet", "none", "DS", "IGN"),
    ("GPRNet", "abs_val", "DS", "IGN"), ("ARMANet", "none", "DS", "IGN")])
def test_bridge_sets_every_filter_model_tensor(variant):
    """A real flax init of the variant fills every port tensor, each leaf
    in the port's layout (DenseGeneral kernels reshaped, bare leaves as
    they are).  The variants of `test_filter_model_matches_jax` are
    bridged there, from their flax inits, before their outputs are held
    to JAX's."""
    inp = inputs()
    jm, tm = models(inp, *variant)
    var = _init(jm, inp, variant[1])
    load_flax_variables(tm, var)
    tensors = dict(tm.named_parameters())
    tensors.update(tm.named_buffers())
    for coll in ("params", "batch_stats"):
        for path, a in _flat(var.get(coll, {})).items():
            np.testing.assert_array_equal(
                tensors[torch_name(path)].detach().numpy(),
                port_value(path, a))


def test_bridge_refuses_unmatched_leaves_and_unset_tensors():
    inp = inputs()
    jm, tm = models(inp, "Transformer", "none")
    var = _init(jm, inp, "none")
    # a leaf with no rule
    bad = {"params": dict(var["params"], base=dict(
        var["params"]["base"], odd={"gamma": np.zeros(3)}))}
    with pytest.raises(KeyError, match="no rule"):
        load_flax_variables(tm, bad)
    # a leaf whose module the port lacks
    bad = {"params": dict(var["params"], base=dict(
        var["params"]["base"], fc9={"kernel": np.zeros((3, 3))}))}
    with pytest.raises(KeyError, match="no such tensor"):
        load_flax_variables(tm, bad)
    # a port tensor no leaf sets
    base = dict(var["params"]["base"])
    del base["attn_1"]
    with pytest.raises(KeyError, match="do not set"):
        load_flax_variables(tm, {"params": dict(var["params"], base=base)})
    # a kernel of the wrong size
    base = dict(var["params"]["base"])
    base["fc2"] = dict(base["fc2"], kernel=np.zeros((3, 1)))
    with pytest.raises(ValueError, match="does not fit"):
        load_flax_variables(tm, {"params": dict(var["params"], base=base)})
