"""The PNA slice of the port against the JAX package: `segment_min` and
`segment_softmax`, `GraphBatch.snorm`, `avg_degree_stats`, PNA's nine
aggregators and three scalers, `PNALayer` and `PNANoTowersLayer`, the GRU
update and `PNANet`'s train and eval steps, under bridged parameters.
tests/test_torch_train_step.py runs the four PNA configs through the
port's `train_zinc` on the CPU.

PNA's layers reach no kernel in either package (their sums, maxima and
minima are segment ops), so under `pallas_tile` only the GIN SignNet phi
of `pna_zinc_signinv_gin` reaches the tile-local SpMM (the JAX kernel in
interpret mode, the port's plain version).

Ties: the molecule batches below give exactly tied maxima and minima (a
CF3 group's three fluorines, a six-ring's two neighbours of each atom),
where both packages share the gradient evenly among the tied entries.

Tolerances, float32: `snorm`, `avg_degree_stats` and the segment max and
min values bit for bit (the same reductions of the same numbers); the
softmax, the aggregators and the layers' outputs and BN statistics 1e-5;
the gradients of the segment ops and the aggregators 1e-4 relative plus
1e-6 or, where larger, 1e-6 of the largest gradient.  The layers'
gradients are held in f64, JAX under x64 against the port, at 1e-7
relative plus 1e-9 of the largest; the port's f32 gradients against its
f64 ones at 1e-4 relative plus the larger of 1e-4 of the largest gradient
and twice JAX's largest f32 error on that tensor.  The f32 gradients of
PNA are noisy in both packages: at a node of degree 2 whose two messages
are close (1.2439 and 1.2342 on one of these batches), var = E[m^2] -
E[m]^2 cancels to 2.3e-5 and loses its last digits, and std =
sqrt(var + 1e-5) passes that on; each package's f32 gradients stray from
the f64 ones by up to 2e-4 of the largest gradient (PNA layers at width
12), in different elements.  The train step as in tests/test_torch_pe.py's `step_parity` (losses 1e-5
relative, step-1 gradients 1e-6 + 1e-4 relative, BN statistics 1e-5 /
1e-3 after 1 / 3 steps, parameters 2e-5 but the elements with a step-1
gradient below 1e-6, 2 * lr per step); eval loss and MAE sums 1e-5
relative each.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from signnet_basisnet_tpu.data import zinc as jzinc
from signnet_basisnet_tpu.graph import from_arrays as jfrom_arrays
from signnet_basisnet_tpu.graph import segment as jseg
from signnet_basisnet_tpu.models import conv as jconv
from signnet_basisnet_tpu.nn.set2set import GRUStep as JGRUStep

from signnet_basisnet_tpu_torch.bridge import load_flax_variables, torch_name
from signnet_basisnet_tpu_torch.data import (add_lap_pe, avg_degree_stats,
                                             synthetic_zinc)
from signnet_basisnet_tpu_torch.graph import batch_np, from_arrays
from signnet_basisnet_tpu_torch.graph import segment as tseg
from signnet_basisnet_tpu_torch.models import conv as tconv
from signnet_basisnet_tpu_torch.nn.init import init_parameters
from signnet_basisnet_tpu_torch.nn.set2set import GRUStep

import torch_ranks
from test_torch_pe import _flat, _port_view, packed, small_graphs, \
    step_parity

TOL = dict(rtol=1e-5, atol=1e-5)
ALL_AGGREGATORS = ("mean", "sum", "max", "min", "var", "std", "moment3",
                   "moment4", "moment5")
SCALERS = ("identity", "amplification", "attenuation")


def _bond(s, r):
    return np.array(s + r), np.array(r + s)


def molecules():
    """Two hand-made molecules with automorphic atoms: CF3-CH2-OH (atom
    types C=0, F=1, O=2) and a six-ring of carbons."""
    s, r = _bond([0, 0, 0, 0, 4], [1, 2, 3, 4, 5])
    cf3 = dict(senders=s, receivers=r, node_feat=np.array([0, 1, 1, 1, 0, 2]),
               edge_feat=np.zeros(len(s), np.int32),
               y=np.array([0.5], np.float32))
    s, r = _bond(list(range(6)), [1, 2, 3, 4, 5, 0])
    ring = dict(senders=s, receivers=r, node_feat=np.zeros(6, np.int32),
                edge_feat=np.ones(len(s), np.int32),
                y=np.array([-0.5], np.float32))
    # 16 node slots: 4 padding nodes; 8 padding edges (mask 0) into the last
    return batch_np([cf3, ring], 16, 40, 3)


# ------------------------------------------------------------ segment ops

def _integer_segments(seed=0):
    """[E, 2, 3] small integers (ties everywhere), sorted ids over 7
    segments with two empty ones (2, 5) and one whose entries are all
    masked (6), plus masked entries inside the others."""
    r = np.random.default_rng(seed)
    ids = np.array([0, 0, 0, 0, 1, 1, 3, 3, 3, 4, 4, 4, 4, 4, 6, 6])
    mask = np.ones(len(ids), np.float32)
    mask[[2, 10, 14, 15]] = 0
    data = r.integers(-2, 3, size=(len(ids), 2, 3)).astype(np.float32)
    return data, ids, mask, 7


def _molecule_segments(seed=0):
    """Messages h[senders] of a random atom-type table over the molecule
    batch: exact ties at the CF3 carbon and along the ring."""
    a = molecules()
    table = np.random.default_rng(seed).normal(size=(3, 4)).astype(np.float32)
    data = table[a["node_feat"]][a["senders"]]
    return data, a["receivers"], a["edge_mask"], len(a["node_mask"])


@pytest.mark.parametrize("source", ["integers", "molecules"])
@pytest.mark.parametrize("fn", ["segment_min", "segment_max",
                                "segment_softmax"])
def test_segment_reductions_match_jax(fn, source):
    """Values and the gradient of sum(out * c): empty segments give 0
    (min, max) or nothing (softmax), masked entries get no gradient, and a
    tied extreme shares it evenly."""
    data, ids, mask, n = (_integer_segments() if source == "integers"
                          else _molecule_segments())
    jf, tf = getattr(jseg, fn), getattr(tseg, fn)
    out = np.asarray(jf(jnp.asarray(data), jnp.asarray(ids), n,
                        mask=jnp.asarray(mask)))
    c = np.random.default_rng(1).normal(size=out.shape).astype(np.float32)
    jgrad = np.asarray(jax.grad(lambda d: (jf(d, jnp.asarray(ids), n,
                                              mask=jnp.asarray(mask)) * c
                                           ).sum())(jnp.asarray(data)))
    td = torch.from_numpy(data).requires_grad_(True)
    got = tf(td, torch.from_numpy(ids), n, mask=torch.from_numpy(mask))
    (got * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(td.grad.numpy(), jgrad, rtol=1e-5, atol=1e-6)
    assert (td.grad.numpy()[mask == 0] == 0).all()
    if fn == "segment_softmax":
        np.testing.assert_allclose(got.detach().numpy(), out, **TOL)
        return
    assert np.array_equal(got.detach().numpy(), out)
    # the empty and the all-masked segments
    present = set(ids[mask > 0].tolist())
    empty = [s for s in range(n) if s not in present]
    assert empty and (out[empty] == 0).all()
    # ties: some extreme is shared, and so is its gradient, in both
    share = jax.grad(lambda d: jf(d, jnp.asarray(ids), n,
                                  mask=jnp.asarray(mask)).sum())(
        jnp.asarray(data))
    td.grad = None
    tf(td, torch.from_numpy(ids), n, mask=torch.from_numpy(mask)).sum(
    ).backward()
    g = td.grad.numpy()
    assert ((g > 0) & (g < 1)).any()
    assert np.array_equal(g, np.asarray(share))


def test_segment_min_and_softmax_of_all_masked_input():
    """Every entry masked: min gives `empty_value`, softmax all zeros."""
    data = torch.randn(6, 3)
    ids = torch.tensor([0, 0, 1, 1, 1, 2])
    mask = torch.zeros(6)
    out = tseg.segment_min(data, ids, 3, mask=mask, empty_value=-7.0)
    assert torch.equal(out, torch.full((3, 3), -7.0))
    soft = tseg.segment_softmax(data, ids, 3, mask=mask)
    assert torch.equal(soft, torch.zeros(6, 3))


# ------------------------------------------------------ batch and host code

def test_snorm_and_avg_degree_stats_match_jax():
    gs = small_graphs(9, seed=1)
    arrays = packed(gs, 0, extra_nodes=32)
    a = from_arrays(arrays).snorm()
    assert a.shape == (len(arrays["node_mask"]), 1)
    assert np.array_equal(a.numpy(), np.asarray(jfrom_arrays(arrays).snorm()))
    assert (a.numpy()[arrays["node_mask"] == 0] == 0).all()
    train = synthetic_zinc(40, 0, 0, seed=3)["train"]
    got = avg_degree_stats(train)
    assert got == jzinc.avg_degree_stats(train)
    assert got["log"] > 0 and got["exp"] > 1


# ------------------------------------------------------------ aggregators

def complete_graphs(sizes=(4, 5, 6)):
    """Complete graphs (every real in-degree >= 3) in one batch with 5
    padding nodes and 6 padding edges."""
    gs = []
    for n in sizes:
        s, r = np.nonzero(1 - np.eye(n, dtype=int))
        gs.append(dict(senders=s, receivers=r, node_feat=np.zeros(n, np.int32),
                       edge_feat=np.zeros(len(s), np.int32),
                       y=np.zeros(1, np.float32)))
    return batch_np(gs, sum(sizes) + 5,
                    sum(len(g["senders"]) for g in gs) + 6, len(gs) + 1)


@pytest.mark.parametrize("source", ["random", "molecules"])
def test_pna_aggregate_and_scale_match_jax(source):
    """All nine aggregators times the three scalers, values and the
    gradient of a weighted sum, on a batch with padding nodes (degree 0,
    clamped to 1) and masked padding edges.  The centred moments are
    sign(M) (|M| + eps)^(1/n), which jumps at M = 0, so they run on random
    messages into nodes of in-degree >= 3 (complete graphs): at in-degree
    2 the odd moments are 0 up to rounding, and either package's moment5
    there is +-0.1 by the sign of its rounding noise.  On the molecules
    (exact ties) the other six run."""
    if source == "random":
        arrays = complete_graphs()
        msg = np.random.default_rng(2).normal(
            size=(len(arrays["senders"]), 5)).astype(np.float32)
        aggregators = ALL_AGGREGATORS
    else:
        arrays = molecules()
        msg = _molecule_segments()[0]
        aggregators = ("mean", "sum", "max", "min", "var", "std")
    jgb, tgb = jfrom_arrays(arrays), from_arrays(arrays)
    avg_d_log = 0.9

    def jfn(m):
        aggs, deg = jconv.pna_aggregate(m, jgb, aggregators)
        h = jnp.concatenate(aggs, axis=-1)
        return jnp.concatenate(jconv.pna_scale(h, deg, avg_d_log, SCALERS),
                               axis=-1), deg

    want, jdeg = jax.jit(jfn)(jnp.asarray(msg))
    c = np.random.default_rng(3).normal(size=want.shape).astype(np.float32)
    jgrad = np.asarray(jax.jit(jax.grad(lambda m: (jfn(m)[0] * c).sum()))(
        jnp.asarray(msg)))
    tm = torch.from_numpy(msg).requires_grad_(True)
    aggs, deg = tconv.pna_aggregate(tm, tgb, aggregators)
    got = torch.cat(tconv.pna_scale(torch.cat(aggs, -1), deg, avg_d_log,
                                    SCALERS), -1)
    (got * torch.from_numpy(c)).sum().backward()
    assert got.shape == want.shape == (
        len(arrays["node_mask"]), msg.shape[1] * len(aggregators) * 3)
    assert np.array_equal(deg.numpy(), np.asarray(jdeg))
    assert deg.min() == 1
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    top = np.abs(jgrad).max()
    np.testing.assert_allclose(tm.grad.numpy(), jgrad, rtol=1e-4,
                               atol=max(1e-6 * top, 1e-6))
    assert (tm.grad.numpy()[arrays["edge_mask"] == 0] == 0).all()


def test_pna_aggregate_refuses_unknown_names():
    gb = from_arrays(molecules())
    msg = torch.zeros(gb.num_edges, 2)
    with pytest.raises(ValueError, match="aggregator"):
        tconv.pna_aggregate(msg, gb, ["median"])
    with pytest.raises(ValueError, match="scaler"):
        tconv.pna_scale(torch.zeros(3, 2), torch.ones(3, 1), 1.0, ["linear"])


# ------------------------------------------------------------------ layers

def layer_parity(jl, tl, arrays, inputs, snorm=False, seed=9):
    """jl(gb, *inputs[, snorm]) against tl(gb, *inputs[, snorm]) under the
    flax init's bridged parameters, in training mode, for the loss
    sum(out * c): in f32 the output and the BN running statistics; in f64
    (JAX under x64) the gradients of every parameter and input; and the
    port's f32 gradients against its own f64 ones.  Returns the port's
    f32 output."""
    jgb, tgb = jfrom_arrays(arrays), from_arrays(arrays)
    jx = (jgb.snorm(),) if snorm else ()
    var = jax.tree.map(np.asarray, jl.init(
        {"params": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)},
        jgb, *map(jnp.asarray, inputs), *jx, training=False))
    load_flax_variables(tl, var)
    t64 = copy.deepcopy(tl).double()
    stats = {k: v for k, v in var.items() if k == "batch_stats"}

    def fwd(params, *xs, gb=jgb):
        return jl.apply({"params": params, **stats}, gb, *xs,
                        *((gb.snorm(),) if snorm else ()),
                        training=True, mutable=["batch_stats"])

    c = np.random.default_rng(seed).normal(
        size=fwd(var["params"], *map(jnp.asarray, inputs))[0].shape)

    def grad(gb):
        def loss(params, *xs):
            out, upd = fwd(params, *xs, gb=gb)
            return (out * c.astype(out.dtype)).sum(), (out, upd)
        return jax.jit(jax.value_and_grad(
            loss, argnums=tuple(range(1 + len(inputs))), has_aux=True))

    (_, (jout, upd)), jg32 = grad(jgb)(var["params"],
                                       *map(jnp.asarray, inputs))
    with jax.enable_x64(True):
        gb64 = jfrom_arrays({k: v.astype(np.float64) if v.dtype == np.float32
                             else v for k, v in arrays.items()})
        _, jg64 = grad(gb64)(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                         var["params"]),
            *(jnp.asarray(a, jnp.float64) for a in inputs))
        jg64 = jax.tree.map(np.asarray, jg64)
    ports = []
    for model, gb, dt in ((tl, tgb, torch.float32),
                          (t64, tgb.cast_floats(torch.float64),
                           torch.float64)):
        xs = [torch.from_numpy(a).to(dt).requires_grad_(True)
              for a in inputs]
        out = model(gb, *xs, *((gb.snorm(),) if snorm else ()))
        (out * torch.from_numpy(c).to(dt)).sum().backward()
        ports.append((out, xs))
    tout, tin = ports[0]
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    buffers = dict(tl.named_buffers())
    assert len(buffers) == len(_flat(upd.get("batch_stats", {})))
    for path, s in _flat(upd.get("batch_stats", {})).items():
        np.testing.assert_allclose(buffers[torch_name(path)].numpy(), s,
                                   **TOL)
    # (port f32, port f64, JAX f32, JAX f64) gradient per tensor
    params, exact = dict(tl.named_parameters()), dict(t64.named_parameters())
    g32, g64 = _flat(jg32[0]), _flat(jg64[0])
    assert len(params) == len(g32)
    quads = [(params[torch_name(p)].grad, exact[torch_name(p)].grad,
              _port_view(p, g32[p]), _port_view(p, g64[p]), torch_name(p))
             for p in g32]
    quads += [(t.grad, t64_.grad, np.asarray(a), np.asarray(b), "input")
              for t, t64_, a, b in zip(tin, ports[1][1], jg32[1:], jg64[1:])]
    top = max(np.abs(q[3]).max() for q in quads)
    for got, got64, want32, want64, name in quads:
        if got is None:             # an input the layer does not read
            assert got64 is None and (want64 == 0).all(), name
            continue
        ref = got64.numpy()
        np.testing.assert_allclose(ref, want64, rtol=1e-7, atol=1e-9 * top,
                                   err_msg=name)
        bar = 1e-4 * np.abs(ref) + max(1e-4 * top,
                                       2 * np.abs(want32 - ref).max())
        err = np.abs(got.numpy() - ref)
        assert (err <= bar).all(), (name, float((err - bar).max()))
    return tout


def _pna_inputs(arrays, width=12, edge_width=16, seed=4):
    """h = a random table of the atom types (tied rows for equal atoms)
    plus noise on half the columns, zero on padding rows; e random."""
    r = np.random.default_rng(seed)
    codes = arrays["node_feat"].reshape(len(arrays["node_mask"]), -1)[:, 0]
    h = r.normal(size=(int(codes.max()) + 1, width))[codes]
    h[:, width // 2:] += r.normal(size=(len(codes), width - width // 2))
    h = (h * arrays["node_mask"][:, None]).astype(np.float32)
    e = r.normal(size=(len(arrays["senders"]), edge_width)).astype(np.float32)
    return h, e


@pytest.mark.parametrize("edge_features", [True, False])
@pytest.mark.parametrize("divide_input", [True, False])
def test_pna_layer_matches_jax(divide_input, edge_features):
    """Two towers, graph norm by snorm, residual; the message input carries
    the whole bond embedding (16 wide) with edge features."""
    arrays = packed(small_graphs(9, seed=5), 0, extra_nodes=32)
    h, e = _pna_inputs(arrays)
    kw = dict(towers=2, residual=True, edge_features=edge_features,
              divide_input=divide_input)
    jl = jconv.PNALayer(12, ("mean", "max", "min", "std"), SCALERS, 1.1,
                        **kw)
    tl = tconv.PNALayer(12, 12, 16, ("mean", "max", "min", "std"), SCALERS,
                        1.1, **kw)
    assert tl.tower_0.pretrans.lin_0.weight.shape[1] == (
        (12 if not divide_input else 6) * 2 + (16 if edge_features else 0))
    layer_parity(jl, tl, arrays, [h, e], snorm=True)


@pytest.mark.parametrize("edge_features", [True, False])
def test_pna_no_towers_layer_matches_jax(edge_features):
    """With edge features: pretrans_h, the scalers, graph norm and [h,
    aggs] into posttrans_h.  Without: raw source rows, a single scaler
    (not applied) and posttrans_h over the aggregations only."""
    arrays = packed(small_graphs(9, seed=6), 0, extra_nodes=32)
    h, e = _pna_inputs(arrays, edge_width=12)
    scalers = SCALERS if edge_features else ("amplification",)
    jl = jconv.PNANoTowersLayer(12, ("mean", "min", "std", "max"), scalers,
                                0.8, edge_features=edge_features)
    tl = tconv.PNANoTowersLayer(12, 12, 12, ("mean", "min", "std", "max"),
                                scalers, 0.8, edge_features=edge_features)
    assert hasattr(tl, "pretrans_h") == edge_features
    layer_parity(jl, tl, arrays, [h, e], snorm=True)


def test_gru_step_matches_flax_gru_cell():
    """GRUStep(x, h) = flax GRUCell(h, x): six Linears, hr and hz without
    bias; values and gradients of both arguments."""
    r = np.random.default_rng(7)
    x, h = (r.normal(size=(10, 6)).astype(np.float32) for _ in range(2))
    jl = JGRUStep(6)
    var = jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x), jnp.asarray(h)))
    # non-zero biases, which the flax init leaves at zero
    var = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 if p[-1].key == "bias" else v, var)
    tl = GRUStep(6)
    load_flax_variables(tl, var)
    assert sorted(n for n, _ in tl.named_parameters()) == sorted(
        f"cell.{a}.{b}" for a in ("ir", "iz", "in", "hr", "hz", "hn")
        for b in ("weight", "bias") if not (a in ("hr", "hz") and b == "bias"))
    c = r.normal(size=(10, 6)).astype(np.float32)
    want, jg = jax.value_and_grad(
        lambda a, b: (jl.apply(var, a, b) * c).sum(), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(h))
    tx, th = (torch.from_numpy(a).requires_grad_(True) for a in (x, h))
    got = tl(tx, th)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jl.apply(var, jnp.asarray(x),
                                                   jnp.asarray(h))), **TOL)
    (got * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose((got * torch.from_numpy(c)).sum().item(),
                               float(want), rtol=1e-5)
    for t, g in zip((tx, th), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-6)


def test_pna_layers_take_the_model_parallel_halo(tmp_path):
    """The PNA layers read their source rows through
    `src_features` on a model-parallel shard: on a one-rank shard each
    equals the layer on the plain batch (tests/test_torch_mp_halo.py
    holds the route across ranks)."""
    arrays = molecules()
    gb = from_arrays(arrays)
    g = torch.Generator().manual_seed(0)
    h = torch.randn(gb.num_nodes, 4, generator=g)
    e = torch.randn(gb.num_edges, 4, generator=g)
    layers = (tconv.PNALayer(4, 4, 4, ["mean", "max"], ["identity"], 1.0,
                             towers=2, edge_features=True),
              tconv.PNANoTowersLayer(4, 4, 4, ["mean", "std"], ["identity"],
                                     1.0))
    for layer in layers:
        init_parameters(layer, torch.Generator().manual_seed(1))
    want = [layer(gb, h, e) for layer in layers]
    with torch_ranks.one_rank_shard(arrays, tmp_path) as shard:
        got = [layer(shard, h, torch_ranks.edge_rows(e, shard))
               for layer in layers]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- the net

PNA_NET = dict(hidden_dim=16, out_dim=16, n_layers=2, towers=2,
               avg_d_log=1.05, readout="sum",
               aggregators=("mean", "max", "min", "std"), scalers=SCALERS)


def test_pna_net_steps_match_jax_with_the_gin_phi_on_pallas_tile():
    """pna_zinc_signinv_gin's net cut to width 16 and 2 layers of 2
    towers, the GIN phi over k = 4 eigenvectors on a tiled batch: its
    aggregations run the tile-local SpMM (the JAX kernel in interpret
    mode, the port's plain version).  The SignNet output ties automorphic
    atoms exactly, so layer 0's max and min see exact ties."""
    gs = small_graphs(11, seed=0)
    add_lap_pe(gs, 4)
    net = dict(PNA_NET, pos_enc_dim=4, lap_method="sign_inv",
               sign_inv_net="gin", sign_inv_layers=2, pe_aggregate="add")
    step_parity("PNA", net, packed(gs, 4), "sign_inv", backend="pallas_tile",
                steps=1)


def test_pna_net_with_gru_and_no_towers_matches_jax():
    """tests/test_gap_components.py's PNANet(gru=True, no_towers=True),
    3 layers, no PE: one GRU shared between layers (after layers 0 and 1),
    the towerless layers with edge features."""
    gs = small_graphs(11, seed=1)
    net = dict(PNA_NET, n_layers=3, gru=True, no_towers=True, pe_init="none",
               lap_method="none")
    step_parity("PNA", net, packed(gs, 0), "none")

