"""The ninth slice's positional encodings against the JAX package: the full
EVD and the random-walk PE (host numpy), the batch helpers
`nodes_per_graph` and `in_degrees`, the sign baselines of models/pe.py,
the masked all-eigenvector SignNet (`MaskedGINDeepSigns`) and the
GatedGCN LapPE train and eval steps under abs_val, canonical and
sign_flip, under bridged parameters.

`step_parity` here is shared with tests/test_torch_masked.py,
tests/test_torch_lspe.py and the other slices' step tests (the Alchemy and
GINE-ZINC nets through its `modules`).  The step-1 gradients are read from the first
Adam moment on the JAX side (0.1 g after one step), which saves one
compile of the model.

Tolerances, float32 (the same as tests/test_torch_gatedgcn.py's, for the
same reasons):
- the EVD, the RWPE, the packed eigenvector arrays, `nodes_per_graph`,
  `in_degrees`, abs_val and canonical: bit for bit (the same numpy calls on
  the same arrays; a sign choice);
- modules, 1e-5; their gradients, 1e-4 relative plus 1e-6 or, where
  larger, 1e-6 of the largest gradient.  The masked SignNet's output and
  BN statistics, 1e-4 relative plus 1e-5: its BatchNorms see rows that are
  mostly the same (the zero slots past each graph's size, the padding
  rows), and on the test's batch each package's f32 output is 3-6e-5 from
  the port's f64 one (the JAX one farther), so the f32 pair can differ by
  that much with neither at fault.  For the same reason its gradients
  are held to 1e-4 relative plus the larger of the floor above and twice
  JAX's own distance, element by element, from the port's f64 gradient
  (a phi bias ahead of a ReLU that is active on almost every row has an
  exact gradient near 0 and f32 noise of up to 1e-4 of the largest
  gradient); the f64 gradients themselves must match JAX's within 1e-4
  relative plus 1e-3 of the largest;
- the train step: losses 1e-5 relative, gradients at step 1 1e-6 + 1e-4
  relative, BN statistics 1e-5 after step 1 and 1e-3 after step 3,
  parameters 2e-5 after 1 and 3 Adam steps except the elements whose step-1
  gradient is below 1e-6, held to 2 * lr per step; eval sums 1e-5
  relative;
- sign_flip's own draw, in distribution: the share of -1 over 10^4
  columns within 0.5 +- 0.03 (six standard deviations).  The two packages
  draw different bits, so the step test monkeypatches the port's draw to
  return the flips the JAX `sign_flip` draws from the step's keys.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from signnet_basisnet_tpu import models as JM
from signnet_basisnet_tpu.data import zinc as jzinc
from signnet_basisnet_tpu.graph import from_arrays as jfrom_arrays
from signnet_basisnet_tpu.graph import segment as jseg
from signnet_basisnet_tpu.graph.batch import batch_np as jbatch_np
from signnet_basisnet_tpu.models import pe as jpe
from signnet_basisnet_tpu.models.signnet import \
    MaskedGINDeepSigns as JMaskedGINDeepSigns
from signnet_basisnet_tpu.spectral import eigh as jeigh
from signnet_basisnet_tpu.training import adam as jadam
from signnet_basisnet_tpu.training import build_steps as jbuild_steps
from signnet_basisnet_tpu.training import create_state
from signnet_basisnet_tpu.training import make_lapeig_loss_fn as jlapeig
from signnet_basisnet_tpu.training import make_module_predict as \
    jmodule_predict
from signnet_basisnet_tpu.training import make_zinc_predict as jpredict

from signnet_basisnet_tpu_torch import models as TM
from signnet_basisnet_tpu_torch import spectral as tspec
from signnet_basisnet_tpu_torch import train_zinc
from signnet_basisnet_tpu_torch.bridge import load_flax_variables, torch_name
from signnet_basisnet_tpu_torch.data import (add_full_evd, add_lap_pe,
                                             add_rwpe, choose_budgets,
                                             load_zinc_pickle, pack_batches,
                                             synthetic_zinc)
from signnet_basisnet_tpu_torch.graph import batch_np, from_arrays
from signnet_basisnet_tpu_torch.graph import segment as tseg
from signnet_basisnet_tpu_torch.models import pe as tpe
from signnet_basisnet_tpu_torch.models.signnet import MaskedGINDeepSigns
from signnet_basisnet_tpu_torch.nn.dropout import DropoutRNG
from signnet_basisnet_tpu_torch.nn.init import init_parameters
from signnet_basisnet_tpu_torch.training import (Checkpointer, adam,
                                                 build_steps, load_config,
                                                 make_lapeig_loss_fn,
                                                 make_module_predict,
                                                 make_zinc_predict)

LR = 1e-3
TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=1e-6)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
LAPPE_NET = dict(hidden_dim=16, out_dim=16, n_layers=2, pos_enc_dim=4,
                 pe_aggregate="add")


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


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return out


def small_graphs(n_graphs=13, max_nodes=24, seed=0):
    """Synthetic molecules of at most `max_nodes` nodes (a tile of 32 holds
    each), drawn in order from the seeded stand-in."""
    gs = [g for g in synthetic_zinc(4 * n_graphs, 0, 0, seed=seed)["train"]
          if len(g["node_feat"]) <= max_nodes]
    return gs[:n_graphs]


def packed(gs, k, tile=32, extra_nodes=0):
    """One tiled batch of `gs` with k eigenvector columns; `extra_nodes`
    widens the node budget by that many padding rows."""
    nb, eb, gc = choose_budgets(gs, len(gs), tile=tile)
    out = pack_batches(gs, nb + extra_nodes, eb, gc, k=k, tile=tile)
    assert len(out) == 1
    return out[0]


def _backend(name):
    jseg.set_agg_backend(name)
    tseg.set_agg_backend(name)


@pytest.fixture
def pallas_tile():
    _backend("pallas_tile")
    with pltpu.force_tpu_interpret_mode():
        yield
    _backend("xla")


# ---------------------------------------------------------------- host code

def _fixture_graphs():
    return load_zinc_pickle(os.path.join(FIXTURES, "zinc_pkl"))["train"]


@pytest.mark.parametrize("normalization", [None, "sym"])
@pytest.mark.parametrize("source", ["fixture", "synthetic"])
def test_full_evd_matches_jax_bit_for_bit(normalization, source):
    """All n eigenpairs per graph, attached and packed at k = the largest
    graph: the same numpy eigh on the same Laplacian, so equal bit for bit,
    eigenvectors of repeated eigenvalues included."""
    gs = (_fixture_graphs() if source == "fixture"
          else synthetic_zinc(30, 0, 0, seed=5)["train"])
    tg = [dict(g) for g in gs]
    jg = [dict(g) for g in gs]
    add_full_evd(tg, normalization=normalization)
    jzinc.add_full_evd(jg, normalization=normalization)
    repeated = 0
    for g, a, b in zip(gs, tg, jg):
        n = len(g["node_feat"])
        vals, vecs = tspec.full_evd_np(g["senders"], g["receivers"], n,
                                       normalization=normalization)
        assert vals.shape == (n,) and vecs.shape == (n, n)
        jvals, jvecs = jeigh.full_evd_np(g["senders"], g["receivers"], n,
                                         normalization=normalization)
        assert np.array_equal(vals, jvals) and np.array_equal(vecs, jvecs)
        assert np.array_equal(vals, a["eigvals"])
        assert np.array_equal(a["eigvals"], b["eigvals"])
        assert np.array_equal(a["eigvecs"], b["eigvecs"])
        repeated += int((np.diff(vals) < 1e-6).any())
    assert repeated > 0  # degenerate spectra are part of the check
    k = max(len(g["node_feat"]) for g in gs)
    sub = tg[:8], jg[:8]
    nb = sum(len(g["node_feat"]) for g in sub[0]) + 5
    eb = sum(len(g["senders"]) for g in sub[0]) + 4
    a = batch_np(sub[0], nb, eb, 9, k=k)
    b = jbatch_np(sub[1], nb, eb, 9, k=k)
    for key in ("eigvecs", "eigvals", "eig_mask"):
        assert a[key].shape == b[key].shape and np.array_equal(a[key],
                                                               b[key]), key


@pytest.mark.parametrize("source", ["fixture", "synthetic"])
def test_rwpe_matches_jax_bit_for_bit(source):
    gs = (_fixture_graphs() if source == "fixture"
          else synthetic_zinc(30, 0, 0, seed=6)["train"])
    k = 8
    tg = [dict(g) for g in gs]
    jg = [dict(g) for g in gs]
    add_rwpe(tg, k)
    jzinc.add_rwpe(jg, k)
    for g, a, b in zip(gs, tg, jg):
        n = len(g["node_feat"])
        rw = tspec.rwpe_np(g["senders"], g["receivers"], n, k)
        assert rw.shape == (n, k) and rw.dtype == np.float32
        assert np.array_equal(rw, jeigh.rwpe_np(g["senders"],
                                                g["receivers"], n, k))
        assert np.array_equal(rw, a["eigvecs"])
        assert np.array_equal(a["eigvecs"], b["eigvecs"])
        assert np.array_equal(a["eigvals"], b["eigvals"])
    # the first step's return probability is 0 without self loops
    assert all((a["eigvecs"][:, 0] == 0).all() for a in tg)
    nb = sum(len(g["node_feat"]) for g in tg[:8]) + 3
    eb = sum(len(g["senders"]) for g in tg[:8]) + 2
    a = batch_np(tg[:8], nb, eb, 9, k=k)
    b = jbatch_np(jg[:8], nb, eb, 9, k=k)
    for key in ("eigvecs", "eig_mask"):
        assert np.array_equal(a[key], b[key]), key


def test_nodes_per_graph_and_in_degrees_match_jax():
    """Padding nodes belong to the padding graph slot, whose node count 0
    becomes 1; in-degrees count the real edges only."""
    gs = small_graphs(7)
    arrays = packed(gs, 4, extra_nodes=32)
    pad = arrays["node_mask"] == 0
    assert pad.any()
    assert (arrays["graph_id"][pad] == len(arrays["graph_mask"]) - 1).all()
    jgb, tgb = jfrom_arrays(arrays), from_arrays(arrays)
    a = tgb.nodes_per_graph()
    assert a.dtype == torch.float32
    assert np.array_equal(a.numpy(), np.asarray(jgb.nodes_per_graph()))
    assert (a.numpy()[pad] == 1).all()
    d = tgb.in_degrees()
    assert np.array_equal(d.numpy(), np.asarray(jgb.in_degrees()))
    assert d.sum() == arrays["edge_mask"].sum()


# ------------------------------------------------------------ sign handling

def _pe_batch(k=6, seed=2):
    gs = small_graphs(9, seed=seed)
    add_lap_pe(gs, k)
    arrays = packed(gs, k, extra_nodes=32)
    r = np.random.default_rng(seed)
    pe = (r.normal(size=arrays["eigvecs"].shape)
          * arrays["node_mask"][:, None]).astype(np.float32)
    return arrays, pe


@pytest.mark.parametrize("method", ["abs_val", "canonical", "canonical_ref",
                                    "none", "sign_inv"])
def test_sign_methods_match_jax(method):
    arrays, pe = _pe_batch()
    want = np.asarray(jpe.apply_lap_method(method, jfrom_arrays(arrays),
                                           jnp.asarray(pe)))
    got = tpe.apply_lap_method(method, from_arrays(arrays),
                               torch.from_numpy(pe))
    assert np.array_equal(got.numpy(), want)


def test_canonical_ref_keeps_the_published_minus_two():
    """A column where both criteria fire (fewer nonnegative entries and
    less nonnegative mass) is multiplied by -2 under canonical_ref and by -1
    under canonical, in both packages."""
    arrays, pe = _pe_batch(k=3)
    g0 = arrays["graph_id"] == 0
    rows = np.nonzero(g0)[0]
    pe[rows, 0] = -1.0
    pe[rows[0], 0] = 0.5          # 1 nonnegative of n, mass 0.5 < n - 1
    pe[rows, 1] = 1.0
    pe[rows[0], 1] = -0.5         # neither criterion: kept
    jgb, tgb = jfrom_arrays(arrays), from_arrays(arrays)
    for method, mult in (("canonical_ref", -2.0), ("canonical", -1.0)):
        got = tpe.apply_lap_method(method, tgb, torch.from_numpy(pe)).numpy()
        want = np.asarray(jpe.apply_lap_method(method, jgb,
                                               jnp.asarray(pe)))
        assert np.array_equal(got, want), method
        assert np.array_equal(got[rows, 0], mult * pe[rows, 0]), method
        assert np.array_equal(got[rows, 1], pe[rows, 1]), method


def test_canonical_takes_the_model_parallel_halo(tmp_path):
    """On a model-parallel shard the canonical signs come from
    per-graph counts summed over the mp group: on a one-rank shard they
    are the plain batch's, bit for bit (tests/test_torch_mp_halo.py holds
    them across ranks)."""
    import torch_ranks
    arrays, pe = _pe_batch()
    want = tpe.apply_lap_method("canonical", from_arrays(arrays),
                                torch.from_numpy(pe))
    with torch_ranks.one_rank_shard(arrays, tmp_path) as shard:
        got = tpe.apply_lap_method("canonical", shard, torch.from_numpy(pe))
    assert torch.equal(got, want)


def test_sign_flip_draws_half_negative_columns_from_its_seed():
    ones = torch.ones(3, 10_000)
    rng = DropoutRNG(5)
    out = tpe.apply_lap_method("sign_flip", None, ones, rng=rng)
    assert rng.draws == 1
    assert set(torch.unique(out).tolist()) == {-1.0, 1.0}
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])
    share = float((out[0] < 0).float().mean())
    assert abs(share - 0.5) < 0.03
    again = tpe.sign_flip(ones, DropoutRNG(5))
    assert torch.equal(again, out)
    assert not torch.equal(tpe.sign_flip(ones, rng), out)  # a fresh draw
    assert not torch.equal(tpe.sign_flip(ones, DropoutRNG(6)), out)
    with pytest.raises(ValueError, match="generator"):
        tpe.apply_lap_method("sign_flip", None, ones)
    with pytest.raises(ValueError, match="invalid"):
        tpe.apply_lap_method("random", None, ones)


# ------------------------------------------------------- masked SignNet phi

@pytest.mark.parametrize("backend", ["xla", "pallas_tile"])
def test_masked_signnet_matches_jax(backend):
    """MaskedGINDeepSigns on a full-EVD batch (k = the largest graph) with
    32 padding node rows, owned by the padding graph slot: the output, the
    BN statistics (rho's BN runs over every row, padding included) and
    every parameter's gradient.  Under pallas_tile the phi's aggregations
    go through the tile-local SpMM (the JAX kernel in interpret mode, the
    port's plain version) at F = 2k and 2k * hidden."""
    gs = small_graphs(9, seed=3)
    add_full_evd(gs)
    k = max(len(g["node_feat"]) for g in gs)
    arrays = packed(gs, k, extra_nodes=32)
    assert (arrays["node_mask"] == 0).sum() >= 32
    n = len(arrays["node_mask"])
    c = np.random.default_rng(4).normal(size=(n, k)).astype(np.float32)
    jgb = jfrom_arrays(arrays)
    jl = JMaskedGINDeepSigns(hidden=16, phi_out=4, num_layers=2, k=k,
                             use_bn=True, dropout=0.0)
    var = jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(1), jgb,
                                           jgb.eigvecs, training=False))
    tl = MaskedGINDeepSigns(hidden=16, phi_out=4, num_layers=2, k=k,
                            use_bn=True)
    load_flax_variables(tl, var)
    _backend(backend)
    try:
        def loss(params):
            out, upd = jl.apply({"params": params,
                                 "batch_stats": var["batch_stats"]}, jgb,
                                jgb.eigvecs, training=True,
                                mutable=["batch_stats"])
            return (out * c).sum(), (out, upd)

        with pltpu.force_tpu_interpret_mode():
            (_, (ja, upd)), gp = jax.jit(jax.value_and_grad(
                loss, has_aux=True))(var["params"])
        tgb = from_arrays(arrays)
        ta = tl(tgb, tgb.eigvecs)
        (ta * torch.from_numpy(c)).sum().backward()
        t64 = MaskedGINDeepSigns(hidden=16, phi_out=4, num_layers=2, k=k,
                                 use_bn=True)
        load_flax_variables(t64, var)
        t64 = t64.double()
        gb64 = tgb.cast_floats(torch.float64)
        (t64(gb64, gb64.eigvecs) * torch.from_numpy(c).double()).sum(
        ).backward()
    finally:
        _backend("xla")
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja),
                               rtol=1e-4, atol=1e-5)
    grads = _flat(gp)
    top = max(np.abs(g).max() for g in grads.values())
    floor = max(1e-6 * top, 1e-6)
    params = dict(tl.named_parameters())
    exact = dict(t64.named_parameters())
    assert len(params) == len(grads)
    for path, g in grads.items():
        name = torch_name(path)
        want = _port_view(path, g)
        ref = exact[name].grad.numpy()
        np.testing.assert_allclose(ref, want, rtol=1e-4, atol=1e-3 * top,
                                   err_msg=name)
        bar = 1e-4 * np.abs(want) + np.maximum(floor,
                                               2 * np.abs(want - ref))
        err = np.abs(params[name].grad.numpy() - want)
        assert (err <= bar).all(), (name, float((err - bar).max()))
    buffers = dict(tl.named_buffers())
    for path, s in _flat(upd["batch_stats"]).items():
        np.testing.assert_allclose(buffers[torch_name(path)].numpy(), s,
                                   rtol=1e-4, atol=1e-5)


def test_masked_signnet_ignores_the_slots_past_each_graphs_size():
    """With fixed BN statistics (eval), a value written into slot i >= n_g
    of a graph's rows reaches only that graph's masked slots: no output
    row moves.  Written into slot i < n_g it moves that graph's rows."""
    gs = small_graphs(5, seed=4)
    add_full_evd(gs)
    k = max(len(g["node_feat"]) for g in gs)
    arrays = packed(gs, k, extra_nodes=32)
    tl = MaskedGINDeepSigns(hidden=8, phi_out=4, num_layers=2, k=k,
                            use_bn=True).eval()
    init_parameters(tl, torch.Generator().manual_seed(0))
    _randomize_buffers(tl)
    gb = from_arrays(arrays)
    npg = gb.nodes_per_graph()
    assert bool((gb.eigvecs[torch.arange(k)[None, :]
                            >= npg[:, None]] == 0).all())
    with torch.no_grad():
        base = tl(gb, gb.eigvecs)
        g = int(np.argmin(arrays["n_node"][:-1]))
        rows = gb.graph_id == g
        n_g = int(arrays["n_node"][g])
        assert n_g < k
        for slot, moves in ((k - 1, False), (n_g - 1, True)):
            ev = gb.eigvecs.clone()
            ev[rows, slot] = 3.0
            out = tl(gb, ev)
            assert torch.equal(out[~rows], base[~rows])
            assert bool((out[rows] != base[rows]).any()) == moves, slot


# ------------------------------------------------------------ step parity

def _randomize_buffers(tm, seed=1):
    r = np.random.default_rng(seed)
    with torch.no_grad():
        for name, b in tm.named_buffers():
            b.copy_(torch.from_numpy(
                (r.random(b.shape) + (0.5 if "var" in name else -0.5))
                .astype(np.float32)))


def step_parity(model_name, net, arrays, lap_method, *, lapeig=None,
                monkeypatch=None, steps=3, backend=None, modules=None,
                exact_grads=False):
    """The port's train and eval steps against the JAX ones from bridged
    init weights: 1 and 3 Adam steps (losses, step-1 gradients, parameters,
    BN statistics) and one eval step with random BN running statistics
    (loss and MAE sums).  `lapeig` = (alpha, lambda, k) selects the LSPE
    loss (then the nets return p).  Under sign_flip the port's draw is
    monkeypatched to return the JAX draws of the same steps.  With
    `modules` = (the flax module, a function making a fresh port module)
    the nets are those, called on the batch alone (`make_module_predict`)
    instead of the ZINC net `model_name` with its PE.  With `exact_grads`
    the step-1 gradients are held to 1e-4 relative plus the larger of
    1e-6 of the largest gradient (at least 1e-6) and twice JAX's own
    distance, element by element, from the port's f64 step-1 gradient
    (which must match JAX's within 1e-4 relative plus 1e-3 of the
    largest), for nets with biases straight before a BatchNorm, whose
    exact gradient is 0; the parameters whose f64 gradient is below that
    floor then count as noise too (held to 2 * lr a step).  Returns the
    two eval results."""
    jgb, tgb = jfrom_arrays(arrays), from_arrays(arrays)
    jm = JM.gnn_model(model_name, **net) if modules is None else modules[0]
    tx = jadam()
    state = create_state(jm, jgb, tx, model_kwargs=None if modules else
                         {"pos_enc": jgb.eigvecs})
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    return_p = lapeig is not None
    jkw = {"loss_fn": jlapeig(*lapeig)} if return_p else {}
    tkw = {"loss_fn": make_lapeig_loss_fn(*lapeig)} if return_p else {}
    jtrain, jeval = jbuild_steps(
        jpredict(jm, lap_method=lap_method, return_p=return_p)
        if modules is None else jmodule_predict(jm), tx,
        donate=False, **jkw)
    keys = [jax.random.PRNGKey(100 + i) for i in range(steps)]
    ekey = jax.random.PRNGKey(7)
    flip = lap_method == "sign_flip"
    if flip:
        ones = jnp.ones((1, arrays["eigvecs"].shape[1]))
        draws = [np.asarray(jpe.sign_flip(ekey, ones))[0]] + [
            np.asarray(jpe.sign_flip(jax.random.fold_in(k, 1), ones))[0]
            for k in keys]
        assert all((d < 0).any() for d in draws)

        def jax_draws(pos_enc, rng):
            rng.draws += 1
            return pos_enc * torch.tensor(draws.pop(0),
                                          dtype=pos_enc.dtype)[None]

        monkeypatch.setattr(tpe, "sign_flip", jax_draws)

    def port_model():
        tm = (TM.gnn_model(model_name, **net) if modules is None
              else modules[1]())
        load_flax_variables(tm, variables)
        return tm

    def port_predict(tm):
        if modules is not None:
            return make_module_predict(tm)
        return make_zinc_predict(tm, lap_method, return_p=return_p)

    ctx = (pltpu.force_tpu_interpret_mode() if backend == "pallas_tile"
           else jax.default_device(jax.devices("cpu")[0]))
    if backend:
        _backend(backend)
    try:
        with ctx:
            # eval, from random BN running statistics on both sides
            te = port_model()
            _randomize_buffers(te)
            bs = _nest({path: jnp.asarray(dict(te.named_buffers())[
                torch_name(path)].numpy())
                for path in _flat(variables["batch_stats"])})
            jres = jax.tree.map(float, jeval(state.replace(batch_stats=bs),
                                             jgb, *([ekey] if flip else [])))
            _, teval = build_steps(te, port_predict(te),
                                   adam(te.parameters()), **tkw)
            tres = {k: float(v) for k, v in teval(
                tgb, te.eval_flip_rng if flip else None).items()}
            if flip:
                assert te.eval_flip_rng.draws == 1
            # train
            st, jstates, jlosses = state, [], []
            for key in keys:
                st, m = jtrain(st, jgb, jnp.float32(LR), key)
                jstates.append(st)
                jlosses.append(float(m["loss"]))
            tm = port_model()
            tstep, _ = build_steps(tm, port_predict(tm),
                                   adam(tm.parameters()), **tkw)
            tlosses, tstates = [], []
            for i in range(steps):
                tlosses.append(float(tstep(tgb, LR)["loss"]))
                if i == 0:
                    tgrads = {n: (torch.zeros_like(p) if p.grad is None
                                  else p.grad.clone())
                              for n, p in tm.named_parameters()}
                tstates.append({n: t.detach().clone() for n, t in
                                list(tm.named_parameters())
                                + list(tm.named_buffers())})
            if exact_grads:
                t64 = port_model().double()
                build_steps(t64, port_predict(t64), adam(t64.parameters()),
                            **tkw)[0](tgb.cast_floats(torch.float64), LR)
                exact = {n: (np.zeros(p.shape) if p.grad is None
                             else p.grad.numpy())
                         for n, p in t64.named_parameters()}
    finally:
        if backend:
            _backend("xla")
    if flip:
        assert not draws and tm.flip_rng.draws == steps
    for k in ("loss_sum", "mae_sum", "n"):
        np.testing.assert_allclose(tres[k], jres[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    # step-1 gradients: JAX's first Adam moment is 0.1 g
    jgrads = {p: m / 0.1 for p, m in
              _flat(jstates[0].opt_state[0].mu).items()}
    assert len(jgrads) == len(tgrads)
    top = max(np.abs(g).max() for g in jgrads.values())
    for path, g in jgrads.items():
        name = torch_name(path)
        want = _port_view(path, g)
        if not exact_grads:
            np.testing.assert_allclose(tgrads[name].numpy(), want,
                                       err_msg=name, **GTOL)
            continue
        ref = exact[name]
        np.testing.assert_allclose(ref, want, rtol=1e-4, atol=1e-3 * top,
                                   err_msg=name)
        bar = GTOL["rtol"] * np.abs(want) + np.maximum(
            max(1e-6 * top, 1e-6), 2 * np.abs(want - ref))
        err = np.abs(tgrads[name].numpy() - want)
        assert (err <= bar).all(), (name, float((err - bar).max()))
    for step in sorted({1, steps}):
        jst, tst = jstates[step - 1], tstates[step - 1]
        for path, a in _flat(jst.params).items():
            name = torch_name(path)
            a = _port_view(path, a)
            d = np.abs(tst[name].numpy() - a)
            noise = np.abs(_port_view(path, jgrads[path])) < 1e-6
            if exact_grads:     # or an exact gradient below the floor
                noise |= np.abs(exact[name]) < max(1e-6 * top, 1e-6)
            assert d[~noise].max(initial=0) <= 2e-5, (name, step)
            assert d[noise].max(initial=0) <= 2 * LR * step * 1.01, (name,
                                                                     step)
        for path, a in _flat(jst.batch_stats).items():
            name = torch_name(path)
            np.testing.assert_allclose(tst[name].numpy(), a,
                                       atol=1e-5 if step == 1 else 1e-3,
                                       rtol=0, err_msg=f"{name} step {step}")
    return jres, tres


@pytest.mark.parametrize("lap_method", ["abs_val", "canonical", "sign_flip"])
def test_gatedgcn_lappe_steps_match_jax(lap_method, monkeypatch):
    """configs/gatedgcn_zinc_lappe{_abs,_canonical,}.json's net, cut to
    width 16 and 2 layers, on the flat gate (the shipped configs set no
    tile).  Under sign_flip every train step and the eval step draw their
    own flips."""
    gs = small_graphs(13, seed=0)
    add_lap_pe(gs, LAPPE_NET["pos_enc_dim"])
    arrays = packed(gs, LAPPE_NET["pos_enc_dim"])
    net = dict(LAPPE_NET, lap_method=lap_method)
    jres, tres = step_parity("GatedGCN", net, arrays, lap_method,
                             monkeypatch=monkeypatch)
    assert jres["loss_sum"] == pytest.approx(jres["mae_sum"])


@pytest.mark.parametrize("model_name", ["GatedGCN", "GIN", "Transformer"])
def test_bridge_sets_every_lappe_net_tensor(model_name):
    """The LapPE nets (no SignNet): embedding_p beside the atom embedding,
    merged by addition or by embedding_hp; every flax leaf lands and every
    port tensor is set (load_flax_variables raises otherwise).  Under
    sign_flip the net owns its two flip generators."""
    net = dict(LAPPE_NET, lap_method="sign_flip",
               pe_aggregate="concat" if model_name == "Transformer"
               else "add")
    if model_name == "Transformer":
        net["num_heads"] = 4
    gs = small_graphs(5, seed=1)
    add_lap_pe(gs, net["pos_enc_dim"])
    jgb = jfrom_arrays(packed(gs, net["pos_enc_dim"]))
    v = JM.gnn_model(model_name, **net).init(
        {"params": jax.random.PRNGKey(0)}, jgb, jgb.eigvecs, training=False)
    tm = TM.gnn_model(model_name, seed=3, **net)
    load_flax_variables(tm, jax.tree.map(np.asarray, v))
    names = set(dict(tm.named_parameters()))
    assert {"embedding_p.weight", "embedding_p.bias"} <= names
    assert ("embedding_hp.weight" in names) == (model_name == "Transformer")
    assert not any(n.startswith("sign_inv_net") for n in names)
    assert tm.flip_rng.seed == 3 and tm.eval_flip_rng.seed == 3 + 10007


def test_resume_of_a_sign_flip_run_equals_an_uninterrupted_one(tmp_path):
    """configs/gatedgcn_zinc_lappe.json (sign_flip, flips at eval too) at
    width 8: 1 epoch, then resumed to 2, against 2 epochs in one run,
    within 1e-6.  The checkpoint carries both flip generators, so the
    resumed run draws the flips the uninterrupted one draws."""
    def cfg(epochs, name, *extra):
        return load_config("configs/gatedgcn_zinc_lappe.json", [
            "train.epochs", str(epochs), "train.batch_size", "8",
            "data.synth_train", "24", "data.synth_eval", "8",
            "model.n_layers", "2", "model.hidden_dim", "8",
            "model.out_dim", "8", "out_dir", str(tmp_path), "name", name,
            "train.checkpoint_dir", str(tmp_path / name), *extra])

    quiet = lambda m: None
    whole = train_zinc.run(cfg(2, "a"), device="cpu", log=quiet)
    first = train_zinc.run(cfg(1, "b"), device="cpu", log=quiet)
    saved = Checkpointer(str(tmp_path / "b")).restore()
    assert {"flip_rng", "eval_flip_rng"} <= set(saved)
    resumed = train_zinc.run(cfg(2, "b", "train.resume", "true"),
                             device="cpu", log=quiet)
    assert whole.eval_flip_draws == whole.eval_steps > 0
    assert [h["epoch"] for h in resumed.history] == [1]
    for got, want in zip(first.history + resumed.history, whole.history):
        for k in ("lr", "train_loss", "train_mae", "val_loss", "val_mae"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    np.testing.assert_allclose(resumed.test_mae, whole.test_mae, rtol=1e-6)
    # without the saved generators the resumed run would flip otherwise
    del saved["flip_rng"], saved["eval_flip_rng"]
    ck = Checkpointer(str(tmp_path / "b"))
    os.remove(ck.path(1))
    ck.save(0, saved)
    other = train_zinc.run(cfg(2, "b", "train.resume", "true"),
                           device="cpu", log=quiet)
    assert other.history[0]["train_loss"] != whole.history[1]["train_loss"]
