"""The port's model-parallel halo execution (parallel/mp_halo.py) against
the JAX package's, at the sizes of tests/test_mp_halo.py (12 graphs, 96
nodes, width 12, 3 layers): the host partitioner bit for bit, the
exchange, boundary-only traffic, `mp_neighbor_sum` and `mp_pool_nodes`
against plain sums, and one mp train step of whole nets against JAX
`build_mp_steps` and against the port's single-device step under bridged
weights.

The port's ranks are processes on the CPU over gloo, started by
`parallel.mesh.spawn_ranks` (spawn, a file store) from tests/torch_ranks.py,
which imports no JAX.  Each world size starts once per module (the
module-scoped fixtures run every case and keep the results); each case is
its own test.  JAX runs its steps on conftest's virtual 8-device mesh.

Bars (JAX's own, tests/test_mp_halo.py): loss and MAE 1e-5 relative; BN
statistics 1e-4 relative + 1e-5 (the mp step's uncentred variance differs
from the single-device formula in the last bits); gradients 5e-3 relative
+ 1e-5 in f32 (JAX's step-1 gradients read from its first Adam moment, 0.1
g).  In f64 the port's mp step holds its single-device step within 1e-9
relative + 1e-12 (loss, gradients, BN statistics).  Every rank ends the
step with the same loss, gradients, BN statistics and parameters, bit for
bit.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from signnet_basisnet_tpu import spectral
from signnet_basisnet_tpu.data.transforms import make_full_graph
from signnet_basisnet_tpu.graph import batch_np
from signnet_basisnet_tpu.graph import from_arrays as jfrom_arrays
from signnet_basisnet_tpu.graph.batch import GraphBatch as JGraphBatch
from signnet_basisnet_tpu.models import gnn_model as jgnn_model
from signnet_basisnet_tpu.parallel import build_mp_steps as jbuild_mp_steps
from signnet_basisnet_tpu.parallel import device_arrays_mp as jdevice_arrays
from signnet_basisnet_tpu.parallel import make_mesh as jmake_mesh
from signnet_basisnet_tpu.parallel import mp_budgets as jmp_budgets
from signnet_basisnet_tpu.parallel import partition_batch_mp as jpartition
from signnet_basisnet_tpu.parallel.mp_halo import mp_axis_ctx as jmp_ctx
from signnet_basisnet_tpu.parallel.mp_halo import mp_pool_nodes as jmp_pool
from signnet_basisnet_tpu.training import adam as jadam
from signnet_basisnet_tpu.training import create_state
from signnet_basisnet_tpu.training import make_zinc_predict as jpredict

from signnet_basisnet_tpu_torch.bridge import torch_name
from signnet_basisnet_tpu_torch.parallel import (device_arrays_mp,
                                                 mp_budgets,
                                                 partition_batch_mp)
from signnet_basisnet_tpu_torch.parallel.mesh import spawn_ranks

import torch_ranks
from test_torch_pe import _flat, _port_view

LR = torch_ranks.LR
LOSS_RTOL = 1e-5
BS_TOL = dict(rtol=1e-4, atol=1e-5)
G_TOL = dict(rtol=5e-3, atol=1e-5)
F64_TOL = dict(rtol=1e-9, atol=1e-12)
WORLD_TIMEOUT = 600

NET = dict(hidden_dim=12, out_dim=12, n_layers=3, pos_enc_dim=4,
           lap_method="sign_inv", sign_inv_layers=2, phi_out_dim=2,
           batch_norm=True, dropout=0.0, readout="mean")
_NET_CASES = {
    "GatedGCN": dict(),
    "GIN": dict(),
    "GAT": dict(num_heads=2),
    "PNA": dict(towers=2, avg_d_log=1.1),
    "Transformer": dict(num_heads=2, edge_feat=True),
}
STEP_CASES = [(2, "GatedGCN"), (4, "GatedGCN"), (2, "GIN"), (2, "GAT"),
              (2, "PNA"), (2, "Transformer")]
F64_CASES = ["GatedGCN", "GIN"]


def _graph(rng, full=False):
    n = int(rng.integers(5, 9))
    A = np.triu((rng.random((n, n)) < 0.6).astype(int), 1)
    A = A + A.T
    if A.sum() == 0:
        A[0, 1] = A[1, 0] = 1
    s, r = np.nonzero(A)
    vals, vecs = spectral.full_evd_np(s, r, n)
    g = dict(senders=s, receivers=r, node_feat=rng.integers(0, 28, n),
             edge_feat=rng.integers(0, 4, len(s)),
             y=np.array([float(rng.normal())], np.float32),
             eigvals=vals, eigvecs=vecs)
    return make_full_graph(g) if full else g


def _batch(num_graphs=12, num_nodes=96, num_edges=512, k=4, seed=0):
    """tests/test_mp_halo.py's batch."""
    rng = np.random.default_rng(seed)
    graphs = [_graph(rng) for _ in range(num_graphs)]
    return batch_np(graphs, num_nodes=num_nodes, num_edges=num_edges,
                    num_graphs=num_graphs + 1, k=k)


def _full_graph_batch():
    rng = np.random.default_rng(11)
    graphs = [_graph(rng, full=True) for _ in range(8)]
    return batch_np(graphs, num_nodes=64, num_edges=1024, num_graphs=9, k=4)


def _jax_init(name, net, arrays, lap_method):
    """The JAX net's init state, and the case the ranks run from it."""
    jm = jgnn_model(name, **net)
    gb = jfrom_arrays(arrays)
    state = create_state(jm, gb, jadam(),
                         model_kwargs={"pos_enc": gb.eigvecs})
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    case = dict(kind="mp_step", name=name, net=net, variables=variables,
                arrays=arrays, lap_method=lap_method)
    return (jm, state), case


def _jax_mp_step(init, case, mp):
    """JAX build_mp_steps' train step from that init: loss, MAE, BN
    statistics and step-1 gradients in the port's names and layout."""
    jm, state = init
    mesh = jmake_mesh(dp=1, mp=mp, devices=jax.devices()[:mp])
    arrs = jax.tree.map(jnp.asarray,
                        jdevice_arrays(jpartition(case["arrays"], mp)))
    train, _ = jbuild_mp_steps(jpredict(jm, lap_method=case["lap_method"]),
                               jadam(), mesh)
    st, m = train(state, arrs, jnp.float32(LR), jax.random.PRNGKey(0))
    return {"loss": float(m["loss"]), "mae": float(m["mae"]),
            "grads": {torch_name(p): _port_view(p, mu / 0.1) for p, mu in
                      _flat(st.opt_state[0].mu).items()},
            "buffers": {torch_name(p): v
                        for p, v in _flat(st.batch_stats).items()}}


def _ranks_agree(results):
    """Every rank ends the step with rank 0's numbers, bit for bit."""
    for r in results[1:]:
        assert (r["loss"], r["mae"]) == (results[0]["loss"],
                                         results[0]["mae"])
        for key in ("grads", "buffers", "params"):
            for n, v in results[0][key].items():
                np.testing.assert_array_equal(r[key][n], v, err_msg=n)


def _hold(got, want, g_tol=G_TOL, bs_tol=BS_TOL, loss_rtol=LOSS_RTOL):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
    np.testing.assert_allclose(got["mae"], want["mae"], rtol=loss_rtol)
    assert got["grads"].keys() == want["grads"].keys()
    for n, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][n], g, err_msg=n, **g_tol)
    for n, b in want["buffers"].items():
        np.testing.assert_allclose(got["buffers"][n], b, err_msg=n,
                                   **bs_tol)


def _world(mp, cases):
    return spawn_ranks(torch_ranks.run_cases, mp, (cases,), device="cpu",
                       timeout=WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def runs():
    """Every case's ranks and references.  The two worlds (2 and 4 gloo
    ranks, one start each) run in threads of this process while JAX
    compiles its mp steps here; the port's single-device steps follow."""
    inits, cases = {}, {}
    for mp, name in STEP_CASES:
        inits[(mp, name)], cases[(mp, name)] = _jax_init(
            name, dict(NET, **_NET_CASES[name]), _batch(seed=4), "sign_inv")
    inits["full_graph"], cases["full_graph"] = _jax_init(
        "Transformer", dict(NET, n_layers=2, num_heads=2, full_graph=True,
                            edge_feat=True), _full_graph_batch(), "sign_inv")
    canon = {k: v for k, v in NET.items()
             if k not in ("sign_inv_layers", "phi_out_dim")}
    inits["canonical"], cases["canonical"] = _jax_init(
        "GatedGCN", dict(canon, n_layers=2, lap_method="canonical"),
        _batch(seed=6), "canonical")
    for name in F64_CASES:
        cases[("f64", name)] = dict(cases[(2, name)], dtype=torch.float64)

    rng = np.random.default_rng(7)
    cases["pool"] = dict(kind="pool", arrays=_batch(seed=1),
                         x=rng.normal(size=(96, 3)).astype(np.float32))
    rng = np.random.default_rng(5)
    cases["exchange"] = dict(
        kind="exchange", x=rng.normal(size=(32, 3)).astype(np.float32),
        send_idx=rng.integers(0, 8, size=(4, 4, 8)).astype(np.int32))
    arrays = _batch(seed=1)
    rng = np.random.default_rng(2)
    cases["neighbor_sum"] = dict(
        kind="neighbor_sum", arrays=arrays,
        x=(rng.normal(size=(96, 8)).astype(np.float32)
           * arrays["node_mask"][:, None]),
        ct=rng.normal(size=(96, 8)).astype(np.float32))
    keys = {2: [k for k in cases if k[0] != 4
                and k not in ("exchange", "neighbor_sum")],
            4: [(4, "GatedGCN"), "exchange", "neighbor_sum"]}
    with ThreadPoolExecutor(2) as pool:
        worlds = {mp: pool.submit(_world, mp, [cases[k] for k in ks])
                  for mp, ks in keys.items()}
        want = {k: _jax_mp_step(inits[k], cases[k],
                                2 if k[0] != 4 else 4) for k in inits}
        for name in F64_CASES:
            want[("f64", name)] = torch_ranks.single_step(
                cases[("f64", name)])
        got = {}
        for mp, ks in keys.items():
            res = worlds[mp].result()
            got.update({k: [r[i] for r in res] for i, k in enumerate(ks)})
    return cases, want, got


# ---------------------------------------------------------------- host side

@pytest.mark.parametrize("seed,mp,budgets", [
    (1, 4, False), (3, 4, False), (4, 2, False), (4, 2, True),
    (6, 8, False)])
def test_partition_matches_jax_bit_for_bit(seed, mp, budgets):
    """partition_batch_mp, device_arrays_mp and mp_budgets against JAX's,
    every array and layout int equal and of the same dtype (also with
    forced budgets, as train_zinc passes them)."""
    arrays = _batch(seed=seed)
    kw = {}
    if budgets:
        e_sh, H = mp_budgets([arrays, _batch(seed=seed + 1)], mp)
        assert (e_sh, H) == jmp_budgets([arrays, _batch(seed=seed + 1)], mp)
        kw = dict(e_shard=e_sh + 8, halo=2 * H)
    got, want = partition_batch_mp(arrays, mp, **kw), jpartition(arrays, mp,
                                                                  **kw)
    for key in ("shard_n", "halo", "mp"):
        assert got[key] == want[key]
    g, w = _flat(device_arrays_mp(got)), _flat(jdevice_arrays(want))
    assert g.keys() == w.keys()
    for path, a in w.items():
        assert g[path].dtype == a.dtype, path
        np.testing.assert_array_equal(g[path], a, err_msg=str(path))


def test_halo_traffic_is_boundary_only():
    """The exchange buffer is sized by the true boundary, far below N, and
    every remapped remote index decodes to the node the edge names."""
    arrays = _batch(seed=3)
    parts = partition_batch_mp(arrays, 4)
    N = arrays["node_mask"].shape[0]
    assert parts["halo"] * 4 < N
    e, send_idx = parts["edges"], parts["send_idx"]
    shard_n, H = parts["shard_n"], parts["halo"]
    order = np.argsort(arrays["receivers"], kind="stable")
    bounds = np.searchsorted(arrays["receivers"], np.arange(5) * shard_n)
    for d in range(4):
        src = arrays["senders"][order][bounds[d]:bounds[d + 1]]
        for j in range(len(src)):
            if e["edge_mask"][d, j] == 0:
                continue
            aug = int(e["senders"][d, j])
            if aug < shard_n:
                assert aug + d * shard_n == src[j]
                continue
            o, slot = divmod(aug - shard_n, H)
            assert o != d and int(send_idx[o, d, slot]) + o * shard_n == src[j]


# ---------------------------------------------------------------- on ranks

def test_mp_exchange_identity(runs):
    """mp_exchange delivers exactly the owner rows the table names."""
    cases, _, got = runs
    res, case = got["exchange"], cases["exchange"]
    mp, H, d = 4, 8, 3
    x = case["x"].reshape(mp, -1, d)
    for dd in range(mp):
        got = res[dd].reshape(mp, H, d)
        for o in range(mp):
            np.testing.assert_array_equal(got[o], x[o][case["send_idx"][o, dd]])


def test_partition_roundtrip_neighbor_sum(runs):
    """mp_neighbor_sum over the partition == the plain segment sum over
    the whole batch, and its gradient (through the exchange's reverse) ==
    the plain sum's transpose applied to the cotangent."""
    cases, _, got = runs
    res, case = got["neighbor_sum"], cases["neighbor_sum"]
    arrays, x, ct = case["arrays"], case["x"], case["ct"]
    s, r, m = arrays["senders"], arrays["receivers"], arrays["edge_mask"]
    ref = np.zeros_like(x)
    np.add.at(ref, r, x[s] * m[:, None])
    ref_grad = np.zeros_like(x)
    np.add.at(ref_grad, s, ct[r] * m[:, None])
    np.testing.assert_allclose(np.concatenate([q["out"] for q in res]), ref,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([q["grad"] for q in res]),
                               ref_grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mp,name", STEP_CASES)
def test_mp_train_step_matches_single_device(mp, name, runs):
    """Full net + SignNet (GIN phi): one mp train step on the ranks holds
    JAX build_mp_steps' step and the port's single-device step: loss, MAE,
    BN statistics and parameter gradients (dropout 0); the eval step's
    sums are finite and consistent."""
    cases, want, got = runs
    case, res = cases[(mp, name)], got[(mp, name)]
    _ranks_agree(res)
    _hold(res[0], want[(mp, name)])
    _hold(res[0], torch_ranks.single_step(case))
    ev = res[0]["eval"]
    assert np.isfinite(ev["mae_sum"]) and ev["n"] == 12
    assert res[0]["halo"] == partition_batch_mp(case["arrays"], mp)["halo"]


def test_mp_full_graph_transformer_matches_single_device(runs):
    """Full-graph attention under mp: the halo is built from the actual
    edge list (fake edges included) and K_2 projects halo rows, so the
    gamma-mix TransformerNet holds JAX's mp step and the port's
    single-device step at mp = 2."""
    cases, want, got = runs
    case = cases["full_graph"]
    assert "edge_real" in partition_batch_mp(case["arrays"], 2)["edges"]
    _ranks_agree(got["full_graph"])
    _hold(got["full_graph"][0], want["full_graph"])
    _hold(got["full_graph"][0], torch_ranks.single_step(case))


def test_mp_canonical_pe_matches_single_device(runs):
    """lap_method 'canonical' computes per-graph sign statistics; under mp
    the partial counts are summed over the group (models/pe.canonical)."""
    cases, want, got = runs
    _ranks_agree(got["canonical"])
    _hold(got["canonical"][0], want["canonical"])
    _hold(got["canonical"][0], torch_ranks.single_step(cases["canonical"]))


@pytest.mark.parametrize("name", F64_CASES)
def test_mp_step_matches_single_device_in_f64(name, runs):
    """In f64 the mp step is the single-device step up to rounding: loss,
    MAE, every gradient and BN statistic within 1e-9 relative."""
    _, want, got = runs
    _ranks_agree(got[("f64", name)])
    _hold(got[("f64", name)][0], want[("f64", name)], g_tol=F64_TOL,
          bs_tol=F64_TOL, loss_rtol=F64_TOL["rtol"])


def test_mp_pool_nodes_and_the_max_gradient(runs):
    """mp_pool_nodes' sum, mean and max over the ranks' partials equal the
    plain per-graph pools of the whole batch; the max refuses a gradient,
    as JAX's `pmax` has no differentiation rule."""
    cases, _, got = runs
    res, case = got["pool"], cases["pool"]
    arrays, x = case["arrays"], case["x"]
    G = arrays["graph_mask"].shape[0]
    gid, nm = arrays["graph_id"], arrays["node_mask"]
    ssum = np.zeros((G, 3), np.float32)
    np.add.at(ssum, gid, x * nm[:, None])
    cnt = np.zeros(G, np.float32)
    np.add.at(cnt, gid, nm)
    smax = np.full((G, 3), -np.inf, np.float32)
    np.maximum.at(smax, gid[nm > 0], x[nm > 0])
    smax[~np.isfinite(smax)] = 0.0
    for r in res:
        np.testing.assert_allclose(r["sum"], ssum, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["mean"], ssum / np.maximum(cnt, 1)[:, None],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(r["max"], smax)
        assert "forward only" in r["max_grad"]

    from jax.sharding import PartitionSpec as P
    mesh = jmake_mesh(dp=1, mp=2, devices=jax.devices()[:2])
    parts = jdevice_arrays(jpartition(arrays, 2))

    def worker(xs, gid, nm):
        with jmp_ctx("mp"):
            gb = JGraphBatch(
                senders=None, receivers=None, graph_id=gid[0],
                edge_graph_id=None, n_node=None, n_edge=None,
                node_mask=nm[0], edge_mask=None,
                graph_mask=jnp.ones(G), extras={"mp_send_idx": None})
            return jmp_pool(xs[0], gb, "max").sum()[None]

    f = jax.shard_map(worker, mesh=mesh, in_specs=(P("mp"),) * 3,
                      out_specs=P("mp"), check_vma=False)
    args = (jnp.asarray(x).reshape(2, -1, 3),
            jnp.asarray(parts["nodes"]["graph_id"]),
            jnp.asarray(parts["nodes"]["node_mask"]))
    np.testing.assert_allclose(np.asarray(f(*args))[0], smax.sum(),
                               rtol=1e-6)
    with pytest.raises(NotImplementedError, match="pmax"):
        jax.grad(lambda xs: f(xs, *args[1:]).sum())(args[0])
