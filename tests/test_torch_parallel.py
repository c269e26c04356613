"""The port's parallel/ against the JAX package's, at the sizes of
tests/test_parallel.py: the ("dp", "mp") mesh, data parallelism
(`build_dp_steps` at dp 2 with 1 and 2 microbatches a rank, against JAX
`build_dp_steps` under bridged weights; and a step over every rank of a 2-D
mesh, the counterpart of JAX's multichip dry run), the edge-partitioned
aggregates, `stack_microbatches` and the host partitioners bit for bit,
and GSPMD: `graphbatch_shardings` by JAX's rule, `build_gspmd_steps` at mp
8 against JAX's on the JAX test's batch and net, against the port's
single-device step in f64 and f32 at mp 2 and 8, the registered
`index_add` and `scatter_reduce` rules, the draws under DTensor, the
all-gather through c10d, and the kernel wrappers' refusal of a DTensor.

The port's ranks are processes on the CPU over gloo, started by
`parallel.mesh.spawn_ranks` (spawn, a file store) from tests/torch_ranks.py,
which imports no JAX; each world size (2 and 8) starts once per module,
in threads of this process while JAX compiles its steps.

Bars: the DP step against JAX's: losses and MAE 1e-5 relative, BN
statistics 1e-5, step-1 gradients 1e-4 relative + 1e-6 (JAX's read from
its first Adam moment), the eval sums 1e-5 relative: each rank's forward is
the single-device one, so tests/test_torch_pe.py's bars hold.  The
aggregates: 1e-5.  Every rank ends a DP step with the same numbers, bit
for bit.  The GSPMD step against JAX's GSPMD step (attention dropout off
in both): loss, MAE and eval sums 1e-5 relative (JAX's own test holds its
GSPMD step to its single-device one at 1e-4).  Against the port's
single-device step, with the rho's attention dropout on (both steps draw
the same mask): in f64 the loss and eval sums 1e-12 relative, and every
gradient, BN statistic and Adam moment within 1e-10 of its tensor's
largest, or of 1e-4 of the largest of its kind in the model if that is
more (a tensor that is 0 in exact arithmetic, as the phi's lin_1.bias
whose gradient a BatchNorm zeroes, keeps only f64 rounding; phase 16b of
chip_smoke.py takes the same bar);
in f32 the loss, MAE and eval sums 1e-5 relative, and the gradients'
distance from the f64 step, each over its tensor's largest, within twice
the single-device f32 step's, for the median over tensors and the worst
tensor (phase 16b's form: one tensor's own f32 error can be small by
chance, and a few of the phi's are ill conditioned in f32, as its first
BatchNorm's bias, whose single-device f32 gradient is tens of percent
from the f64 one).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import flax
import jax.numpy as jnp
import pytest

from signnet_basisnet_tpu import spectral
from signnet_basisnet_tpu.data.batcher import \
    stack_microbatches as jstack_microbatches
from signnet_basisnet_tpu.graph import batch_np
from signnet_basisnet_tpu.graph import from_arrays as jfrom_arrays
from signnet_basisnet_tpu.models import SignNetGNN as JSignNetGNN
from signnet_basisnet_tpu.models import gnn_model as jgnn_model
from signnet_basisnet_tpu.parallel import build_dp_steps as jbuild_dp_steps
from signnet_basisnet_tpu.parallel import \
    build_gspmd_steps as jbuild_gspmd_steps
from signnet_basisnet_tpu.parallel import graphbatch_shardings as jshardings
from signnet_basisnet_tpu.parallel import make_mesh as jmake_mesh
from signnet_basisnet_tpu.parallel import pad_edges_for as jpad_edges_for
from signnet_basisnet_tpu.parallel import \
    partition_edges_by_dst as jpartition_edges
from signnet_basisnet_tpu.training import adam as jadam
from signnet_basisnet_tpu.training import create_state
from signnet_basisnet_tpu.training import make_zinc_predict as jpredict
from signnet_basisnet_tpu.training import \
    make_module_predict as jmodule_predict
from jax.sharding import PartitionSpec as P

from signnet_basisnet_tpu_torch.bridge import torch_name
from signnet_basisnet_tpu_torch.data import stack_microbatches
from signnet_basisnet_tpu_torch.parallel import (pad_edges_for,
                                                 partition_edges_by_dst)
from signnet_basisnet_tpu_torch.parallel.mesh import spawn_ranks

import torch_ranks
from test_torch_alchemy import _NoDropout
from test_torch_pe import _flat, _port_view

LR = torch_ranks.LR
WORLD_TIMEOUT = 600
NET = dict(hidden_dim=12, out_dim=12, n_layers=3, pos_enc_dim=4,
           lap_method="sign_inv", sign_inv_layers=2, phi_out_dim=2,
           batch_norm=True, dropout=0.0, readout="mean")
GB_FIELDS = ("senders", "receivers", "graph_id", "edge_graph_id", "n_node",
             "n_edge", "node_mask", "edge_mask", "graph_mask", "node_feat",
             "edge_feat", "y", "eigvecs", "eigvals", "eig_mask")


def _micro(seed, num_graphs=12):
    """tests/test_mp_halo.py's batch: 12 graphs in 96 node slots."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(num_graphs):
        n = int(rng.integers(5, 9))
        A = np.triu((rng.random((n, n)) < 0.6).astype(int), 1)
        A = A + A.T
        if A.sum() == 0:
            A[0, 1] = A[1, 0] = 1
        s, r = np.nonzero(A)
        vals, vecs = spectral.full_evd_np(s, r, n)
        graphs.append(dict(senders=s, receivers=r,
                           node_feat=rng.integers(0, 28, n),
                           edge_feat=rng.integers(0, 4, len(s)),
                           y=np.array([float(rng.normal())], np.float32),
                           eigvals=vals, eigvecs=vecs))
    return batch_np(graphs, num_nodes=96, num_edges=512,
                    num_graphs=num_graphs + 1, k=4)


def _gspmd_batch():
    """tests/test_parallel.py's GSPMD batch: 3 graphs, 40 nodes, 160
    edges."""
    rng = np.random.default_rng(3)
    graphs = []
    for _ in range(3):
        n = int(rng.integers(6, 11))
        A = np.triu((rng.random((n, n)) < 0.5).astype(int), 1)
        A = A + A.T
        s, r = np.nonzero(A)
        vals, vecs = spectral.full_evd_np(s, r, n)
        graphs.append(dict(senders=s, receivers=r,
                           node_feat=rng.integers(0, 6, n),
                           edge_feat=rng.integers(0, 4, len(s)),
                           y=np.array([0.5], np.float32),
                           eigvals=vals, eigvecs=vecs))
    return batch_np(graphs, 40, 160, 4, k=6)


def _tiled_batch():
    """The GSPMD batch's graphs packed in 4 tiles of 16 nodes."""
    rng = np.random.default_rng(4)
    graphs = []
    for _ in range(4):
        n = int(rng.integers(6, 11))
        A = np.triu((rng.random((n, n)) < 0.5).astype(int), 1)
        A = A + A.T
        s, r = np.nonzero(A)
        graphs.append(dict(senders=s, receivers=r,
                           node_feat=rng.integers(0, 6, n)))
    return batch_np(graphs, 64, 160, 5, tile=16)


def _rules_case():
    """Inputs of the rank-side checks of the GSPMD pieces."""
    rng = np.random.default_rng(6)
    return dict(kind="gspmd_rules", x=rng.normal(size=(40, 12)).astype(
        np.float32), ids=rng.integers(0, 10, 40), segments=10,
        ct=rng.normal(size=(10, 12)), pe=rng.normal(size=(40, 6)).astype(
            np.float32), arrays=_gspmd_batch(), tiled=_tiled_batch())


def _dst_case(rng, tile_local):
    """tests/test_parallel.py's destination-partitioned problems: 64
    nodes in 8 shards, tile-local edges or arbitrary sources."""
    n, d, shard_n = 64, 8 if tile_local else 4, 8
    if tile_local:
        e = 96
        t = rng.integers(0, 8, size=e)
        src = (t * shard_n + rng.integers(0, shard_n, e)).astype(np.int32)
        dst = (t * shard_n + rng.integers(0, shard_n, e)).astype(np.int32)
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        emask = (rng.random(e) < 0.8).astype(np.float32)
    else:
        e = 128
        src = rng.integers(0, n, e).astype(np.int32)
        dst = np.sort(rng.integers(0, n, e).astype(np.int32))
        emask = np.ones(e, np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    arrays = {"senders": src, "receivers": dst, "edge_mask": emask,
              "node_mask": np.ones(n, np.float32)}
    return dict(kind="dst_partitioned", x=x, arrays=arrays,
                shards=partition_edges_by_dst(arrays, 8),
                ct=rng.normal(size=(n, d)).astype(np.float32),
                tile_local=tile_local)


def _jax_dp(init, micro, dp):
    """JAX build_dp_steps at dp ranks on the stacked microbatches: an eval
    step, then a train step, from the init state."""
    jm, state = init
    state = jax.tree.map(jnp.copy, state)     # the train step donates it
    mesh = jmake_mesh(dp=dp, mp=1, devices=jax.devices()[:dp])
    gbs = jax.tree.map(jnp.asarray, jfrom_arrays(jstack_microbatches(micro)))
    train, ev = jbuild_dp_steps(jpredict(jm, lap_method="sign_inv"),
                                jadam(), mesh)
    sums = {k: float(v) for k, v in ev(state, gbs).items()}
    st, m = train(state, gbs, jnp.float32(LR), jax.random.PRNGKey(0))
    return {"loss": float(m["loss"]), "mae": float(m["mae"]), "eval": sums,
            "grads": {torch_name(p): _port_view(p, mu / 0.1) for p, mu in
                      _flat(st.opt_state[0].mu).items()},
            "buffers": {torch_name(p): v
                        for p, v in _flat(st.batch_stats).items()}}


def _jax_gspmd_init():
    """JAX's GSPMD test net, SignNetGNN(12, 1, 2, 2, 1), and its init
    state on the GSPMD batch."""
    jm = JSignNetGNN(n_hid=12, n_out=1, nl_signnet=2, nl_gnn=2, nl_rho=1)
    return jm, create_state(jm, jfrom_arrays(_gspmd_batch()), jadam())


def _jax_gspmd(jm, state):
    """JAX build_gspmd_steps at mp 8, as tests/test_parallel.py runs it:
    an eval step, then a train step, from the init state."""
    gb = jfrom_arrays(_gspmd_batch())
    mesh = jmake_mesh(dp=1, mp=8)
    train, ev = jbuild_gspmd_steps(jmodule_predict(jm), jadam(), mesh, gb,
                                   axis="mp")
    sums = {k: float(v) for k, v in ev(state, gb).items()}
    _, m = train(state, gb, jnp.float32(LR), jax.random.PRNGKey(0))
    return {"loss": float(m["loss"]), "mae": float(m["mae"]), "eval": sums}


def _world(n, cases):
    return spawn_ranks(torch_ranks.run_cases, n, (cases,), device="cpu",
                       timeout=WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def runs():
    """Every case's inputs, the JAX references and the ranks' results
    (worlds of 2 and 8 gloo ranks, one start each)."""
    jm = jgnn_model("GIN", **NET)
    gb0 = jfrom_arrays(_micro(0))
    state = create_state(jm, gb0, jadam(),
                         model_kwargs={"pos_enc": gb0.eigvecs})
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    micro = [_micro(10 + i) for i in range(4)]
    base = dict(kind="dp_step", name="GIN", net=NET, variables=variables,
                lap_method="sign_inv")
    cases = {"dp1": dict(base, micro=[[micro[0]], [micro[1]]]),
             "dp2": dict(base, micro=[micro[0:2], micro[2:4]]),
             "gspmd": dict(kind="gspmd", arrays=_gspmd_batch()),
             "dp8": dict(base, micro=[[m] for m in
                                      [_micro(20 + i) for i in range(8)]]),
             "mesh": dict(kind="mesh")}
    rng = np.random.default_rng(0)
    n, e, d = 32, 64, 8
    cases["edge_sharded"] = dict(
        kind="edge_sharded", x=rng.normal(size=(n, d)).astype(np.float32),
        senders=np.sort(rng.integers(0, n, e)).astype(np.int32),
        receivers=rng.integers(0, n, e).astype(np.int32),
        edge_mask=(rng.random(e) < 0.8).astype(np.float32))
    cases["tile_local"] = _dst_case(np.random.default_rng(1), True)
    cases["cross_shard"] = _dst_case(np.random.default_rng(2), False)
    cases["gspmd_rules"] = _rules_case()
    step = dict(kind="gspmd_step", arrays=_gspmd_batch(),
                dtypes=("float64", "float32"), attention_dropout=0.1)
    cases["gspmd_step2"] = cases["gspmd_step8"] = step
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(flax.linen, "Dropout", _NoDropout)
        gsm, gs_state = _jax_gspmd_init()
    cases["gspmd_jax"] = dict(
        step, dtypes=("float32",), attention_dropout=0.0,
        variables=jax.tree.map(np.asarray, {
            "params": gs_state.params,
            "batch_stats": gs_state.batch_stats}))
    keys = {2: ["dp1", "dp2", "gspmd", "gspmd_rules", "gspmd_step2"],
            8: ["mesh", "edge_sharded", "tile_local", "cross_shard", "dp8",
                "gspmd_jax", "gspmd_step8"]}
    with ThreadPoolExecutor(2) as pool:
        worlds = {w: pool.submit(_world, w, [cases[k] for k in ks])
                  for w, ks in keys.items()}
        want = {"dp1": _jax_dp((jm, state), micro[:2], 2),
                "dp2": _jax_dp((jm, state), micro, 2)}
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(flax.linen, "Dropout", _NoDropout)
            want["gspmd_jax"] = _jax_gspmd(gsm, gs_state)
        got = {}
        for w, ks in keys.items():
            res = worlds[w].result()
            got.update({k: [r[i] for r in res] for i, k in enumerate(ks)})
    return cases, want, got


def _ranks_agree(results):
    for r in results[1:]:
        assert (r["loss"], r["mae"], r["eval"]) == (
            results[0]["loss"], results[0]["mae"], results[0]["eval"])
        for key in ("grads", "buffers", "params"):
            for n, v in results[0][key].items():
                np.testing.assert_array_equal(r[key][n], v, err_msg=n)


# ---------------------------------------------------------------- host side

def test_stack_microbatches_matches_jax():
    batches = [_micro(1), _micro(2)]
    got, want = stack_microbatches(batches), jstack_microbatches(batches)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape[0] == 2
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("mp", [3, 8])
def test_edge_partitioners_match_jax_bit_for_bit(mp):
    """pad_edges_for and partition_edges_by_dst, on a real batch."""
    arrays = _micro(5)
    for k, v in jpad_edges_for(mp, arrays).items():
        np.testing.assert_array_equal(pad_edges_for(mp, arrays)[k], v)
    if arrays["node_mask"].shape[0] % mp == 0:
        got, want = partition_edges_by_dst(arrays, mp), jpartition_edges(
            arrays, mp)
        for k, v in want.items():
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    else:
        with pytest.raises(ValueError, match="not divisible"):
            partition_edges_by_dst(arrays, mp)


# ---------------------------------------------------------------- on ranks

def test_mesh_shapes(runs):
    """make_mesh(dp=4, mp=2) over 8 ranks: a ("dp", "mp") mesh whose
    groups have 4 and 2 ranks; dp * mp != world size is refused."""
    _, _, got = runs
    for r in got["mesh"]:
        assert r["shape"] == (4, 2) and r["names"] == ("dp", "mp")
        assert r["groups"] == [4, 2]
        assert "dp*mp = 6 != 8" in r["refused"]


@pytest.mark.parametrize("key", ["dp1", "dp2"])
def test_dp_step_matches_jax(key, runs):
    """build_dp_steps at dp 2 with 1 and 2 microbatches a rank against JAX
    build_dp_steps on the same 2 or 4 microbatches: the mean loss and MAE,
    the BN statistics averaged over the microbatches and ranks, the
    averaged step-1 gradients, and the eval step's summed loss, MAE and
    graph count."""
    _, want, got = runs
    res, w = got[key], want[key]
    _ranks_agree(res)
    r = res[0]
    np.testing.assert_allclose([r["loss"], r["mae"]], [w["loss"], w["mae"]],
                               rtol=1e-5)
    for k in ("loss_sum", "mae_sum", "n"):
        np.testing.assert_allclose(r["eval"][k], w["eval"][k], rtol=1e-5)
    assert r["grads"].keys() == w["grads"].keys()
    for n, g in w["grads"].items():
        np.testing.assert_allclose(r["grads"][n], g, rtol=1e-4, atol=1e-6,
                                   err_msg=n)
    for n, b in w["buffers"].items():
        np.testing.assert_allclose(r["buffers"][n], b, rtol=0, atol=1e-5,
                                   err_msg=n)


def test_dp_step_over_every_rank_of_a_2d_mesh(runs):
    """The counterpart of JAX's multichip dry run: one DP train step and
    an eval step over all 8 ranks of the world (one microbatch each),
    finite and the same on every rank."""
    _, _, got = runs
    _ranks_agree(got["dp8"])
    assert np.isfinite(got["dp8"][0]["loss"])
    assert np.isfinite(got["dp8"][0]["eval"]["mae_sum"])
    assert got["dp8"][0]["eval"]["n"] == 8 * 12


def test_edge_sharded_aggregate_matches_single_device(runs):
    cases, _, got = runs
    c = cases["edge_sharded"]
    ref = np.zeros_like(c["x"])
    np.add.at(ref, c["receivers"], c["x"][c["senders"]]
              * c["edge_mask"][:, None])
    for out in got["edge_sharded"]:
        np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("key", ["tile_local", "cross_shard"])
def test_halo_and_tile_aligned_aggregate_match_single_device(key, runs):
    """Destination-partitioned aggregation: the all-gather halo exchange
    (and its gradient, the transposed sum of the cotangent) on any edges,
    and the zero-collective tile-aligned form on tile-local edges, match
    the plain sum."""
    cases, _, got = runs
    c = cases[key]
    a = c["arrays"]
    s, r, m = a["senders"], a["receivers"], a["edge_mask"]
    ref = np.zeros_like(c["x"])
    np.add.at(ref, r, c["x"][s] * m[:, None])
    ref_grad = np.zeros_like(c["x"])
    np.add.at(ref_grad, s, c["ct"][r] * m[:, None])
    res = got[key]
    np.testing.assert_allclose(np.concatenate([q["halo"] for q in res]), ref,
                               atol=1e-5)
    np.testing.assert_allclose(np.concatenate([q["grad"] for q in res]),
                               ref_grad, atol=1e-5)
    if c["tile_local"]:
        np.testing.assert_allclose(np.concatenate([q["tile"] for q in res]),
                                   ref, atol=1e-5)


def test_gspmd_shardings_match_jax(runs):
    """graphbatch_shardings shards exactly the leaves JAX's does (node-
    and edge-indexed ones whose length divides the axis) and replicates
    the rest; place_batch leaves each rank its shard of each sharded leaf
    and the whole of each replicated one."""
    cases, _, got = runs
    arrays = cases["gspmd"]["arrays"]
    gb = jfrom_arrays(arrays)
    want = jshardings(jmake_mesh(dp=1, mp=8), gb, "mp")
    for rank, r in enumerate(got["gspmd"]):
        for f in GB_FIELDS:
            leaf = getattr(want, f)
            if leaf is None:
                continue
            assert r["sharded"][f] == (leaf.spec == P("mp")), f
            assert r["replicated"][f] == (leaf.spec == P()), f
            whole = arrays[f]
            local = (np.split(whole, len(got["gspmd"]))[rank]
                     if r["sharded"][f] else whole)
            np.testing.assert_array_equal(r["local"][f], local, err_msg=f)


def test_gspmd_step_matches_jax(runs):
    """build_gspmd_steps at mp 8 against JAX build_gspmd_steps at mp 8 on
    the JAX test's batch and net (bridged weights, attention dropout off
    in both): an eval step, then a train step from the init state."""
    _, want, got = runs
    w = want["gspmd_jax"]
    for r in got["gspmd_jax"]:
        r = r["gspmd_float32"]
        np.testing.assert_allclose([r["loss"], r["mae"]],
                                   [w["loss"], w["mae"]], rtol=1e-5)
        for k in ("loss_sum", "mae_sum", "n"):
            np.testing.assert_allclose(r["eval"][k], w["eval"][k], rtol=1e-5)


def _f64_errors(got, want):
    """Per gradient, BN statistic and Adam moment: |got - want| over the
    larger of the tensor's largest |want| and 1e-4 of the largest of its
    kind in the model (a tensor that is 0 in exact arithmetic, as the
    phi's lin_1.bias, whose gradient a BatchNorm zeroes, keeps only f64
    rounding)."""
    errs = {}
    for kind in ("grads", "buffers", "adam"):
        top = max(float(np.abs(v).max()) for v in want[kind].values())
        assert got[kind].keys() == want[kind].keys()
        for n, v in want[kind].items():
            scale = max(float(np.abs(v).max()), 1e-4 * top)
            errs[f"{kind} {n}"] = float(np.abs(got[kind][n] - v).max()) \
                / scale
    return errs


@pytest.mark.parametrize("world", [2, 8])
def test_gspmd_step_matches_single_device_f64(world, runs):
    """In f64, with the rho's attention dropout on: the GSPMD step's loss,
    MAE and eval sums within 1e-12 relative of the single-device step's,
    and every gradient, BN statistic and Adam moment after the step within
    1e-10 (`_f64_errors`)."""
    _, _, got = runs
    for r in got[f"gspmd_step{world}"]:
        s, g = r["single_float64"], r["gspmd_float64"]
        np.testing.assert_allclose([g["loss"], g["mae"]],
                                   [s["loss"], s["mae"]], rtol=1e-12)
        for k in ("loss_sum", "mae_sum", "n"):
            np.testing.assert_allclose(g["eval"][k], s["eval"][k],
                                       rtol=1e-12)
        errs = _f64_errors(g, s)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1e-10, (worst, errs[worst])


@pytest.mark.parametrize("world", [2, 8])
def test_gspmd_f32_step_within_the_single_device_rounding(world, runs):
    """In f32, with the attention dropout on: the GSPMD step's loss, MAE
    and eval sums within 1e-5 relative of the single-device f32 step's;
    the gradients' distance from the single-device f64 step, each over its
    tensor's largest, within twice the single-device f32 step's, for the
    median over tensors and for the worst tensor (a tensor below 1e-6 of
    the model's largest gradient, 0 in exact arithmetic, left out)."""
    _, _, got = runs
    for r in got[f"gspmd_step{world}"]:
        s, g, x = (r[k] for k in ("single_float32", "gspmd_float32",
                                  "single_float64"))
        np.testing.assert_allclose([g["loss"], g["mae"]],
                                   [s["loss"], s["mae"]], rtol=1e-5)
        for k in ("loss_sum", "mae_sum", "n"):
            np.testing.assert_allclose(g["eval"][k], s["eval"][k], rtol=1e-5)
        dist = {"gspmd": [], "single": []}
        top = max(float(np.abs(v).max()) for v in x["grads"].values())
        for n, v in x["grads"].items():
            scale = float(np.abs(v).max())
            if scale < 1e-6 * top:
                continue    # 0 in exact arithmetic
            for how, rec in (("gspmd", g), ("single", s)):
                dist[how].append(float(np.abs(rec["grads"][n] - v).max())
                                 / scale)
        for stat in (np.median, np.max):
            assert stat(dist["gspmd"]) <= 2 * stat(dist["single"]), stat


@pytest.mark.parametrize("case", ["sum sharded", "sum replicated",
                                  "max sharded", "min sharded",
                                  "gather sharded"])
def test_gspmd_rules_match_the_plain_op(case, runs):
    """The registered rules against the plain ops in f64, forward and the
    gradient of the rows: segment_sum (aten.index_add) of rows and ids
    sharded over mp (a Partial sum) or replicated; segment_max and
    segment_min (aten.scatter_reduce amax/amin: a Partial max or min, then
    replicated by the empty-segment fill) of sharded ones; a gather of
    replicated rows by sharded ids (its backward the accumulating
    aten.index_put). GraphBatch.in_degrees of the placed batch equals the
    plain one."""
    _, _, got = runs
    for r in got["gspmd_rules"]:
        c = r[case]
        if case == "sum sharded":
            assert c["partial"][-1], c["partial"]
        np.testing.assert_allclose(c["got"], c["want"], rtol=1e-13,
                                   atol=1e-13)
        np.testing.assert_allclose(c["grad"], c["grad_want"], rtol=1e-13,
                                   atol=1e-13)
        np.testing.assert_array_equal(*r["in_degrees"])


@pytest.mark.parametrize("draw", ["dropout", "sign_flip"])
def test_gspmd_draws_match_single_device_bit_for_bit(draw, runs):
    """A dropout mask and the sign flips drawn on a sharded DTensor from
    a seeded generator equal the single-device draw from the same seed,
    bit for bit."""
    _, _, got = runs
    for r in got["gspmd_rules"]:
        got_, want = r[draw]
        np.testing.assert_array_equal(got_, want)
        assert np.any(got_ != 0)


@pytest.mark.parametrize("dim", [0, 1])
def test_gspmd_all_gather_through_c10d_matches_funcol(dim, runs):
    """The all-gather that gloo's CUDA tensors take (c10d's
    all_gather_into_tensor) equals the functional all-gather DTensor
    calls, on each gather axis (here on CPU tensors, which gloo's
    functional all-gather takes)."""
    _, _, got = runs
    for r in got["gspmd_rules"]:
        np.testing.assert_array_equal(*r["all_gather"][dim])


@pytest.mark.parametrize("kernel", ["spmm_tiled", "spmm_flat",
                                    "gatedgcn_gate_tiled",
                                    "edge_softmax_attention_tiled"])
def test_kernel_wrappers_refuse_a_dtensor(kernel, runs):
    """K1-K5's wrappers, handed a DTensor outside on_replicated, raise a
    TypeError that names the wrapper (no DTensor storage reaches a
    kernel)."""
    _, _, got = runs
    for r in got["gspmd_rules"]:
        msg = r["refused"][kernel]
        assert msg.startswith(kernel + ": handed a DTensor"), msg
