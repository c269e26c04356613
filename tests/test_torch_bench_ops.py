"""The modules the port's `bench_ops` entry point needs, against the JAX
package on the CPU: the one-hot segment ops (float32, 1e-5: the same sums
in other orders), the native packer (bit for bit against both packages'
`batch_np`), the profiling helpers, and the
`bench_ops` sections themselves at small sizes with `device="cpu"` (the
kernels' plain versions); `bench_scaling` on CPU ranks; and a guard
that no module of the port imports JAX or the JAX package.
"""
import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from signnet_basisnet_tpu import ops as jops
from signnet_basisnet_tpu.graph import batch_np as jbatch_np

from signnet_basisnet_tpu_torch import bench_ops, bench_scaling
from signnet_basisnet_tpu_torch import ops as tops
from signnet_basisnet_tpu_torch.data import native
from signnet_basisnet_tpu_torch.graph import batch_np as tbatch_np
from signnet_basisnet_tpu_torch.graph import segment as tseg
from signnet_basisnet_tpu_torch.parallel import partition_batch_mp
from signnet_basisnet_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


def _edges(seed, n=64, e=200, d=16):
    r = np.random.default_rng(seed)
    s = r.integers(0, n, e).astype(np.int32)
    rc = np.sort(r.integers(0, n, e).astype(np.int32))
    w = (r.random(e) < 0.8).astype(np.float32)
    x = r.normal(size=(n, d)).astype(np.float32)
    return x, s, rc, w


def _onehot_cases():
    x, s, r, w = _edges(0)
    ew = np.random.default_rng(1).random(len(s)).astype(np.float32)
    return {
        "spmm": lambda m, A: m.spmm_onehot(A(x), A(s), A(r), A(w), 64),
        "spmm_weighted": lambda m, A: m.spmm_onehot(
            A(x), A(s), A(r), A(w), 64, edge_weight=A(ew)),
        "gather": lambda m, A: m.gather_onehot(A(x), A(s)),
        "segment_sum": lambda m, A: m.segment_sum_onehot(A(x[s]), A(r), 64),
        # ids outside [0, num_segments) give zero one-hot rows in both
        "segment_sum_out_of_range": lambda m, A: m.segment_sum_onehot(
            A(x[s]), A(r), 40),
    }


@pytest.mark.parametrize("case", list(_onehot_cases()))
def test_onehot_ops_match_jax(case):
    fn = _onehot_cases()[case]
    np.testing.assert_allclose(fn(tops, torch.from_numpy).numpy(),
                               np.asarray(fn(jops, jnp.asarray)), **TOL)


def test_onehot_spmm_matches_the_reference():
    x, s, r, w = (torch.from_numpy(a) for a in _edges(0))
    np.testing.assert_allclose(
        tops.spmm_onehot(x, s, r, w, 64).numpy(),
        tops.spmm_reference(x, s, r, w, 64).numpy(), **TOL)


def _packer_graphs(seed, count=5):
    """As tests/test_native_batcher.py draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(4, 10))
        A = np.triu((rng.random((n, n)) < 0.5).astype(int), 1)
        A = A + A.T
        s, r = np.nonzero(A)
        out.append(dict(
            senders=s.astype(np.int32), receivers=r.astype(np.int32),
            node_feat=rng.integers(0, 28, n).astype(np.int32),
            edge_feat=rng.integers(0, 4, len(s)).astype(np.int32),
            y=np.array([float(rng.normal())], np.float32),
            eigvecs=rng.normal(size=(n, n)).astype(np.float32),
            eigvals=rng.normal(size=(n,)).astype(np.float32)))
    return out


PACKER_KEYS = ("senders", "receivers", "edge_mask", "graph_id",
               "edge_graph_id", "node_mask", "n_node", "n_edge",
               "graph_mask", "node_feat", "edge_feat", "eigvecs", "eigvals",
               "eig_mask", "y")


@pytest.mark.parametrize("seed", [0, 3])
def test_native_packer_matches_both_batch_np_bit_for_bit(seed):
    gs = _packer_graphs(seed)
    kmax = max(g["eigvecs"].shape[1] for g in gs)
    ref_t = tbatch_np(gs, 64, 256, 8, k=kmax)
    ref_j = jbatch_np(gs, 64, 256, 8, k=kmax)
    store = native.GraphStore(gs, k=kmax)
    out = native.pack_batch_native(store, np.arange(len(gs)), 64, 256, 8)
    again = native.pack_batch_native(store, np.arange(len(gs))[::-1], 64,
                                     256, 8)
    rev = tbatch_np(gs[::-1], 64, 256, 8, k=kmax)
    for key in PACKER_KEYS:
        for ref in (ref_t, ref_j):
            np.testing.assert_array_equal(np.asarray(out[key]),
                                          np.asarray(ref[key]), err_msg=key)
            assert np.asarray(out[key]).dtype == np.asarray(ref[key]).dtype
        np.testing.assert_array_equal(np.asarray(again[key]),
                                      np.asarray(rev[key]), err_msg=key)


def test_native_packer_overflow_raises():
    store = native.GraphStore(_packer_graphs(1, count=3))
    with pytest.raises(ValueError):
        native.pack_batch_native(store, np.arange(3), 8, 16, 8)


def test_native_library_builds_into_the_ports_own_directory(monkeypatch,
                                                           tmp_path):
    """A fresh build lands in the port's build directory (here a temporary
    one), named by the hash of source and flags, and writes nothing into
    native/."""
    native_dir = os.path.join(ROOT, "native")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIB", None)
    assert native.native_available()
    path = native.library_path()
    assert os.path.dirname(path) == str(tmp_path) and os.path.exists(path)
    assert [p.name for p in tmp_path.iterdir()] == [os.path.basename(path)]
    assert not [f for f in os.listdir(native_dir)
                if f.startswith("libsbt_native_")]
    assert native.SOURCE == os.path.join(native_dir, "batcher.cpp")
    # the package's own directory is gitignored
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "signnet_basisnet_tpu_torch/data/_build/" in f.read().split()


def test_native_packer_has_no_fallback(monkeypatch, tmp_path):
    """No compiler: `native_available()` says so and packing raises; it does
    not fall back to the numpy packer."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.native_available()
    store = native.GraphStore(_packer_graphs(2, count=2))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.pack_batch_native(store, np.arange(2), 64, 256, 8)
    assert not list(tmp_path.iterdir())


def test_profiling_helpers_on_the_cpu():
    """No CUDA memory to report for a CPU device."""
    assert profiling.device_memory_stats("cpu") == {}
    assert profiling.device_memory_stats(torch.device("cpu")) == {}


def _check_section(rec, kernels):
    for key, v in rec["max_err"].items():
        assert v["ok"] and 0 <= v["max_err"] <= 1e-3, key
    assert all(np.isfinite(t) and t > 0 for t in rec["ms"].values())
    # on the CPU the plain versions run: calls, but no launch
    assert all(rec["calls"][k] > 0 for k in kernels)
    assert not any(rec["launches"].values())


def test_bench_ops_sections_on_the_cpu():
    cpu = torch.device("cpu")
    rec = bench_ops.bench_flat_spmm(cpu, n=300, e=700, d=16, reps=2)
    assert set(rec["ms"]) == {"xla_scatter", "onehot", "spmm_flat"}
    assert set(rec["max_err"]) == {"onehot", "spmm_flat"}
    assert rec["e_padded"] == 1024
    _check_section(rec, ["spmm_flat"])
    rec = bench_ops.bench_tiled_spmm(cpu, n=512, e=700, d=16, reps=2)
    _check_section(rec, ["spmm_tiled"])
    rec = bench_ops.bench_attention(cpu, n=512, e=700, H=2, Dh=5, reps=2)
    assert set(rec["max_err"]) == {"attn_fwd", "attn_dQ", "attn_dK",
                                   "attn_dV", "attn_dE1"}
    assert set(rec["ms"]) == {"attn_xla", "attn_kernel", "attn_xla+bwd",
                              "attn_kernel+bwd"}
    assert rec["calls"] == {"edge_attention_fwd": 12,
                            "edge_attention_bwd": 6}
    _check_section(rec, ["edge_attention_fwd", "edge_attention_bwd"])
    rec = bench_ops.bench_gatedgcn(cpu, n=512, e=700, F=12, reps=2)
    assert set(rec["max_err"]) == {"gate_agg", "gate_e_new_valid"}
    _check_section(rec, ["gatedgcn_gate_fwd"])


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_bench_ops_comparison_refuses_non_finite_values(bad):
    """A NaN or inf in a kernel's output is beyond every tolerance, and the
    record keeps it as the error."""
    sec = bench_ops._Section("s", torch.device("cpu"), 1)
    got = torch.zeros(4, 3)
    got[2, 1] = bad
    with pytest.raises(AssertionError, match="1 entries"):
        sec.compare("k", got, torch.zeros(4, 3))
    rec = sec.rec["max_err"]["k"]
    assert not rec["ok"] and not np.isfinite(rec["max_err"])


def test_bench_ops_flat_section_fails_loudly(monkeypatch):
    """A kernel that disagrees makes its section raise: no FAILED line and
    carrying on."""
    flat = tops.spmm_flat

    def off(x, *a):
        return flat(x, *a) + 1e-3

    off.launches = 0
    monkeypatch.setattr(bench_ops.ops, "spmm_flat", off)
    with pytest.raises(AssertionError, match="spmm_flat"):
        bench_ops.bench_flat_spmm(torch.device("cpu"), n=300, e=700, d=16,
                                  reps=1)


TINY = {name: dict(hidden_dim=8, out_dim=8, n_layers=2, pos_enc_dim=4,
                   lap_method="sign_inv", sign_inv_net="gin",
                   sign_inv_layers=2, phi_out_dim=2, batch_norm=True,
                   dropout=0.0, **extra)
        for name, extra in (("GIN", {}),
                            ("Transformer", dict(num_heads=2, edge_feat=True)),
                            ("GatedGCN", dict(edge_feat=True)))}


def test_bench_ops_train_steps_and_packer_on_the_cpu():
    # the backend is process-global and `train_zinc.run` leaves the one its
    # config sets: start from the default, whatever ran before in this
    # worker, so the check below sees bench_train_steps restore it
    tseg.set_agg_backend("xla")
    rec = bench_ops.bench_train_steps(torch.device("cpu"), TINY, n_graphs=8,
                                      reps=2, warmup=1)
    runs = {f"{m}_{b}" for m in TINY for b in ("xla", "pallas_tile")}
    assert set(rec["ms"]) == runs and set(rec["steps"]) == runs
    assert all(v == 3 for v in rec["steps"].values())
    assert all(v == {} for v in rec["launches_per_step"].values())
    assert rec["real_edges"] > 0 and tseg.get_agg_backend() == "xla"
    pk = bench_ops.bench_packer(n_graphs=200, batch=16, reps=2)
    for key in ("numpy_ms_per_batch", "native_ms_per_batch",
                "numpy_graphs_per_s", "native_graphs_per_s"):
        assert pk[key] > 0


def test_bench_ops_main_runs_every_section(monkeypatch):
    """`main` on the CPU at small sizes: one record per section, TF32 off
    while the sections run and as the caller had it afterwards."""
    b = dict(vars(bench_ops))
    small = dict(flat_spmm=lambda d: b["bench_flat_spmm"](
                     d, n=300, e=700, d=8, reps=1),
                 tiled_spmm=lambda d: b["bench_tiled_spmm"](
                     d, n=512, e=700, d=8, reps=1),
                 attention=lambda d: b["bench_attention"](
                     d, n=512, e=700, H=2, Dh=3, reps=1),
                 gatedgcn=lambda d: b["bench_gatedgcn"](
                     d, n=512, e=700, F=6, reps=1),
                 train_steps=lambda d: b["bench_train_steps"](
                     d, {"GIN": TINY["GIN"]}, n_graphs=8, reps=1, warmup=1))
    tf32, flat = [], small["flat_spmm"]

    def flat_noting_tf32(d):
        tf32.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return flat(d)

    small["flat_spmm"] = flat_noting_tf32
    for name, fn in small.items():
        monkeypatch.setattr(bench_ops, f"bench_{name}", fn)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    res = bench_ops.main(["--device", "cpu"])
    assert set(res) == {"device", "clock"} | set(small)
    assert res["device"] == "cpu" and res["clock"] == "host"
    assert tf32 == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert torch.backends.cudnn.allow_tf32 is True
    monkeypatch.setattr(bench_ops, "bench_packer",
                        lambda: {"native_ms_per_batch": 1.0})
    assert bench_ops.main(["--packer"]) == {
        "packer": {"native_ms_per_batch": 1.0}}


def test_port_imports_no_jax():
    """Every module of the port, bench_ops, the Alchemy, GINE-ZINC and
    LearningFilters slices' modules, the parallel paths (parallel/,
    bench_scaling) and the modules GSPMD reaches (the segment sums, the
    draws, the kernel wrappers) included, imports with `jax`
    unimportable, and loads nothing of the JAX package."""
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import signnet_basisnet_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert "signnet_basisnet_tpu_torch.bench_ops" in names, names
assert "signnet_basisnet_tpu_torch.ops.spmm_flat" in names, names
for new in ("train_alchemy", "train_zinc_gine", "models.gnn",
            "graph.segment", "graph.batch", "nn.dropout", "models.pe",
            "models.conv", "ops._nvcc", "ops.spmm_tiled", "ops.spmm_flat",
            "ops.gatedgcn_gate", "ops.edge_attention",
            "models.baselines", "nn.encoders", "nn.set_transformer",
            "nn.set2set", "data.alchemy", "spectral.projectors",
            "train_filters", "models.basisnet", "models.spectral_filters",
            "nn.deepsets", "nn.ign", "data.twodgrid", "parallel",
            "parallel.mesh", "parallel.data_parallel", "parallel.mp_halo",
            "parallel.edge_partition", "parallel.gspmd", "bench_scaling"):
    assert "signnet_basisnet_tpu_torch." + new in names, (new, names)
bad = [m for m, mod in sys.modules.items() if mod is not None and (
       m == "signnet_basisnet_tpu" or m.startswith("signnet_basisnet_tpu.")
       or m.split(".")[0] in ("jax", "jaxlib", "flax"))]
assert not bad, bad
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 68


def test_native_argtypes_match_the_c_signature():
    """The ctypes prototype lists pack_batch's parameters in order, with
    each pointer's element type and each scalar as a 32-bit int."""
    import ctypes
    import re
    with open(native.SOURCE) as f:
        src = f.read()
    params = re.search(r"int pack_batch\(([^)]*)\)", src).group(1)
    kinds = {"int32_t": ctypes.c_int32, "int64_t": ctypes.c_int64,
             "float": ctypes.c_float}
    want = []
    for p in params.split(","):
        t = kinds[p.replace("const", "").split()[0].rstrip("*")]
        want.append(ctypes.POINTER(t) if "*" in p else t)
    assert native.PACK_ARGTYPES == want


def test_bench_scaling_runs_on_cpu_ranks(capsys):
    """bench_scaling on the CPU at its full sizes: DP and GSPMD at worlds
    of one and two gloo ranks, mp 1 (the single-device step) and mp 2, one
    timed step each, larger worlds skipped; the halo and exchange sizes
    come from the partition, and the last line is the JSON record."""
    res = bench_scaling.main(["--device", "cpu", "--reps", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1])["device"] == "cpu"
    assert set(res["dp"]) == {1, 2} and set(res["mp_halo"]) == {1, 2}
    assert "dp world 8: skipped (too many ranks)" in out
    assert "gspmd world 8: skipped (too many ranks)" in out
    mp2 = res["mp_halo"][2]
    parts = partition_batch_mp(bench_scaling.make_global(
        bench_scaling.MP_GRAPHS), 2)
    assert mp2["halo"] == parts["halo"] and mp2["rows_per_exchange"] == \
        2 * parts["halo"]
    assert all(np.isfinite(v["ms"]) for v in res["mp_halo"].values())
    assert set(res["gspmd"]) == {1, 2}
    assert all(np.isfinite(v["ms"]) and v["ms"] > 0
               for v in res["gspmd"].values())
