"""The port's bench.py and bench_roofline.py and the tooling they call
(the one-hot sum backend, `Throughput`, `timed`, the device-ready batcher),
against the JAX package's scripts and modules on the CPU.

Tolerances: analytic FLOP and byte counts, exact (the same float sums in
the same order); the one-hot segment sum, f32 1e-5 relative and absolute
(a matmul sums in another order than the JAX one); batches and edge
counts, exact (both packers are numpy, bit for bit).
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signnet_basisnet_tpu.graph import from_arrays as jfrom_arrays
from signnet_basisnet_tpu.graph import segment as jseg
from signnet_basisnet_tpu.utils.profiling import Throughput as JThroughput

from signnet_basisnet_tpu_torch import bench, bench_roofline
from signnet_basisnet_tpu_torch.data import iterate_graphbatches
from signnet_basisnet_tpu_torch.graph import from_arrays
from signnet_basisnet_tpu_torch.graph import segment as tseg
from signnet_basisnet_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_NET = dict(bench.NET, hidden_dim=16, out_dim=16, n_layers=2,
                 pos_enc_dim=4, sign_inv_layers=2, phi_out_dim=2)


def _root_script(name):
    """The JAX package's root script `name`.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small_batches():
    return bench.build_batches(num_batches=2, batch_graphs=8, k=4, tile=32)


@pytest.mark.parametrize("N,E,G,P", [(3240, 7000, 129, 500_000),
                                     (3584, 7168, 129, 398_765),
                                     (52000, 110000, 2049, 1),
                                     (16, 32, 3, 0)])
def test_analytic_cost_matches_the_jax_script(N, E, G, P):
    jroof = _root_script("bench_roofline")
    assert bench_roofline.analytic_cost(N, E, G, P) == \
        jroof.analytic_cost(N, E, G, P)


@pytest.mark.parametrize("shape", [(40, 6), (40, 3, 5)])
def test_onehot_segment_sum_matches_jax(shape):
    rng = np.random.default_rng(0)
    data = rng.normal(size=shape).astype(np.float32)
    ids = np.sort(rng.integers(0, 12, size=shape[0])).astype(np.int32)
    jseg.set_sum_backend("onehot")
    tseg.set_sum_backend("onehot")
    try:
        want = np.asarray(jseg.segment_sum(jnp.asarray(data),
                                           jnp.asarray(ids), 12))
        got = tseg.segment_sum(torch.from_numpy(data),
                               torch.from_numpy(ids), 12)
    finally:
        jseg.set_sum_backend("xla")
        tseg.set_sum_backend("xla")
    assert tseg.get_sum_backend() == "xla"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tseg.set_sum_backend("dense")


def test_throughput_matches_the_jax_class(small_batches):
    jt, tt = JThroughput(), profiling.Throughput()
    for i, arrays in enumerate(small_batches):
        jt.add(jfrom_arrays(arrays), 0.01 * (i + 1))
        tt.add(from_arrays(arrays), 0.01 * (i + 1))
    assert tt.steps == jt.steps == len(small_batches)
    assert (tt.edges, tt.nodes, tt.graphs) == (jt.edges, jt.nodes, jt.graphs)
    for k, v in jt.summary().items():
        assert tt.summary()[k] == pytest.approx(v, rel=1e-12)
    with profiling.timed() as t:
        pass
    assert 0 <= t["seconds"] < 1


@pytest.mark.parametrize("tile", [None, bench.TILE])
def test_bench_batches_match_the_jax_script(tile):
    jbench = _root_script("bench")
    want = jbench.build_batches(tile=tile)
    got = bench.build_batches(tile=tile)
    assert len(got) == len(want) == bench.NUM_BATCHES
    for a, b in zip(got, want):
        assert {k: v.shape for k, v in a.items()} == \
            {k: np.asarray(v).shape for k, v in b.items()}
        assert a["edge_mask"].sum() == np.asarray(b["edge_mask"]).sum()
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("sums", ["xla", "onehot"])
def test_bench_eager_step_runs_on_the_cpu(small_batches, sums):
    out = bench.bench_eager(small_batches, "cpu", sum_backend=sums,
                            net=SMALL_NET, steps=2, warmup=1)
    edges = sum(b["edge_mask"].sum() for b in small_batches)
    assert out["edges_per_s"] > 0 and out["step_ms"] > 0
    assert out["edges_per_s"] * out["step_ms"] * 2 / 1e3 == \
        pytest.approx(edges)
    assert tseg.get_sum_backend() == "xla"


def test_bench_dense_mode_refuses_to_run_without_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--mode", "dense"])


def test_benches_refuse_to_run_without_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--mode", "flat"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_roofline.main([])


def test_interleaved_windows_and_spread_on_the_cpu(small_batches):
    gbs = [from_arrays(a) for a in small_batches]
    step = bench.eager_step(SMALL_NET, "cpu")
    ms = bench.interleaved_ms({"a": step, "b": step}, gbs, repeats=2,
                              window=1)
    assert set(ms) == {"a", "b"} and all(len(v) == 2 for v in ms.values())
    s = bench.spread(ms["a"])
    assert s["min"] <= s["median"] <= s["max"]


def test_batcher_yields_batches_on_the_requested_device(small_batches):
    from signnet_basisnet_tpu_torch.data import (add_lap_pe, choose_budgets,
                                                 synthetic_zinc)
    gs = synthetic_zinc(20, 0, 0, seed=1)["train"]
    add_lap_pe(gs, 4)
    nb, eb, gc = choose_budgets(gs, 8, tile=32)
    plain = list(iterate_graphbatches(gs, nb, eb, gc, k=4, tile=32))
    on_cpu = list(iterate_graphbatches(gs, nb, eb, gc, k=4, tile=32,
                                       device="cpu"))
    assert len(plain) == len(on_cpu) >= 2
    for a, b in zip(plain, on_cpu):
        ta, tb = a.tensors(), b.tensors()
        assert ta.keys() == tb.keys()
        for k in ta:
            assert tb[k].device.type == "cpu"
            assert torch.equal(ta[k], tb[k]), k


def test_graphbatch_copy_into_a_static_batch(small_batches):
    a, b = (from_arrays(x) for x in small_batches)
    static = a._map(torch.clone)
    assert static.copy_(b) is static
    for k, t in static.tensors().items():
        assert torch.equal(t, b.tensors()[k]), k
    bad = from_arrays(bench.build_batches(num_batches=1, batch_graphs=4,
                                          k=4, tile=32)[0])
    with pytest.raises(ValueError):
        static.copy_(bad)


def test_trace_writes_a_profiler_trace_and_logger_writes_its_files(tmp_path):
    from signnet_basisnet_tpu_torch.utils import RunLogger, log_memory
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert prof is not None and os.listdir(tmp_path / "trace")
    with profiling.trace(None) as prof:
        assert prof is None
    log = RunLogger(str(tmp_path / "logs"), name="r")
    log("hello")
    log.scalars(3, loss=0.5)
    log.close()
    assert "hello" in (tmp_path / "logs" / "r.log").read_text()
    assert '"loss": 0.5' in (tmp_path / "logs" / "r_metrics.jsonl").read_text()
    assert log_memory(log, device="cpu") == {}
