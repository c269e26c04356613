"""K2/K3, the fused edge-softmax attention: the port's plain version (its
wrapper on CPU tensors) against the JAX `edge_softmax_attention_tiled` in
Pallas interpret mode and against `edge_softmax_attention_reference`, on
packed tile-local batches; and the build and ctypes binding of every CUDA
kernel of the port (K1-K5), which run only on the card
(tests/test_torch_gpu.py).

Tolerances, float32:
- values, 1e-5 (relative and absolute): both sum the same products in f32,
  in other orders;
- dQ, dK, dV, dE1 against the JAX custom VJP, 1e-5 absolute + 1e-4
  relative: the backward divides by the denominator and subtracts
  c = sum_d out * ghat, which loses a digit or so to cancellation.
"""
import ctypes
import importlib
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from signnet_basisnet_tpu import ops as jops

from signnet_basisnet_tpu_torch import ops as tops
from signnet_basisnet_tpu_torch.data import (choose_budgets, pack_batches,
                                             synthetic_zinc)
from signnet_basisnet_tpu_torch.graph import edge_csr

nvcc_mod = importlib.import_module("signnet_basisnet_tpu_torch.ops._nvcc")
attn_mod = importlib.import_module(
    "signnet_basisnet_tpu_torch.ops.edge_attention")
gate_mod = importlib.import_module(
    "signnet_basisnet_tpu_torch.ops.gatedgcn_gate")
spmm_mod = importlib.import_module("signnet_basisnet_tpu_torch.ops.spmm_tiled")
flat_mod = importlib.import_module("signnet_basisnet_tpu_torch.ops.spmm_flat")

TOL = dict(rtol=1e-5, atol=1e-5)
EDGE_KEYS = ("senders", "receivers", "edge_mask", "tile_starts", "tile_ends")


def _packed(seed=0, n_graphs=13, tile=32):
    gs = synthetic_zinc(n_graphs, 0, 0, seed=seed)["train"]
    nb, eb, gc = choose_budgets(gs, len(gs), tile=tile)
    return pack_batches(gs, nb, eb, gc, tile=tile)[0], tile


def _inputs(arrays, H, D, seed, e1_ones=False, q_scale=1.0):
    r = np.random.default_rng(seed)
    n, e = len(arrays["node_mask"]), len(arrays["senders"])
    Q, K, V = (r.normal(size=(n, H, D)).astype(np.float32) for _ in range(3))
    Q *= q_scale
    E1 = (np.ones((e, H, D), np.float32) if e1_ones
          else r.normal(size=(e, H, D)).astype(np.float32))
    C = r.normal(size=(n, H, D)).astype(np.float32)
    return dict(Q=Q, K=K, V=V, E1=E1, C=C)


def _jax_tiled(x, arrays, bn, dtype=jnp.float32, grads=False):
    edges = [jnp.asarray(arrays[k]) for k in EDGE_KEYS]
    n = len(arrays["node_mask"])

    def loss(Q, K, V, E1):
        out = jops.edge_softmax_attention_tiled(Q, K, V, E1, *edges, n, bn)
        return (out.astype(jnp.float32) * x["C"]).sum(), out

    args = [jnp.asarray(x[k]).astype(dtype) for k in ("Q", "K", "V", "E1")]
    with pltpu.force_tpu_interpret_mode():
        if not grads:
            return np.asarray(loss(*args)[1].astype(jnp.float32))
        (_, out), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3), has_aux=True))(*args)
    return tuple(np.asarray(a.astype(jnp.float32)) for a in (out,) + g)


def _torch_plain(x, arrays, bn, dtype=torch.float32):
    qkve = [torch.from_numpy(x[k]).to(dtype).requires_grad_(True)
            for k in ("Q", "K", "V", "E1")]
    edges = [torch.from_numpy(arrays[k]) for k in EDGE_KEYS]
    csr = edge_csr(edges[0], edges[1], len(arrays["node_mask"]))
    out = tops.edge_softmax_attention_tiled(*qkve, *edges, bn, csr)
    (out.float() * torch.from_numpy(x["C"])).sum().backward()
    return tuple(a.detach().float().numpy()
                 for a in [out] + [t.grad for t in qkve])


@pytest.mark.parametrize("e1_ones", [True, False])
@pytest.mark.parametrize("H,D", [(8, 8), (8, 10), (4, 7)])
def test_plain_forward_matches_jax_kernel_and_reference(H, D, e1_ones):
    arrays, bn = _packed()
    x = _inputs(arrays, H, D, seed=H * D, e1_ones=e1_ones)
    got = _torch_plain(x, arrays, bn)[0]
    np.testing.assert_allclose(got, _jax_tiled(x, arrays, bn), **TOL)
    ref = jops.edge_softmax_attention_reference(
        *(jnp.asarray(x[k]) for k in ("Q", "K", "V")),
        None if e1_ones else jnp.asarray(x["E1"]),
        *(jnp.asarray(arrays[k]) for k in EDGE_KEYS[:3]),
        len(arrays["node_mask"]))
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("H,D", [(8, 8), (4, 7)])
def test_plain_grads_match_jax_custom_vjp(H, D):
    """Q is scaled so that a good share of the scores lies beyond +-5,
    where the clamp passes no gradient, and none lies within 1e-3 of it."""
    arrays, bn = _packed(seed=1)
    x = _inputs(arrays, H, D, seed=7, q_scale=5.0)
    real = arrays["edge_mask"] > 0
    s, r = arrays["senders"][real], arrays["receivers"][real]
    score = (x["K"][s] * x["Q"][r] * x["E1"][real]).sum(-1) / np.sqrt(D)
    assert 0.1 < (np.abs(score) > 5).mean() < 0.9
    assert np.abs(np.abs(score) - 5).min() > 1e-3
    got = _torch_plain(x, arrays, bn)
    want = _jax_tiled(x, arrays, bn, grads=True)
    for name, a, b in zip(("out", "dQ", "dK", "dV", "dE1"), got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)
    # K3's own plain version, from ghat and c as the kernel's caller forms
    # them out of the forward's output and denominator
    den = np.zeros((len(arrays["node_mask"]), H), np.float32)
    np.add.at(den, r, np.exp(np.clip(score, -5, 5)).astype(np.float32))
    ghat = torch.from_numpy(x["C"]) / (torch.from_numpy(den)[:, :, None]
                                       + 1e-6)
    c = (torch.from_numpy(got[0]) * ghat).sum(-1)
    grads = tops.edge_attention_bwd_plain(
        *(torch.from_numpy(x[k]) for k in ("Q", "K", "V", "E1")), ghat, c,
        *(torch.from_numpy(arrays[k]) for k in EDGE_KEYS), bn)
    for name, a, b in zip(("dQ", "dK", "dV", "dE1"), grads, want[1:]):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5,
                                   err_msg=f"bwd_plain {name}")


def test_plain_bf16_matches_jax_kernel_bf16():
    """bf16 inputs: both versions scale Q by bf16(1/sqrt(D)) and round the
    product to bf16 (the JAX wrapper's `Q * (1/sqrt(D))`), then compute in
    f32 and round the output once to bf16.  They differ in the order of the
    f32 sums only, so the outputs are at most one bf16 ulp apart
    (2**-7 relative) and the port keeps the bf16 type."""
    arrays, bn = _packed(seed=2)
    x = _inputs(arrays, 8, 8, seed=3)
    got = _torch_plain(x, arrays, bn, torch.bfloat16)[0]
    want = _jax_tiled(x, arrays, bn, jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
    q = torch.from_numpy(x["Q"]).bfloat16()
    edges = [torch.from_numpy(arrays[k]) for k in EDGE_KEYS]
    out = tops.edge_softmax_attention_plain(q, q, q, q.new_ones(
        (len(arrays["senders"]),) + q.shape[1:]), *edges, bn)
    assert out.dtype == torch.bfloat16


def test_nonlocal_edge_differs_from_tpu_kernel_as_documented():
    """An edge whose source lies outside its tile: the port drops it (as the
    tile-local SpMM does); the TPU kernel reads the source as a zero row, so
    it adds exp(0) * mask = 1 to the denominator and nothing to the
    numerator.  The packer never makes such an edge."""
    arrays, bn = _packed(seed=3)
    arrays = dict(arrays)
    real = np.nonzero(arrays["edge_mask"] > 0)[0]
    e = real[len(real) // 2]
    n = len(arrays["node_mask"])
    arrays["senders"] = arrays["senders"].copy()
    arrays["senders"][e] = (arrays["senders"][e] + bn) % n
    x = _inputs(arrays, 4, 7, seed=4)
    port = _torch_plain(x, arrays, bn)[0]
    jax_kernel = _jax_tiled(x, arrays, bn)
    dst = arrays["receivers"][e]
    rows = np.arange(n) != dst
    np.testing.assert_allclose(port[rows], jax_kernel[rows], **TOL)
    # on the edge's row: port = num / den, kernel = num / (den + 1)
    kept = np.ones(len(real), bool)
    kept[np.searchsorted(real, e)] = False
    idx = real[kept]
    ref = jops.edge_softmax_attention_reference(
        *(jnp.asarray(x[k]) for k in ("Q", "K", "V")),
        jnp.asarray(x["E1"][idx]), jnp.asarray(arrays["senders"][idx]),
        jnp.asarray(arrays["receivers"][idx]),
        jnp.asarray(arrays["edge_mask"][idx]), n)
    np.testing.assert_allclose(port, np.asarray(ref), **TOL)
    s, r = arrays["senders"][idx], arrays["receivers"][idx]
    on_row = r == dst
    score = (x["K"][s[on_row]] * x["Q"][dst] * x["E1"][idx[on_row]]).sum(-1)
    den = np.exp(np.clip(score / np.sqrt(7), -5, 5)).sum(0)      # [H]
    np.testing.assert_allclose(jax_kernel[dst],
                               port[dst] * (den / (den + 1))[:, None],
                               rtol=1e-4, atol=1e-6)


def test_wrapper_has_no_path_for_other_devices_and_counts_no_cpu_launch():
    arrays, bn = _packed()
    x = _inputs(arrays, 4, 7, seed=5)
    edges = [torch.from_numpy(arrays[k]) for k in EDGE_KEYS]
    csr = edge_csr(edges[0], edges[1], len(arrays["node_mask"]))
    f = tops.edge_softmax_attention_tiled
    before = (f.launches_fwd, f.launches_bwd)
    meta = [torch.empty(x[k].shape, device="meta") for k in ("Q", "K", "V",
                                                             "E1")]
    with pytest.raises(RuntimeError, match="no path"):
        f(*meta, *edges, bn, csr)
    _torch_plain(x, arrays, bn)
    assert (f.launches_fwd, f.launches_bwd) == before


def _c_argtypes(src: str, entry: str):
    """The ctypes prototype a C entry needs: c_void_p for a pointer or the
    stream (else ctypes cuts it to 32 bits), c_int for an int, c_float for
    a float."""
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1)
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    out = []
    for p in params.split(","):
        words = p.split()
        out.append(ctypes.c_void_p if "*" in p else kinds[words[0]])
    return out


@pytest.mark.parametrize("name,entry,argtypes", [
    ("spmm_tiled", "spmm_tiled_launch", spmm_mod.LAUNCH_ARGTYPES),
    ("edge_attention", "edge_attention_fwd", attn_mod.FWD_ARGTYPES),
    ("edge_attention", "edge_attention_bwd", attn_mod.BWD_ARGTYPES),
    ("gatedgcn_gate", "gatedgcn_gate_fwd", gate_mod.FWD_ARGTYPES),
    ("spmm_flat", "spmm_flat_launch", flat_mod.LAUNCH_ARGTYPES)])
def test_ctypes_argtypes_match_the_c_signatures(name, entry, argtypes):
    with open(nvcc_mod.source_path(name)) as f:
        src = f.read()
    assert "torch/extension.h" not in src
    assert _c_argtypes(src, entry) == argtypes


@pytest.mark.parametrize("mod,name,entries", [
    (spmm_mod, "spmm_tiled", ("spmm_tiled_launch",)),
    (attn_mod, "edge_attention", ("edge_attention_fwd",
                                  "edge_attention_bwd")),
    (gate_mod, "gatedgcn_gate", ("gatedgcn_gate_fwd",)),
    (flat_mod, "spmm_flat", ("spmm_flat_launch",))])
def test_kernels_build_through_the_nvcc_loader(monkeypatch, tmp_path, mod,
                                               name, entries):
    """`build()` of each kernel module goes through `_nvcc.load`: one nvcc
    call with the sm_90a flags on csrc/<name>.cu into the build directory,
    then ctypes prototypes on every entry; a second call reuses the
    library.  (nvcc and the card exist only on the card's machine: here
    nvcc and ctypes.CDLL are stand-ins that record what they were given.)"""
    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("")
        return type("P", (), dict(returncode=0, stdout="",
                                  stderr="ptxas info: Used 40 registers"))()

    class FakeLib:
        def __init__(self, path):
            self.path = path
            for e in entries:
                setattr(self, e, type("Fn", (), {})())

    monkeypatch.setattr(nvcc_mod, "_libs", {})
    monkeypatch.setattr(nvcc_mod, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(nvcc_mod, "_find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(nvcc_mod.subprocess, "run", fake_run)
    monkeypatch.setattr(nvcc_mod.ctypes, "CDLL", FakeLib)
    lib = mod.build()
    assert mod.build() is lib and len(calls) == 1
    cmd = calls[0]
    assert cmd[0] == "nvcc" and cmd[-1] == nvcc_mod.source_path(name)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[1:1 + len(nvcc_mod.NVCC_FLAGS)] == nvcc_mod.NVCC_FLAGS
    assert lib.path.startswith(str(tmp_path)) and f"lib{name}_" in lib.path
    assert not [p for p in tmp_path.iterdir() if p.suffix == ".tmp"]
    for e in entries:
        fn = getattr(lib, e)
        assert fn.restype is ctypes.c_int and fn.argtypes
    assert "Used 40 registers" in nvcc_mod.build_info[name]["ptxas"]


class _AnyEntryLib:
    """A stand-in for ctypes.CDLL: every entry name is a settable object."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, entry):
        fn = type("Fn", (), {})()
        setattr(self, entry, fn)
        return fn


@pytest.mark.parametrize("mod,name", [
    (spmm_mod, "spmm_tiled"), (attn_mod, "edge_attention"),
    (gate_mod, "gatedgcn_gate"), (flat_mod, "spmm_flat")])
def test_a_reused_library_reports_its_ptxas(monkeypatch, tmp_path, mod,
                                            name):
    """A library built by an earlier process is loaded without nvcc, and
    `build_info` still holds its `-Xptxas -v` report, read back from beside
    the library (the card's smoke run names every instance from it); a
    library whose report is gone is built again."""
    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("")
        return type("P", (), dict(
            returncode=0, stdout="",
            stderr=f"ptxas info: Function properties for {name}_k\n"
                   "ptxas info: Used 40 registers"))()

    monkeypatch.setattr(nvcc_mod, "_libs", {})
    monkeypatch.setattr(nvcc_mod, "build_info", {})
    monkeypatch.setattr(nvcc_mod, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(nvcc_mod, "_find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(nvcc_mod.subprocess, "run", fake_run)
    monkeypatch.setattr(nvcc_mod.ctypes, "CDLL", _AnyEntryLib)
    mod.build()
    first = dict(nvcc_mod.build_info[name])
    for _ in range(2):  # a later process: nothing loaded yet, nvcc not run
        nvcc_mod._libs.clear()
        nvcc_mod.build_info.clear()
        mod.build()
        assert len(calls) == 1
        info = nvcc_mod.build_info[name]
        assert info["path"] == first["path"]
        assert info["ptxas"] == first["ptxas"]
        assert "Used 40 registers" in info["ptxas"]
    reports = [p for p in tmp_path.iterdir() if p.suffix == ".ptxas"]
    assert [p.name for p in reports] == [
        os.path.basename(first["path"])[:-3] + ".ptxas"]
    reports[0].unlink()
    nvcc_mod._libs.clear()
    mod.build()
    assert len(calls) == 2 and reports[0].exists()
    assert "Used 40 registers" in nvcc_mod.build_info[name]["ptxas"]


@pytest.mark.parametrize("H,D,aligned,want", [
    (8, 8, True, 1),     # the shipped Transformer: 2 lanes a head
    (8, 8, False, 0),    # rows off a 4-element boundary
    (8, 10, True, 0),    # D not a multiple of 4
    (8, 7, True, 0),     # the masked Transformer's D
    (4, 7, True, 0),     # the CPU tests' D = 7
    (4, 8, True, 1),     # 8 lanes a row: 4 edges at once
    (4, 4, True, 1),     # 1 lane a head, 8 edges at once
    (2, 16, True, 1),    # 4 lanes a head
    (8, 16, True, 1),    # a row in all 32 lanes
    (3, 4, True, 0),     # 3 lanes a row do not divide 32
    (16, 16, True, 0),   # a row wider than a warp's 128 features
])
def test_bwd_variant_picks_the_vector_layout_where_heads_line_up(H, D,
                                                                 aligned,
                                                                 want):
    assert attn_mod.bwd_variant(H, D, aligned) == want


def test_bwd_variant_mirrors_the_source():
    """The C entry refuses the vector layout exactly where the host would
    not pick it."""
    with open(nvcc_mod.source_path("edge_attention")) as f:
        src = f.read()
    assert ("if (vec && (head_dim % 4 || lpr > 32 || 32 % lpr)) return "
            "(int)cudaErrorInvalidValue;") in src
    for H in range(1, 20):
        for D in range(1, 20):
            lpr = H * D // 4
            refused = D % 4 != 0 or lpr > 32 or 32 % lpr != 0
            assert attn_mod.bwd_variant(H, D, True) == int(not refused)


def test_forward_layout_mirrors_the_source():
    """K2's C entry refuses the vector layout exactly where K3's does, and
    both launch it only where the host would pick it."""
    with open(nvcc_mod.source_path("edge_attention")) as f:
        src = f.read()
    refuse = ("if (vec && (head_dim % 4 || lpr > 32 || 32 % lpr)) return "
              "(int)cudaErrorInvalidValue;")
    for entry in ("edge_attention_fwd", "edge_attention_bwd"):
        body = src[src.index(f'extern "C" int {entry}('):]
        body = body[:body.index("\n}\n")]
        assert refuse in body, entry
    assert "if (vec) {\n    attn_fwd_vec_kernel<T>" in src
