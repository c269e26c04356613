"""K1, the tile-local SpMM: the port's wrapper on CPU tensors (its plain
version) against the JAX `spmm_tiled` in Pallas interpret mode.

Values, dx (the transposed direction) and dw must agree in float32 to 1e-5
(the TPU-interpret kernel sums through a dense tile adjacency, the plain
version edge by edge: reduction-order noise only).  Edges that break tile
locality, and edges outside every tile range, are dropped by both.
"""
import importlib
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from signnet_basisnet_tpu import ops as jops

from signnet_basisnet_tpu_torch import ops as tops
from signnet_basisnet_tpu_torch.graph import edge_csr

spmm_mod = importlib.import_module("signnet_basisnet_tpu_torch.ops.spmm_tiled")
nvcc_mod = importlib.import_module("signnet_basisnet_tpu_torch.ops._nvcc")

TOL = dict(rtol=1e-5, atol=1e-5)


def _problem(seed, bn=64, n_tiles=3, e=400, d=16, nonlocal_frac=0.1):
    """Dst-sorted edges, mostly tile-local, padded to 1024 with zero-weight
    edges that lie outside every tile range (as pad_edges_to leaves them)."""
    r = np.random.default_rng(seed)
    n = bn * n_tiles
    t = r.integers(0, n_tiles, size=e)
    dst = (t * bn + r.integers(0, bn, size=e)).astype(np.int32)
    src = (t * bn + r.integers(0, bn, size=e)).astype(np.int32)
    far = r.random(e) < nonlocal_frac
    src[far] = r.integers(0, n, size=int(far.sum()))
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    w = r.random(e).astype(np.float32) + 0.5
    starts, ends = jops.tile_edge_ranges(dst, n, bn)
    src, dst, w = jops.pad_edges_to(src, dst, w, 1024)
    x = r.normal(size=(n, d)).astype(np.float32)
    c = r.normal(size=(n, d)).astype(np.float32)
    return dict(x=x, src=src, dst=dst, w=w, starts=starts, ends=ends, n=n,
                bn=bn, c=c)


def _jax(p, dtype=jnp.float32):
    args = [jnp.asarray(p[k]) for k in ("src", "dst")]

    def loss(x, w):
        out = jops.spmm_tiled(x, *args, w, jnp.asarray(p["starts"]),
                              jnp.asarray(p["ends"]), p["n"], p["bn"])
        return (out.astype(jnp.float32) * p["c"]).sum(), out

    with pltpu.force_tpu_interpret_mode():
        (_, out), (gx, gw) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(
                jnp.asarray(p["x"]).astype(dtype), jnp.asarray(p["w"]))
    return tuple(np.asarray(a.astype(jnp.float32)) for a in (out, gx, gw))


def _args(p):
    """The port's (senders, receivers, weights, starts, ends) tensors."""
    return [torch.from_numpy(p[k]) for k in ("src", "dst", "w", "starts",
                                             "ends")]


def _csr(p):
    return edge_csr(torch.from_numpy(p["src"]), torch.from_numpy(p["dst"]),
                    p["n"])


def _torch(p, dtype=torch.float32):
    x = torch.from_numpy(p["x"]).to(dtype).requires_grad_(True)
    w = torch.from_numpy(p["w"]).requires_grad_(True)
    src, dst, _, starts, ends = _args(p)
    out = tops.spmm_tiled(x, src, dst, w, starts, ends, p["n"], p["bn"],
                          _csr(p))
    (out.float() * torch.from_numpy(p["c"])).sum().backward()
    return tuple(a.detach().float().numpy() for a in (out, x.grad, w.grad))


@pytest.mark.parametrize("seed,bn,d,nonlocal_frac", [
    (0, 64, 16, 0.0), (1, 64, 16, 0.15), (2, 32, 40, 0.3)])
def test_spmm_tiled_matches_jax_values_and_grads(seed, bn, d, nonlocal_frac):
    p = _problem(seed, bn=bn, d=d, nonlocal_frac=nonlocal_frac)
    a = _jax(p)
    b = _torch(p)
    for name, x, y in zip(("out", "dx", "dw"), b, a):
        np.testing.assert_allclose(x, y, err_msg=name, **TOL)


def test_spmm_tiled_drops_nonlocal_and_out_of_range_edges():
    bn, n = 8, 16
    src = np.array([0, 1, 9, 2, 0], np.int32)      # edge 2: src in tile 1
    dst = np.array([1, 2, 3, 10, 15], np.int32)    # edge 3: dst tile 1, src tile 0
    w = np.ones(5, np.float32)
    starts = np.array([0, 3], np.int32)
    ends = np.array([3, 4], np.int32)              # edge 4 is in no range
    x = torch.arange(n, dtype=torch.float32)[:, None] + 1
    args = [torch.from_numpy(a) for a in (src, dst, w, starts, ends)]
    csr = edge_csr(args[0], args[1], n)
    out = tops.spmm_tiled(x, *args, n, bn, csr)[:, 0].numpy()
    expect = np.zeros(n, np.float32)
    expect[1], expect[2] = 1, 2                    # x[0], x[1]
    np.testing.assert_array_equal(out, expect)
    # transposed: dx[s] = sum_e w_e g[dst_e] over the same counted edges
    outt = tops.spmm_tiled_plain(x, *args, bn, transpose=True)[:, 0].numpy()
    expect_t = np.zeros(n, np.float32)
    expect_t[0], expect_t[1] = 2, 3                # g[1], g[2]
    np.testing.assert_array_equal(outt, expect_t)


def test_spmm_tiled_transposed_is_adjoint():
    """<A x, g> == <x, A^T g> for the plain forward and transposed maps."""
    p = _problem(4, nonlocal_frac=0.2)
    args = _args(p)
    x, g = torch.from_numpy(p["x"]), torch.from_numpy(p["c"])
    ax = tops.spmm_tiled_plain(x, *args, p["bn"])
    atg = tops.spmm_tiled_plain(g, *args, p["bn"], transpose=True)
    np.testing.assert_allclose(float((ax * g).sum()), float((x * atg).sum()),
                               rtol=1e-5)


def test_spmm_tiled_bf16_plain_keeps_type():
    """bf16 features: the port against the JAX kernel in bf16 (interpret
    mode), values and dx, output in bf16.

    The JAX kernel rounds its tile adjacency to bf16 before the product;
    the port multiplies by the f32 weights unrounded.  The two agree only
    where the weights are bf16-exact, as the main path's 0/1 edge masks
    are, so the weights here are such masks.  Both accumulate in f32 and
    round the sum once to bf16, in different orders: at most one bf16 ulp
    apart (2**-7 relative)."""
    p = _problem(5, d=24)
    p["w"] = (p["w"] != 0).astype(np.float32)
    a = _jax(p, jnp.bfloat16)
    b = _torch(p, torch.bfloat16)
    x = torch.from_numpy(p["x"]).bfloat16()
    out = tops.spmm_tiled(x, *_args(p), p["n"], p["bn"], _csr(p))
    assert out.dtype == torch.bfloat16
    for name, x, y in zip(("out", "dx"), b, a):
        np.testing.assert_allclose(x, y, rtol=2 ** -7, atol=1e-6,
                                   err_msg=name)


def test_tile_dense_matches_jax_and_spmm_tiled():
    p = _problem(6, nonlocal_frac=0.2)
    x3 = np.random.default_rng(6).normal(size=(p["n"], 3, 5)).astype(
        np.float32)
    a = np.asarray(jops.spmm_tile_dense(
        jnp.asarray(x3), jnp.asarray(p["src"]), jnp.asarray(p["dst"]),
        jnp.asarray(p["w"]), p["n"], p["bn"]))
    b = tops.spmm_tile_dense(torch.from_numpy(x3), torch.from_numpy(p["src"]),
                             torch.from_numpy(p["dst"]),
                             torch.from_numpy(p["w"]), p["n"], p["bn"])
    np.testing.assert_allclose(b.numpy(), a, **TOL)
    adj_a = np.asarray(jops.tile_block_adj(
        jnp.asarray(p["src"]), jnp.asarray(p["dst"]), jnp.asarray(p["w"]),
        p["n"], p["bn"]))
    adj_b = tops.tile_block_adj(torch.from_numpy(p["src"]),
                                torch.from_numpy(p["dst"]),
                                torch.from_numpy(p["w"]), p["n"], p["bn"])
    np.testing.assert_allclose(adj_b.numpy(), adj_a, **TOL)


def test_spmm_tiled_no_path_for_other_devices():
    p = _problem(7)
    args, csr = _args(p), _csr(p)
    x = torch.empty(p["x"].shape, device="meta")
    before = tops.spmm_tiled.launches
    with pytest.raises(RuntimeError, match="no path"):
        tops.spmm_tiled(x, *args, p["n"], p["bn"], csr)
    # the plain version on CPU tensors is no launch
    tops.spmm_tiled(torch.from_numpy(p["x"]), *args, p["n"], p["bn"], csr)
    assert tops.spmm_tiled.launches == before


def test_kernel_source_and_build_flags():
    """The kernel is CUDA C++ for sm_90a with a plain C entry (it is built
    and run only on the card; tests/test_torch_gpu.py holds it there)."""
    with open(nvcc_mod.source_path("spmm_tiled")) as f:
        src = f.read()
    assert 'extern "C" int spmm_tiled_launch(' in src
    assert "torch/extension.h" not in src
    assert "arch=compute_90a,code=sm_90a" in nvcc_mod.NVCC_FLAGS
    assert nvcc_mod.BUILD_DIR.endswith("_build")


def test_ctypes_argtypes_match_the_c_signature():
    """The ctypes prototype must list the C entry's parameters in order:
    a pointer or the stream as c_void_p (else ctypes cuts it to 32 bits),
    an int as c_int."""
    import ctypes
    import re
    with open(nvcc_mod.source_path("spmm_tiled")) as f:
        src = f.read()
    params = re.search(r'extern "C" int spmm_tiled_launch\(([^)]*)\)',
                       src).group(1)
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
             for p in params.split(",")]
    assert all(("*" in p) or p.split()[0] == "int" for p in params.split(","))
    assert spmm_mod.LAUNCH_ARGTYPES == kinds


def test_spmm_tiled_skips_zero_weight_edges():
    """A batch's padding edges (weight 0, all on its last node) contribute
    nothing, not even a NaN from the row they point at."""
    bn, n = 4, 8
    src = np.array([1, 0, 7, 7], np.int32)
    dst = np.array([0, 1, 7, 7], np.int32)
    w = np.array([2, 3, 0, 0], np.float32)
    starts, ends = np.array([0, 2], np.int32), np.array([2, 4], np.int32)
    x = torch.ones(n, 3)
    x[7] = float("nan")
    args = [torch.from_numpy(a) for a in (src, dst, w, starts, ends)]
    for transpose in (False, True):
        out = tops.spmm_tiled_plain(x, *args, bn, transpose=transpose)
        assert torch.isfinite(out).all()
        assert out[:2, 0].tolist() == ([2.0, 3.0] if not transpose
                                       else [3.0, 2.0])


# (num_feat, dtype, x 16-byte aligned, bn) -> (features per load, lanes per
# row): each row width a path launches K1 with (GIN 16, 95, 1520; the
# GatedGCN phi 1088; bench_ops 128), widths that take 32 and 64 lanes, a
# GINConv override's 74 * 67 = 4958, rows off a 16-byte boundary, and tiles
# too small for a warp's rows
@pytest.mark.parametrize("feat,dtype,aligned,bn,want", [
    (16, torch.float32, True, 256, (4, 4)),
    (16, torch.bfloat16, True, 256, (8, 4)),
    (95, torch.float32, True, 256, (1, 16)),
    (95, torch.bfloat16, True, 256, (1, 16)),
    (128, torch.float32, True, 256, (4, 16)),
    (128, torch.bfloat16, True, 256, (8, 8)),
    (256, torch.float32, True, 256, (4, 32)),
    (512, torch.float32, True, 256, (4, 64)),
    (1088, torch.float32, True, 256, (4, 128)),
    (1520, torch.float32, True, 256, (4, 128)),
    (1520, torch.bfloat16, True, 256, (8, 128)),
    (4958, torch.float32, True, 256, (1, 128)),
    (1520, torch.float32, False, 256, (1, 128)),
    (16, torch.float32, False, 256, (1, 4)),
    (16, torch.float32, True, 4, (4, 8)),
    (16, torch.float32, True, 1, (4, 32)),
])
def test_kernel_variant_takes_whole_rows(feat, dtype, aligned, bn, want):
    """The host picks K1's variant: 16-byte loads only where F and x allow
    them, the fewest lanes per row (up to 4 warps) whose loads cover the
    row in one pass, and only as many rows per warp as share a tile."""
    vec, group = spmm_mod.kernel_variant(feat, dtype, aligned, bn)
    assert (vec, group) == want
    assert feat % vec == 0 and (group >= 32 or bn % (32 // group) == 0)
    per_pass = group * spmm_mod._VECS_PER_EDGE[vec] * vec
    assert group == spmm_mod._GROUPS[-1] or per_pass >= feat


def test_kernel_variants_mirror_the_source():
    """What the host picks is what the C entry takes: the vectors a lane
    loads per edge, the load widths per type and the lanes per row."""
    with open(nvcc_mod.source_path("spmm_tiled")) as f:
        src = f.read()
    one, wide = map(int, re.search(
        r"vecs_per_edge\(\) \{ return V == 1 \? (\d+) : (\d+); \}",
        src).groups())
    assert spmm_mod._VECS_PER_EDGE == {1: one, 4: wide, 8: wide}
    assert "vec == 8   ? launch_vec<__nv_bfloat16, 8>" in src
    assert "vec == 4   ? launch_vec<float, 4>" in src
    groups = {int(g) for g in re.findall(r"case (\d+): SPMM_TILED_ROWS", src)}
    assert groups == set(spmm_mod._GROUPS)
    for feat in (16, 95, 128, 1088, 1520, 4958):
        for dtype in (torch.float32, torch.bfloat16):
            for aligned in (True, False):
                vec, group = spmm_mod.kernel_variant(feat, dtype, aligned,
                                                     256)
                assert group in groups
                assert vec in ((1, 4) if dtype == torch.float32 else (1, 8))
