"""K5, the flat destination-sorted SpMM: the port's wrapper on CPU tensors
(its plain version) against the JAX `spmm_pallas` in Pallas interpret mode
and against the JAX `spmm_reference`; the host helpers `pad_edges_to` and
`tile_edge_ranges` against the JAX ones, bit for bit.

Tolerances:
- float32, 1e-5 absolute (1e-5 relative too): all three sum the same
  products in f32 in other orders (measured 4.8e-7);
- bf16: within one bf16 ulp (2**-7 relative) of the JAX kernel's f32 run
  on bf16-rounded inputs, rounded once to bf16, which is what the port
  computes (f32 sum, one rounding).  Against the JAX kernel's own bf16 run,
  within two ulps (2**-6 relative) at every row whose edges lie in one
  256-edge chunk.  The JAX kernel adds each chunk's partial sum into its
  bf16 output, so a row whose edges straddle a chunk boundary is rounded
  twice there; such rows may lie beyond two ulps, and every entry that
  does lies in one (ROADMAP.md queue 3).
"""
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from signnet_basisnet_tpu import ops as jops

from signnet_basisnet_tpu_torch import ops as tops

flat_mod = importlib.import_module("signnet_basisnet_tpu_torch.ops.spmm_flat")

TOL = dict(rtol=1e-5, atol=1e-5)
BN = 256


def _problem(seed, n, e=2000, d=16):
    """Dst-sorted edges over the whole node axis, ~10 % of weight 0, padded
    to 1024 by `pad_edges_to` (weight-0 edges from node 0 to the last
    receiver), with the tile ranges of the padded receivers."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, d)).astype(np.float32)
    s = r.integers(0, n, e).astype(np.int32)
    rc = np.sort(r.integers(0, n, e).astype(np.int32))
    w = ((r.random(e) + 0.5) * (r.random(e) < 0.9)).astype(np.float32)
    s, rc, w = jops.pad_edges_to(s, rc, w, 1024)
    st, en = jops.tile_edge_ranges(rc, n, BN)
    return dict(x=x, s=s, r=rc, w=w, st=st, en=en, n=n)


def _jax_kernel(p, x=None):
    x = p["x"] if x is None else x
    with pltpu.force_tpu_interpret_mode():
        out = jops.spmm_pallas(jnp.asarray(x), *(jnp.asarray(p[k]) for k in
                                                 ("s", "r", "w", "st", "en")),
                               num_nodes=p["n"])
    return np.asarray(out.astype(jnp.float32))


def _jax_reference(p, x=None):
    x = p["x"] if x is None else x
    return np.asarray(jops.spmm_reference(
        jnp.asarray(x), *(jnp.asarray(p[k]) for k in ("s", "r", "w")),
        p["n"]))


def _port(p, x=None):
    x = torch.from_numpy(p["x"]) if x is None else x
    out = tops.spmm_flat(x, *(torch.from_numpy(p[k]) for k in
                              ("s", "r", "w", "st", "en")), p["n"])
    assert out.dtype == x.dtype and out.shape == (p["n"], x.shape[1])
    return out.float().numpy()


@pytest.mark.parametrize("n", [512, 300])
def test_spmm_flat_matches_jax_kernel_and_reference(n):
    """N = 300 is not a multiple of the 256-row tile."""
    p = _problem(0, n)
    got = _port(p)
    np.testing.assert_allclose(got, _jax_kernel(p), **TOL)
    np.testing.assert_allclose(got, _jax_reference(p), **TOL)
    ref = tops.spmm_reference(*(torch.from_numpy(p[k]) for k in
                                ("x", "s", "r", "w")), n)
    np.testing.assert_allclose(ref.numpy(), _jax_reference(p), **TOL)


def _straddling_rows(p):
    """Rows whose edges cross a 256-edge chunk boundary of the JAX kernel."""
    ptr = np.searchsorted(p["r"], np.arange(p["n"] + 1))
    lo, hi = ptr[:-1], ptr[1:]
    return (hi > lo) & (lo // 256 != (hi - 1) // 256)


@pytest.mark.parametrize("n", [512, 300])
def test_spmm_flat_bf16_against_jax_kernel(n):
    p = _problem(0, n)
    xb = torch.from_numpy(p["x"]).bfloat16()
    got = _port(p, xb)
    # the JAX kernel's f32 run on the bf16-rounded inputs, rounded once
    once = _jax_kernel(p, xb.float().numpy())
    once = torch.tensor(once).bfloat16().float().numpy()
    np.testing.assert_allclose(got, once, rtol=2 ** -7, atol=1e-6)
    # the JAX kernel's own bf16 run
    own = _jax_kernel(p, jnp.asarray(p["x"]).astype(jnp.bfloat16))
    beyond = np.abs(got - own) > 2 ** -6 * np.abs(own) + 1e-6
    strad = _straddling_rows(p)
    assert strad.any()
    assert not beyond[~strad].any(), "beyond two ulps at a one-chunk row"
    assert set(np.nonzero(beyond.any(1))[0]) <= set(np.nonzero(strad)[0])


def test_pad_edges_to_and_tile_edge_ranges_match_jax_bit_for_bit():
    r = np.random.default_rng(1)
    for e, be in ((2000, 1024), (2048, 1024), (0, 1024), (7, 8)):
        s = r.integers(0, 300, e).astype(np.int32)
        rc = np.sort(r.integers(0, 300, e).astype(np.int32))
        w = r.random(e).astype(np.float32)
        for a, b in zip(tops.pad_edges_to(s, rc, w, be),
                        jops.pad_edges_to(s, rc, w, be)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        padded = tops.pad_edges_to(s, rc, w, be)[1]
        for n, bn in ((300, 256), (512, 256), (300, 64)):
            for a, b in zip(tops.tile_edge_ranges(padded, n, bn),
                            jops.tile_edge_ranges(padded, n, bn)):
                assert a.dtype == b.dtype == np.int32
                np.testing.assert_array_equal(a, b)


def test_spmm_flat_drops_edges_outside_the_tile_ranges():
    """Ranges narrowed by a few edges at each end: the port and the JAX
    kernel both drop the edges left outside."""
    p = _problem(2, 512)
    p["st"] = p["st"] + 5
    p["en"] = np.maximum(p["en"] - 7, p["st"])
    got = _port(p)
    np.testing.assert_allclose(got, _jax_kernel(p), **TOL)
    keep = np.zeros(len(p["s"]), bool)
    for t, (a, b) in enumerate(zip(p["st"], p["en"])):
        keep[a:b] = p["r"][a:b] // BN == t
    q = dict(p, w=p["w"] * keep)
    assert not np.allclose(got, _jax_reference(p), **TOL)
    np.testing.assert_allclose(got, _jax_reference(q), **TOL)


def test_nonfinite_row_reaches_only_counted_destinations():
    """x[0] = inf.  Row 0 is read by counted edges, by weight-0 edges and by
    every padding edge (weight 0, onto the last receiver).  The port:
    non-finite only at the counted edges' destinations.  The JAX reference:
    at the destination of every edge that reads row 0, the padding's
    included (0 * inf = NaN).  The JAX kernel: everywhere (its
    one-hot gather multiplies all of x).  Other rows agree within 1e-5."""
    p = _problem(3, 512)
    x = p["x"].copy()
    x[0] = np.inf
    counted = (p["s"] == 0) & (p["w"] != 0)
    hit = np.zeros(512, bool)
    hit[p["r"][counted]] = True
    last = p["r"][-1]
    assert hit.any() and not hit[last] and p["w"][-1] == 0
    got = _port(p, torch.from_numpy(x))
    bad = ~np.isfinite(got).all(1)
    np.testing.assert_array_equal(bad, hit)
    ref = _jax_reference(p, x)
    bad_ref = ~np.isfinite(ref).all(1)
    hit_ref = np.zeros(512, bool)
    hit_ref[p["r"][p["s"] == 0]] = True
    assert hit_ref[last] and (hit_ref & ~hit).sum() >= 2
    np.testing.assert_array_equal(bad_ref, hit_ref)
    np.testing.assert_allclose(got[~bad_ref], ref[~bad_ref], **TOL)
    assert not np.isfinite(_jax_kernel(p, x)).all(1).any()


def test_spmm_flat_is_forward_only():
    p = _problem(4, 300, e=500)
    args = [torch.from_numpy(p[k]) for k in ("s", "r", "w", "st", "en")]
    x = torch.from_numpy(p["x"]).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward only"):
        tops.spmm_flat(x, *args, p["n"])
    w = args[2].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward only"):
        tops.spmm_flat(x.detach(), *args[:2], w, *args[3:], p["n"])
    with torch.no_grad():
        out = tops.spmm_flat(x, *args, p["n"])
    np.testing.assert_allclose(out.numpy(), _jax_reference(p), **TOL)
    # as the JAX kernel, which has no VJP
    js = [jnp.asarray(p[k]) for k in ("s", "r", "w", "st", "en")]
    with pltpu.force_tpu_interpret_mode(), pytest.raises(NotImplementedError):
        jax.grad(lambda v: jops.spmm_pallas(v, *js, num_nodes=p["n"]).sum())(
            jnp.asarray(p["x"]))


def test_spmm_flat_counts_no_cpu_launch_and_has_no_other_device_path():
    p = _problem(5, 300, e=500)
    args = [torch.from_numpy(p[k]) for k in ("s", "r", "w", "st", "en")]
    before = tops.spmm_flat.launches
    tops.spmm_flat(torch.from_numpy(p["x"]), *args, p["n"])
    assert tops.spmm_flat.launches == before
    with pytest.raises(RuntimeError, match="no path"):
        tops.spmm_flat(torch.empty(p["x"].shape, device="meta"), *args,
                       p["n"])
    assert tops.spmm_flat.launches == before


def test_spmm_flat_writes_every_row_and_keeps_the_type():
    """Rows with no counted edge are zeros, f64 stays f64."""
    n = 20
    s = np.array([3, 4, 5, 0], np.int32)
    r = np.array([1, 1, 17, 17], np.int32)
    w = np.array([2, 0, 1, 0], np.float32)
    st, en = tops.tile_edge_ranges(r, n, 8)
    x = torch.arange(n, dtype=torch.float64)[:, None] + 1
    args = [torch.from_numpy(a) for a in (s, r, w, st, en)]
    out = tops.spmm_flat(x, *args, n, 8)
    expect = torch.zeros(n, 1, dtype=torch.float64)
    expect[1], expect[17] = 2 * 4, 6
    assert out.dtype == torch.float64
    torch.testing.assert_close(out, expect, rtol=0, atol=0)


def test_kernel_source_names_the_tpu_kernel():
    with open(flat_mod._nvcc.source_path("spmm_flat")) as f:
        src = f.read()
    assert 'extern "C" int spmm_flat_launch(' in src
    assert "spmm_pallas" in src and "spmm_pallas" in flat_mod.__doc__
