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
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from signnet_basisnet_tpu import ops as jops

from signnet_basisnet_tpu_torch import bench_ops
from signnet_basisnet_tpu_torch import ops as tops
from test_torch_gpu import FLAT_SHAPES

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


# the kernel's block and chunk constants (csrc/spmm_flat.cu), mirrored by
# `_kernel_partition`; `test_partition_constants_mirror_the_source` reads
# them back from the source
K_WARPS, K_SLOTS, K_ROUNDS = 8, 4, 4
K_THREADS = 32 * K_WARPS
K_CAP = K_SLOTS * K_THREADS


def _kernel_partition(r, w, st, en, n, bn, group):
    """A plain-numpy mirror of how K5's blocks share rows and edge slots.

    Block b takes rows [n0, n1) of tile t = b // per_tile (8 warps of
    32 / group rows), narrows the tile's range [starts[t], ends[t]) by probe
    rounds while it is wider than a chunk of K_CAP slots (256 probes, the
    counts below n0 and below n1), stages the window chunk by chunk, keeps
    the slots of weight != 0 whose receiver is one of its rows (compacted
    in slot order) and walks each row between the first and the last kept
    position of its receiver.  Returns the blocks (n0, n1, lo, hi, rounds)
    and, per row, the slots its lanes walk in order.  The card's cases
    (tests/test_torch_gpu.py) hold the kernel itself to the same rows."""
    rows = K_WARPS * (32 // group)
    per_tile = -(-min(bn, n) // rows)
    blocks, walked = [], [[] for _ in range(n)]
    for b in range(-(-n // bn) * per_tile):
        t, k = divmod(b, per_tile)
        n0 = t * bn + k * rows
        n1 = min(n0 + rows, (t + 1) * bn, n)
        if n0 >= n1:
            continue
        lo = int(st[t])
        hi = max(lo, int(en[t]))
        rounds = 0
        while rounds < K_ROUNDS and hi - lo > K_CAP:
            step = -(-(hi - lo) // K_THREADS)
            q = lo + np.arange(K_THREADS) * step
            rq = np.where(q < hi, r[np.minimum(q, hi - 1)],
                          np.iinfo(np.int32).max)
            ca, cb = int((rq < n0).sum()), int((rq < n1).sum())
            hi = min(hi, lo + cb * step)
            lo = lo + (ca - 1) * step + 1 if ca else lo
            rounds += 1
        blocks.append((n0, n1, lo, hi, rounds))
        for c0 in range(lo, hi, K_CAP):
            j = np.arange(c0, min(c0 + K_CAP, hi))
            staged = j[(w[j] != 0) & (r[j] >= n0) & (r[j] < n1)]
            for row in range(n0, n1):
                pos = np.nonzero(r[staged] == row)[0]
                if len(pos):
                    walked[row] += staged[pos.min():pos.max() + 1].tolist()
    return blocks, walked


def _partition_case(case):
    """(receivers, weights, starts, ends, n) of each partition case."""
    bn = BN
    if case in ("bench_ops", "narrowed", "empty_tile"):
        p = bench_ops.flat_problem()
        r, w, st, en, n = p["rp"], p["wp"], p["st"], p["en"], bench_ops.N
    elif case == "n300":
        p = _problem(6, 300)
        r, w, st, en, n = p["r"], p["w"], p["st"], p["en"], 300
    else:  # long runs of equal receivers on both sides of a tile boundary
        n = 600
        rng = np.random.default_rng(7)
        r = np.sort(np.concatenate([rng.integers(0, n, 3000),
                                    np.full(3000, bn - 1), np.full(2000, bn)]))
        w = ((rng.random(len(r)) + 0.5)
             * (rng.random(len(r)) < 0.8)).astype(np.float32)
        _, r, w = tops.pad_edges_to(np.zeros(len(r), np.int32),
                                    r.astype(np.int32), w, 1024)
        st, en = tops.tile_edge_ranges(r, n, bn)
        # tile 0's range reaches 700 slots into row bn's run, and tile 1's
        # starts 500 slots into it
        st, en = st.copy(), en.copy()
        en[0] += 700
        st[1] += 500
    if case == "narrowed":
        st = st + 5
        en = np.maximum(en - 7, st)
    if case == "empty_tile":
        en = en.copy()
        en[3] = st[3]
    return r, w, st, en, n


@pytest.mark.parametrize("group", [32, 16])
@pytest.mark.parametrize("case", ["bench_ops", "n300", "narrowed",
                                  "empty_tile", "boundary"])
def test_row_partition_walks_dst_pointers_within_the_tile_range(case,
                                                                group):
    """Every row's walk is its CSR segment (dst_pointers, here
    np.searchsorted over the receivers) cut to its tile's range, the
    weight-0 slots left out, in slot order; the blocks take every row once.
    bench_ops' tiles (about 600 slots) take no probe round; the long runs
    of the boundary case take probe rounds and several chunks."""
    r, w, st, en, n = _partition_case(case)
    blocks, walked = _kernel_partition(r, w, st, en, n, BN, group)
    ptr = np.searchsorted(r, np.arange(n + 1))
    for row in range(n):
        t = row // BN
        j0, j1 = max(ptr[row], st[t]), min(ptr[row + 1], en[t])
        want = [j for j in range(j0, j1) if w[j] != 0]
        assert walked[row] == want, row
    rows = np.concatenate([np.arange(b[0], b[1]) for b in blocks])
    np.testing.assert_array_equal(np.sort(rows), np.arange(n))
    for n0, n1, lo, hi, _ in blocks:
        t = n0 // BN
        assert st[t] <= lo <= max(ptr[n0], st[t]) or lo == hi
        assert min(ptr[n1], en[t]) <= hi <= max(en[t], st[t]) or lo == hi
    rounds = {b[4] for b in blocks}
    if case == "boundary":
        assert max(rounds) > 0 and max(b[3] - b[2] for b in blocks) > K_CAP
    elif case != "n300":
        assert rounds == {0}
    if case == "empty_tile":
        assert all(walked[row] == [] for row in range(3 * BN, 4 * BN))


def test_partition_constants_mirror_the_source():
    with open(flat_mod._nvcc.source_path("spmm_flat")) as f:
        src = f.read()
    const = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    assert const["kWarps"] == str(K_WARPS)
    assert const["kThreads"] == "32 * kWarps"
    assert const["kSlots"] == str(K_SLOTS)
    assert const["kCap"] == "kSlots * kThreads"
    assert "hi - lo > kCap" in src
    assert const["kRounds"] == str(K_ROUNDS)
    assert "return kWarps * (32 / G);" in src


@pytest.mark.parametrize("feat,dtype,aligned,want", [
    (16, torch.float32, True, (4, 16)),     # narrow rows: 16 lanes a row
    (16, torch.float32, False, (1, 16)),
    (16, torch.bfloat16, True, (8, 16)),
    (16, torch.bfloat16, False, (1, 16)),
    (95, torch.float32, True, (1, 32)),     # D not a multiple of 4
    (95, torch.float32, False, (1, 32)),
    (95, torch.bfloat16, True, (1, 32)),
    (95, torch.bfloat16, False, (1, 32)),
    (128, torch.float32, True, (4, 32)),    # bench_ops: one row a warp
    (128, torch.float32, False, (1, 32)),
    (128, torch.bfloat16, True, (8, 16)),   # two rows a warp
    (128, torch.bfloat16, False, (1, 32)),
])
def test_kernel_variant_takes_16_byte_loads_where_rows_allow(feat, dtype,
                                                             aligned, want):
    assert flat_mod.kernel_variant(feat, dtype, aligned) == want


def test_kernel_variants_mirror_the_source():
    """What the host picks is what the C entry takes: the vectors a lane
    loads per edge, the load widths per type and the lanes per row."""
    with open(flat_mod._nvcc.source_path("spmm_flat")) as f:
        src = f.read()
    one, wide = map(int, re.search(
        r"vecs_per_lane\(\) \{ return V == 1 \? (\d+) : (\d+); \}",
        src).groups())
    assert flat_mod._VECS_PER_LANE == {1: one, 4: wide, 8: wide}
    assert "vec == 8   ? launch_vec<__nv_bfloat16, 8>" in src
    assert "vec == 4   ? launch_vec<float, 4>" in src
    groups = {int(g) for g in re.findall(r"case (\d+): SPMM_FLAT_ROWS", src)}
    assert groups == set(flat_mod._GROUPS)
    for feat in (16, 95, 128, 256, 4958):
        for dtype in (torch.float32, torch.bfloat16):
            for aligned in (True, False):
                vec, group = flat_mod.kernel_variant(feat, dtype, aligned)
                assert group in groups and feat % vec == 0
                assert vec in ((1, 4) if dtype == torch.float32 else (1, 8))


def test_flat_shapes_take_every_kernel_instance():
    """The card's K5 checks (FLAT_SHAPES of tests/test_torch_gpu.py) reach
    every (type, features per load, lanes per row) that the picker can
    choose, and each (type, features per load) with a row in more than one
    pass."""
    reached, multi = set(), set()
    for _, d in FLAT_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            vec, group = flat_mod.kernel_variant(d, dtype, True)
            reached.add((dtype, vec, group))
            if d // vec > group * flat_mod._VECS_PER_LANE[vec]:
                multi.add((dtype, vec))
    pairs = {(torch.float32, 1), (torch.float32, 4), (torch.bfloat16, 1),
             (torch.bfloat16, 8)}
    assert reached == {(dt, v, g) for dt, v in pairs
                       for g in flat_mod._GROUPS}
    assert multi == pairs
