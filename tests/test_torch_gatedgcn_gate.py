"""K4, the fused GatedGCN gate: the port's plain version (its wrapper on CPU
tensors) against the JAX `gatedgcn_gate_tiled` in Pallas interpret mode and
against `gatedgcn_gate_reference`; its backward against the JAX custom VJP.
The CUDA kernel runs only on the card (tests/test_torch_gpu.py); its ctypes
prototype and its build are checked in tests/test_torch_attention.py beside
K1-K3's.  Here also: a plain-torch mirror of how its warps share the edge
slots.

Tolerances:
- f32 values, 1e-5 (relative and absolute): both sum the same f32 products
  in other orders (the JAX kernel as one-hot products at HIGHEST precision);
- f32 gradients against the JAX custom VJP, 1e-4 relative + 1e-5: the
  backward divides by the gate sums and subtracts c = agg * ghat;
- bf16 values, one bf16 ulp (2**-7 relative): both gather bf16 rows into
  f32, compute e_new, the gate and the sums in f32 and round once on store
  (the JAX kernel by design: it refuses bf16 inputs, see the test).
"""
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
from signnet_basisnet_tpu_torch.ops.spmm_tiled import edge_in_range

from test_pallas_gatedgcn import _problem

TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=1e-5)
FEATS = ("Bh", "Dh", "Eh", "Ce")
EDGES = ("senders", "receivers", "edge_mask", "starts", "ends")


def _jax_problem(seed, **kw):
    """tests/test_pallas_gatedgcn.py's inputs as numpy arrays: 2 tiles of
    256 nodes, 900 dst-sorted edges (a tenth of weight 0) padded to 1024
    with slots outside every tile's range, F = 70."""
    Bh, Dh, Eh, Ce, s, r, em, starts, ends, n, bn, e = _problem(
        np.random.default_rng(seed), **kw)
    arrays = dict(zip(FEATS + EDGES, map(np.array, (Bh, Dh, Eh, Ce, s, r, em,
                                                     starts, ends))))
    return arrays, n, bn, e


def _packed(seed=0, n_graphs=13, tile=32, F=16):
    """A packed synthetic ZINC batch (every edge slot in range, the padding
    edges of weight 0 on the last node) with random gate inputs."""
    gs = synthetic_zinc(n_graphs, 0, 0, seed=seed)["train"]
    nb, eb, gc = choose_budgets(gs, len(gs), tile=tile)
    b = pack_batches(gs, nb, eb, gc, tile=tile)[0]
    r = np.random.default_rng(seed)
    arrays = {k: r.normal(size=(eb if k == "Ce" else nb, F)).astype(
        np.float32) for k in FEATS}
    arrays.update(senders=b["senders"], receivers=b["receivers"],
                  edge_mask=b["edge_mask"], starts=b["tile_starts"],
                  ends=b["tile_ends"])
    return arrays, nb, tile


def _jax_tiled(a, n, bn, dtype=jnp.float32):
    feats = [jnp.asarray(a[k]).astype(dtype) for k in FEATS]
    with pltpu.force_tpu_interpret_mode():
        agg, e_new = jops.gatedgcn_gate_tiled(
            *feats, *(jnp.asarray(a[k]) for k in EDGES), n, bn)
    return (np.asarray(agg.astype(jnp.float32)),
            np.asarray(e_new.astype(jnp.float32)))


def _t(a, keys):
    return [torch.from_numpy(np.ascontiguousarray(a[k])) for k in keys]


def _csr(a, n):
    return edge_csr(*_t(a, ("senders", "receivers")), n)


def test_plain_forward_matches_jax_kernel_and_reference():
    """F = 70 on tests/test_pallas_gatedgcn.py's inputs: agg everywhere and
    e_new at every slot against the JAX kernel (zero at the padding slots
    outside every range, as both leave them); against the reference, agg
    everywhere and e_new at every in-range slot."""
    a, n, bn, e = _jax_problem(0)
    agg, e_new = tops.gatedgcn_gate_plain(*_t(a, FEATS + EDGES), bn)
    jagg, je_new = _jax_tiled(a, n, bn)
    np.testing.assert_allclose(agg.numpy(), jagg, **TOL)
    np.testing.assert_allclose(e_new.numpy(), je_new, **TOL)
    in_range = edge_in_range(*_t(a, ("receivers", "starts", "ends")),
                             bn).numpy()
    assert in_range[:e].all() and not in_range[e:].any()
    assert not e_new.numpy()[e:].any()
    ragg, re_new = jops.gatedgcn_gate_reference(
        *(jnp.asarray(a[k]) for k in FEATS + EDGES[:3]), n)
    np.testing.assert_allclose(agg.numpy(), np.asarray(ragg), **TOL)
    np.testing.assert_allclose(e_new.numpy()[:e], np.asarray(re_new)[:e],
                               **TOL)
    # the port's own reference is the JAX one
    tagg, te_new = tops.gatedgcn_gate_reference(*_t(a, FEATS + EDGES[:3]), n)
    np.testing.assert_allclose(tagg.numpy(), np.asarray(ragg), **TOL)
    np.testing.assert_allclose(te_new.numpy(), np.asarray(re_new), **TOL)


@pytest.mark.parametrize("F", [16, 68])
def test_plain_forward_writes_e_new_at_padding_edges(F):
    """A packed batch: every slot lies in a range, and the weight-0 padding
    edges on the last node get their e_new like any other slot, as the JAX
    kernel writes them."""
    a, n, bn = _packed(F=F)
    pad = a["edge_mask"] == 0
    assert pad.sum() > 0 and a["ends"][-1] == len(pad)
    agg, e_new = tops.gatedgcn_gate_plain(*_t(a, FEATS + EDGES), bn)
    jagg, je_new = _jax_tiled(a, n, bn)
    np.testing.assert_allclose(agg.numpy(), jagg, **TOL)
    np.testing.assert_allclose(e_new.numpy(), je_new, **TOL)
    s, r = a["senders"][pad], a["receivers"][pad]
    np.testing.assert_allclose(e_new.numpy()[pad],
                               a["Dh"][s] + a["Eh"][r] + a["Ce"][pad], **TOL)


def _loss_weights(a, n, in_range, seed):
    r = np.random.default_rng(seed)
    c1 = r.normal(size=(n, a["Bh"].shape[1])).astype(np.float32)
    c2 = (r.normal(size=a["Ce"].shape) * in_range[:, None]).astype(
        np.float32)
    return c1, c2


def test_grads_match_jax_custom_vjp():
    """dBh, dDh, dEh, dCe of <agg, c1> + <e_new, c2> (c2 zero at the slots
    outside every range, where the forward's e_new is the constant 0 but
    the JAX backward, the reference's VJP, passes c2 on): the port's
    autograd Function (plain forward, `gatedgcn_gate_bwd_plain`), autograd
    through `gatedgcn_gate_plain`, and `gatedgcn_gate_bwd_plain` called
    directly, against `jax.grad` of the JAX kernel's custom VJP."""
    a, n, bn, e = _jax_problem(1)
    in_range = np.arange(len(a["senders"])) < e
    c1, c2 = _loss_weights(a, n, in_range, seed=2)
    edges = [jnp.asarray(a[k]) for k in EDGES]

    def jloss(*feats):
        agg, e_new = jops.gatedgcn_gate_tiled(*feats, *edges, n, bn)
        return (agg * c1).sum() + (e_new * c2).sum()

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
            *(jnp.asarray(a[k]) for k in FEATS))
    want = [np.asarray(g) for g in want]
    tedges = _t(a, EDGES)
    csr = _csr(a, n)
    for name, fn in (
            ("tiled", lambda *f: tops.gatedgcn_gate_tiled(
                *f, *tedges, n, bn, csr)),
            ("plain", lambda *f: tops.gatedgcn_gate_plain(*f, *tedges, bn))):
        feats = [t.requires_grad_(True) for t in _t(a, FEATS)]
        agg, e_new = fn(*feats)
        ((agg * torch.from_numpy(c1)).sum()
         + (e_new * torch.from_numpy(c2)).sum()).backward()
        for k, t, g in zip(FEATS, feats, want):
            np.testing.assert_allclose(t.grad.numpy(), g, err_msg=f"{name} "
                                       f"d{k}", **GTOL)
    got = tops.gatedgcn_gate_bwd_plain(
        *_t(a, FEATS + EDGES[:3]), torch.from_numpy(c1),
        torch.from_numpy(c2), n)
    for k, t, g in zip(FEATS, got, want):
        np.testing.assert_allclose(t.numpy(), g, err_msg=f"bwd_plain d{k}",
                                   **GTOL)


def test_plain_bf16_matches_jax_kernel_design_in_bf16():
    """bf16 inputs, on the packed batch at F = 68 and on
    tests/test_pallas_gatedgcn.py's inputs at F = 70.  The JAX kernel
    refuses bf16: it stores its f32 e_new into the bf16 output (`swap`
    raises ValueError).  What it does for bf16 by design, gather bf16 rows
    exactly into f32, compute in f32 and round once on store, is its f32
    run on the bf16-rounded inputs with the outputs rounded to bf16 once
    (its one-hot gathers at HIGHEST precision are exact).  The port's bf16
    agg and e_new lie within one bf16 ulp of that and keep the bf16 type."""
    a, n, bn = _packed(seed=2, F=68)
    with pytest.raises(ValueError, match="dtype"):
        _jax_tiled(a, n, bn, jnp.bfloat16)
    for a, n, bn in ((a, n, bn), _jax_problem(3)[:3]):
        feats = [t.bfloat16() for t in _t(a, FEATS)]
        agg, e_new = tops.gatedgcn_gate_plain(*feats, *_t(a, EDGES), bn)
        assert agg.dtype == e_new.dtype == torch.bfloat16
        a16 = dict(a, **{k: t.float().numpy() for k, t in zip(FEATS, feats)})
        for got, want in zip((agg, e_new), _jax_tiled(a16, n, bn)):
            want = torch.tensor(want).bfloat16().float().numpy()
            np.testing.assert_allclose(got.float().numpy(), want,
                                       rtol=2 ** -7, atol=1e-6)


def test_nonlocal_edge_differs_from_tpu_kernel_as_documented():
    """An in-range edge whose source lies in the other tile: the port counts
    it fully, as the reference and the backward do; the TPU kernel reads
    the source as a zero row, so its e_new lacks Dh[src] and its gate
    sigmoid(Eh[dst] + Ce) enters the destination's denominator with nothing
    in the numerator.  The packer never makes such an edge."""
    a, n, bn, e = _jax_problem(4)
    real = np.nonzero(a["edge_mask"][:e] > 0)[0]
    j = real[len(real) // 2]
    s_old = a["senders"][j]
    a["senders"][j] = (s_old + bn) % n
    s, dst = a["senders"][j], a["receivers"][j]
    assert s // bn != dst // bn
    agg, e_new = (x.numpy() for x in tops.gatedgcn_gate_plain(
        *_t(a, FEATS + EDGES), bn))
    ragg, re_new = jops.gatedgcn_gate_reference(
        *(jnp.asarray(a[k]) for k in FEATS + EDGES[:3]), n)
    np.testing.assert_allclose(agg, np.asarray(ragg), **TOL)
    np.testing.assert_allclose(e_new[:e], np.asarray(re_new)[:e], **TOL)
    jagg, je_new = _jax_tiled(a, n, bn)
    rows = np.arange(n) != dst
    np.testing.assert_allclose(agg[rows], jagg[rows], **TOL)
    slots = np.arange(len(e_new)) != j
    np.testing.assert_allclose(e_new[slots], je_new[slots], **TOL)
    np.testing.assert_allclose(je_new[j], e_new[j] - a["Dh"][s], **TOL)
    # the destination row: the port's num / den against the kernel's
    on_row = np.nonzero((a["receivers"][:e] == dst)
                        & (a["edge_mask"][:e] > 0))[0]
    x = (a["Dh"][a["senders"][on_row]] + a["Eh"][dst] + a["Ce"][on_row])
    sig = 1 / (1 + np.exp(-x.astype(np.float64)))
    num = (sig * a["Bh"][a["senders"][on_row]]).sum(0)
    den = sig.sum(0)
    k = np.searchsorted(on_row, j)
    sig_tpu = 1 / (1 + np.exp(-(a["Eh"][dst] + a["Ce"][j]).astype(
        np.float64)))
    np.testing.assert_allclose(agg[dst], num / (den + 1e-6), **TOL)
    np.testing.assert_allclose(
        jagg[dst], (num - sig[k] * a["Bh"][s]) / (den - sig[k] + sig_tpu
                                                  + 1e-6), **TOL)


def test_wrapper_has_no_path_for_other_devices_and_counts_no_cpu_launch():
    a, n, bn = _packed()
    edges = _t(a, EDGES)
    csr = _csr(a, n)
    f = tops.gatedgcn_gate_tiled
    before = f.launches
    meta = [torch.empty(a[k].shape, device="meta") for k in FEATS]
    with pytest.raises(RuntimeError, match="no path"):
        f(*meta, *edges, n, bn, csr)
    feats = [t.requires_grad_(True) for t in _t(a, FEATS)]
    agg, e_new = f(*feats, *edges, n, bn, csr)
    (agg.sum() + e_new.sum()).backward()
    assert f.launches == before
    assert all(t.grad is not None for t in feats)


def _slot_writers(a, n, bn):
    """A plain-torch mirror of how K4's warps share the edge slots: [E] int
    counts of the writes each slot gets from the row warps (row n walks
    [max(dst_ptr[n], starts[t]), min(dst_ptr[n + 1], ends[t])) of its tile
    t and writes the slots of weight != 0, whatever tile the source lies
    in) and from the rest warps (each slot by the per-slot rule: not (in
    its destination tile's range and weight != 0)), and the rest warps'
    in-range slots, which get e_new rather than 0."""
    s, r, w, starts, ends = _t(a, ("senders", "receivers", "edge_mask",
                                   "starts", "ends"))
    dst_ptr = edge_csr(s, r, n)[0].long()
    e = len(w)
    rows = torch.arange(n)
    t = rows // bn
    lo = torch.maximum(dst_ptr[:-1], starts.long()[t])
    hi = torch.minimum(dst_ptr[1:], ends.long()[t])
    slot = torch.arange(e)
    walked = torch.zeros(e, dtype=torch.long)
    for row in rows[hi > lo].tolist():  # the walk of each row's warp
        j = slot[lo[row]:hi[row]]
        walked[j[w[j] != 0]] += 1
    rl = r.long()
    ok = (rl >= 0) & (rl < n)
    tt = torch.where(ok, rl // bn, 0)
    in_range = ok & (slot >= starts.long()[tt]) & (slot < ends.long()[tt])
    rest = (~(in_range & (w != 0))).long()
    return walked, rest, in_range & (rest == 1)


@pytest.mark.parametrize("case", ["packed", "nonlocal", "out_of_range"])
def test_gate_slot_partition_covers_every_slot_once(case):
    """Row walks and rest warps write every edge slot exactly once: on a
    packed batch (every slot in range; the weight-0 padding edges on the
    last node go to the rest warps, which write their e_new), on the same
    batch with some sources moved to another tile (still walked: K4 has no
    tile-local test) and on tests/test_pallas_gatedgcn.py's inputs (slots
    outside every range, written 0 by the rest warps).  The walk's slots are
    the plain version's counted edges."""
    if case == "out_of_range":
        a, n, bn, e_real = _jax_problem(5)
    else:
        a, n, bn = _packed(seed=4, F=16)
    if case == "nonlocal":
        real = np.nonzero(a["edge_mask"] > 0)[0]
        a["senders"] = a["senders"].copy()
        a["senders"][real[::7]] = (a["senders"][real[::7]] + bn) % n
        assert (a["senders"] // bn != a["receivers"] // bn).sum() > 0
    walked, rest, rest_in_range = _slot_writers(a, n, bn)
    assert bool(((walked + rest) == 1).all())
    in_range = edge_in_range(*_t(a, ("receivers", "starts", "ends")), bn)
    counted = in_range & (torch.from_numpy(a["edge_mask"]) != 0)
    assert torch.equal(walked == 1, counted)
    pad = torch.from_numpy(a["edge_mask"] == 0)
    assert torch.equal(rest_in_range, in_range & pad)
    if case == "out_of_range":
        assert not bool(in_range[e_real:].any()) and bool(rest[e_real:].all())
    else:
        assert bool(in_range.all()) and int(rest_in_range.sum()) == int(
            pad.sum()) > 0
