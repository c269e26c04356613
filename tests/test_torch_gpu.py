"""K1, K2, K3, K4 and K5 on the card: the CUDA kernels against their
plain versions, and the train steps that launch them.

Marked `gpu`: each test asks the `cuda` fixture for the card and skips
without one, so on a machine with no NVIDIA card they skip with a reason.
Run them on the card with

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: f32, 1e-5 (each row sums its edges in a fixed order; only the
order differs from the plain index_add_); bf16, one bf16 rounding of the
output (2**-8 relative) beside the plain version that rounds once too.
K3 is held at its launch against `edge_attention_bwd_plain` from the same
ghat and c, and the whole autograd path (K2, glue, K3) in f32 against
autograd through the plain version: 1e-4 relative + 1e-5 of the tensor's
largest magnitude (at least 1e-5), since the backward subtracts
c = sum_d out * ghat from sums of that magnitude and loses a digit to that
cancellation.  (In bf16 the autograd path forms c from the bf16-rounded
output, as the JAX glue does, where autograd through the plain version
uses the unrounded one, so the two are not held to each other there.)
K2's out and den, K3's dE1 and K4's agg and e_new are allocated without
being filled: the tests that hand the kernels NaN-filled memory
(`nan_filled_empty`) show that every row and slot is written, in each
layout.
K4 (the GatedGCN gate) against its plain version: f32 1e-5, bf16 one bf16
rounding of agg and e_new (2**-7 relative + 1e-3); its autograd path (K4,
then the plain backward) in f32 against autograd through the plain version
to the K3 tolerance, since both backwards divide by the gate sums and
subtract c = agg * ghat.
K5 (the flat SpMM) against its plain version: f32 1e-5, bf16 one bf16
rounding (2**-7 relative); a non-finite row of x reaches only the rows of
the counted edges that read it; every row is written over NaN-filled
memory, with narrowed tile ranges, an empty tile and long rows that take
the kernel's probe rounds and several chunks; a call is one device kernel.
The Alchemy and GINE-ZINC nets' train and eval steps at published widths
(both phi types) launch none of K1-K5, and the set transformer's attention
dropout draws a fresh mask each eager step and each replay of a captured
step from the net's generator.
The LearningFilters model's train step (`train_filters.train_step`) on a
12x12 grid matches the CPU's in f64 within 1e-9 under deterministic
algorithms, for the BasisNet, SignNet-Transformer, BernNet and sign-flip
GatNet rows, launching none of K1-K5; the vmapped trainer follows the
serial steps in f64 within 1e-6, and `train_filters.run` trains there,
serially and vmapped (the initial losses within 1e-4).
The parallel paths on the card (ranks are processes that
`parallel.mesh.spawn_ranks` starts from tests/torch_ranks.py): a
data-parallel step in a world of one rank over NCCL against the mean of
the single-device steps (1e-4 relative; K1 launched per microbatch), and
a model-parallel step at mp = 2 (two ranks sharing the card over gloo)
against the single-device step in f64 within 1e-9, with no kernel.
The captured step's device spans (utils/profiling.py: timer stamps of
ops/timer_stamp.py, kernel nodes of the graph captured with them) read
every region of a replay, the step within 10 % of a CUDA-event time of
that replay, and only the sampled replays stamp; `step.launches` holds
the eager step's K1 launches and `step.replays` the calls.
"""
import importlib

import pytest
import torch

from signnet_basisnet_tpu_torch import bench_ops, ops
from signnet_basisnet_tpu_torch.data import (add_lap_pe, choose_budgets,
                                             pack_batches, synthetic_zinc)
from signnet_basisnet_tpu_torch.graph import edge_csr, from_arrays
from signnet_basisnet_tpu_torch.graph import segment as seg
from signnet_basisnet_tpu_torch.training import (adam, build_steps,
                                                 make_zinc_predict)
from signnet_basisnet_tpu_torch.models import gnn_model
from signnet_basisnet_tpu_torch.models.conv import batch_csr
from signnet_basisnet_tpu_torch.utils import nan_filled_empty

spmm_mod = importlib.import_module("signnet_basisnet_tpu_torch.ops.spmm_tiled")
attn_mod = importlib.import_module(
    "signnet_basisnet_tpu_torch.ops.edge_attention")
gate_mod = importlib.import_module(
    "signnet_basisnet_tpu_torch.ops.gatedgcn_gate")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU path)")
    return torch.device("cuda")


def _off_alignment(t):
    """The same values one element past an alignment."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def _batch(n_graphs=60, tile=256, seed=0):
    gs = synthetic_zinc(n_graphs, 0, 0, seed=seed)["train"]
    add_lap_pe(gs, 8)
    nb, eb, gc = choose_budgets(gs, n_graphs, tile=tile)
    return from_arrays(pack_batches(gs, nb, eb, gc, k=8, tile=tile)[0])


def _args(gb):
    return (gb.senders, gb.receivers, gb.edge_mask, gb.extras["tile_starts"],
            gb.extras["tile_ends"])


def _far_batch(gb, bn):
    """The batch with every 17th real edge's source moved to another tile:
    (args, csr); both versions must drop those edges."""
    s_far = gb.senders.clone()
    real = torch.nonzero(gb.edge_mask > 0)[:, 0]
    pick = real[::17]
    s_far[pick] = (s_far[pick] + bn) % gb.num_nodes
    return (s_far,) + _args(gb)[1:], edge_csr(s_far, gb.receivers,
                                              gb.num_nodes)


def _spmm_check(x, args, csr, bn, transpose):
    got = spmm_mod._launch(x, *args, csr, bn, transpose)
    ref = ops.spmm_tiled_plain(x, *args, bn, transpose=transpose)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    tol = 1e-5 if x.dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


# every F a path launches K1 with (16, 95, 1520 GIN; 1088 the GatedGCN phi;
# 128 bench_ops), 256 and 512 (32 and 64 lanes per row) and a GINConv
# override's 4958: together they take every load width (16 bytes, one
# element) and lanes per row (4 to 128)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("feat", [16, 95, 128, 256, 512, 1088, 1520, 4958])
def test_kernel_matches_plain(cuda, dtype, transpose, feat):
    gb = _batch().to(cuda)
    g = torch.Generator(device=cuda).manual_seed(feat)
    x = torch.randn(gb.num_nodes, feat, device=cuda, generator=g).to(dtype)
    bn = gb.num_nodes // gb.extras["tile_starts"].shape[0]
    _spmm_check(x, _args(gb), batch_csr(gb), bn, transpose)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("feat", [16, 128, 1520])
def test_kernel_one_element_loads_on_unaligned_rows(cuda, dtype, feat):
    """x that starts off a 16-byte boundary takes the one-element loads,
    at the lanes per row its width gives, both ways and on the batch with
    non-tile-local edges."""
    gb = _batch().to(cuda)
    bn = gb.num_nodes // gb.extras["tile_starts"].shape[0]
    g = torch.Generator(device=cuda).manual_seed(feat)
    flat = torch.randn(gb.num_nodes * feat + 1, device=cuda, generator=g)
    x = flat.to(dtype)[1:].view(gb.num_nodes, feat)
    assert x.data_ptr() % 16 and spmm_mod.kernel_variant(
        feat, dtype, False, bn)[0] == 1
    for args, csr in ((_args(gb), batch_csr(gb)), _far_batch(gb, bn)):
        for transpose in (False, True):
            _spmm_check(x, args, csr, bn, transpose)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("feat", [16, 95, 1520])
def test_kernel_drops_nonlocal_edges_of_a_batch(cuda, dtype, feat):
    gb = _batch().to(cuda)
    bn = gb.num_nodes // gb.extras["tile_starts"].shape[0]
    args, csr = _far_batch(gb, bn)
    g = torch.Generator(device=cuda).manual_seed(feat)
    x = torch.randn(gb.num_nodes, feat, device=cuda, generator=g).to(dtype)
    for transpose in (False, True):
        _spmm_check(x, args, csr, bn, transpose)


@pytest.mark.parametrize("feat", [16, 1520])
def test_kernel_rows_beyond_what_shared_memory_holds(cuda, feat):
    """Rows with more counted edges than a warp keeps in shared memory
    (256): each lane then walks its row's edges itself; the sums must not
    change.  Two tiles of 256 nodes; in tile 0, rows 8-15 take 40 edges
    each (F = 16 packs them in one warp: 320) and row 3 takes 400 (F =
    1520: one row a warp), all from source 5 (the transposed walk's long
    row), with weight-0 and non-tile-local edges among them."""
    bn, n = 256, 512
    g = torch.Generator().manual_seed(feat)
    deg = torch.zeros(n, dtype=torch.long)
    deg[8:16], deg[3] = 40, 400
    deg[256:300] = 3
    dst = torch.repeat_interleave(torch.arange(n), deg)
    src = dst // bn * bn + torch.randint(0, bn, dst.shape, generator=g)
    src[dst == 3] = 5
    far = torch.rand(dst.shape, generator=g) < 0.05
    src[far] = (src[far] + bn) % n
    w = torch.rand(dst.shape, generator=g) + 0.5
    w[torch.rand(dst.shape, generator=g) < 0.1] = 0.0
    starts = torch.searchsorted(dst, torch.tensor([0, bn]))
    ends = torch.searchsorted(dst, torch.tensor([bn, n]))
    args = [a.to(cuda) for a in (src.int(), dst.int(), w, starts.int(),
                                 ends.int())]
    csr = edge_csr(args[0], args[1], n)
    x = torch.randn(n, feat, device=cuda)
    for transpose in (False, True):
        _spmm_check(x, args, csr, bn, transpose)


def test_kernel_autograd_and_counter(cuda):
    gb = _batch().to(cuda)
    bn = gb.num_nodes // gb.extras["tile_starts"].shape[0]
    x = torch.randn(gb.num_nodes, 95, device=cuda, requires_grad=True)
    c = torch.randn(gb.num_nodes, 95, device=cuda)
    before = ops.spmm_tiled.launches
    out = ops.spmm_tiled(x, *_args(gb), gb.num_nodes, bn,
                         csr=batch_csr(gb))
    (out * c).sum().backward()
    assert ops.spmm_tiled.launches == before + 2
    xr = x.detach().clone().requires_grad_(True)
    (ops.spmm_tiled_plain(xr, *_args(gb), bn) * c).sum().backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-5, atol=1e-5)


def test_kernel_drops_nonlocal_edges(cuda):
    bn, n = 8, 16
    src = torch.tensor([0, 1, 9, 2, 0], dtype=torch.int32, device=cuda)
    dst = torch.tensor([1, 2, 3, 10, 15], dtype=torch.int32, device=cuda)
    w = torch.ones(5, device=cuda)
    starts = torch.tensor([0, 3], dtype=torch.int32, device=cuda)
    ends = torch.tensor([3, 4], dtype=torch.int32, device=cuda)
    x = torch.arange(n, dtype=torch.float32, device=cuda)[:, None] + 1
    out = ops.spmm_tiled(x, src, dst, w, starts, ends, n, bn,
                         edge_csr(src, dst, n))[:, 0]
    expect = torch.zeros(n, device=cuda)
    expect[1], expect[2] = 1, 2
    torch.testing.assert_close(out, expect, rtol=0, atol=0)


def test_train_step_on_card_counts_47_launches(cuda):
    gb = _batch(n_graphs=40).to(cuda)
    model = gnn_model("GIN", hidden_dim=16, out_dim=16, n_layers=16,
                      pos_enc_dim=8, lap_method="sign_inv",
                      sign_inv_layers=8, phi_out_dim=4,
                      pe_aggregate="concat").to(cuda)
    step, ev = build_steps(model, make_zinc_predict(model, "sign_inv"),
                           adam(model.parameters()))
    seg.set_agg_backend("pallas_tile")
    try:
        before = ops.spmm_tiled.launches
        loss = step(gb, 1e-3)["loss"]
        assert ops.spmm_tiled.launches - before == 47
        before = ops.spmm_tiled.launches
        ev(gb)
        assert ops.spmm_tiled.launches - before == 24
    finally:
        seg.set_agg_backend("xla")
    assert torch.isfinite(loss)


def _attn_inputs(gb, H, D, dtype, seed, q_scale=2.0):
    g = torch.Generator(device=gb.senders.device).manual_seed(seed)
    n, e = gb.num_nodes, gb.num_edges
    mk = lambda *shape: torch.randn(*shape, device=gb.senders.device,
                                    generator=g)
    qkve = [mk(n, H, D) * q_scale, mk(n, H, D), mk(n, H, D), mk(e, H, D)]
    return [t.to(dtype).requires_grad_(True) for t in qkve], mk(n, H, D)


def _grad_tol(ref):
    return dict(rtol=1e-4,
                atol=1e-5 * max(1.0, float(ref.detach().abs().max())))


def _attn_run(fn, gb, qkve, c, bn):
    out = fn(*qkve, *_args(gb), bn)
    (out.float() * c).sum().backward()
    grads = [t.grad.float() for t in qkve]
    for t in qkve:
        t.grad = None
    return [out.float()] + grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,D", [(8, 8), (8, 10), (8, 7)])
def test_attention_kernels_match_plain(cuda, dtype, H, D):
    """K2 (values) and K3 (dQ, dK, dV, dE1 at its launch) against their
    plain versions at a full-width tile; in f32 also the autograd path."""
    gb = _batch().to(cuda)
    bn = gb.num_nodes // gb.extras["tile_starts"].shape[0]
    qkve, g = _attn_inputs(gb, H, D, dtype, seed=H * D)
    Q, K, V, E1 = (t.detach() for t in qkve)
    out, den = attn_mod._launch_fwd(Q, K, V, E1, gb.senders, gb.edge_mask,
                                    *_args(gb)[3:], gb.extras["dst_ptr"], bn)
    ref = ops.edge_softmax_attention_plain(Q, K, V, E1, *_args(gb), bn)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                               atol=1e-5 if dtype == torch.float32 else 1e-3)
    ghat = g / (den[:, :, None] + 1e-6)
    c = (out.float() * ghat).sum(-1)
    got = attn_mod._launch_bwd(Q, K, V, E1, ghat, c, *_args(gb),
                               batch_csr(gb), bn)
    want = attn_mod.edge_attention_bwd_plain(Q, K, V, E1, ghat, c,
                                             *_args(gb), bn)
    torch.cuda.synchronize()
    for name, a, b in zip(("dQ", "dK", "dV", "dE1"), got, want):
        torch.testing.assert_close(a, b, msg=name, **_grad_tol(b))
    if dtype == torch.float32:
        tiled = lambda *a: ops.edge_softmax_attention_tiled(
            *a, csr=batch_csr(gb))
        got = _attn_run(tiled, gb, qkve, g, bn)
        want = _attn_run(ops.edge_softmax_attention_plain, gb, qkve, g, bn)
        for name, a, b in zip(("out", "dQ", "dK", "dV", "dE1"), got, want):
            torch.testing.assert_close(a, b, msg=name, **_grad_tol(b))


def test_attention_counters_and_nonlocal_edges(cuda):
    """One K2 launch per forward and one K3 launch per backward; an edge
    whose source lies in another tile is dropped by the kernels as by the
    plain version."""
    gb = _batch().to(cuda)
    bn = gb.num_nodes // gb.extras["tile_starts"].shape[0]
    args, csr = _far_batch(gb, bn)
    qkve, c = _attn_inputs(gb, 8, 8, torch.float32, seed=1)
    f = ops.edge_softmax_attention_tiled
    before = (f.launches_fwd, f.launches_bwd)
    out = f(*qkve, *args, bn, csr)
    (out * c).sum().backward()
    assert (f.launches_fwd, f.launches_bwd) == (before[0] + 1, before[1] + 1)
    got = [out] + [t.grad for t in qkve]
    for t in qkve:
        t.grad = None
    ref = ops.edge_softmax_attention_plain(*qkve, *args, bn)
    (ref * c).sum().backward()
    for name, a, b in zip(("out", "dQ", "dK", "dV", "dE1"), got,
                          [ref] + [t.grad for t in qkve]):
        torch.testing.assert_close(a, b, msg=name, **_grad_tol(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,D,far,aligned", [
    (8, 8, False, True), (8, 8, True, True), (8, 8, False, False),
    (8, 10, False, True), (8, 10, True, True), (4, 4, False, True)])
def test_attention_bwd_writes_every_de1_slot(cuda, dtype, H, D, far,
                                             aligned):
    """K3 allocates dE1 without zeroing it: every slot must hold the plain
    version's value (zeros where no edge counts), whatever the memory held
    before, in the vector layout (D = 8, 4) and the general one (D = 10, or
    D = 8 with E1 off its alignment), on the batch and on the one with
    non-tile-local edges."""
    gb = _batch().to(cuda)
    bn = gb.num_nodes // gb.extras["tile_starts"].shape[0]
    args, csr = _far_batch(gb, bn) if far else (_args(gb), batch_csr(gb))
    qkve, g = _attn_inputs(gb, H, D, dtype, seed=H * D + far)
    Q, K, V, E1 = (t.detach() for t in qkve)
    if not aligned:  # the same values one element past an alignment
        buf = torch.empty(E1.numel() + 1, dtype=dtype, device=cuda)
        E1 = buf[1:].view(E1.shape).copy_(E1)
    layout = attn_mod.bwd_variant(
        H, D, aligned and E1.data_ptr() % (4 * E1.element_size()) == 0)
    assert layout == int(D % 4 == 0 and aligned)
    out, den = attn_mod._launch_fwd(Q, K, V, E1, args[0], args[2],
                                    *args[3:], csr[0], bn)
    ghat = g / (den[:, :, None] + 1e-6)
    c = (out.float() * ghat).sum(-1)
    torch.full(E1.shape, float("nan"), device=cuda)  # freed, left to dE1
    got = attn_mod._launch_bwd(Q, K, V, E1, ghat, c, *args, csr, bn)
    want = attn_mod.edge_attention_bwd_plain(Q, K, V, E1, ghat, c, *args,
                                             bn)
    torch.cuda.synchronize()
    counted = spmm_mod._tile_mask(*args[:2], *args[3:], bn) & (args[2] != 0)
    assert bool((got[3][~counted] == 0).all())
    for name, a, b in zip(("dQ", "dK", "dV", "dE1"), got, want):
        torch.testing.assert_close(a, b, msg=name, **_grad_tol(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,D,far,aligned", [
    (8, 8, False, True), (8, 8, True, True), (8, 8, False, False),
    (8, 10, False, True), (8, 10, True, True), (8, 7, False, True),
    (8, 7, True, True), (4, 4, False, True)])
def test_attention_fwd_writes_every_row(cuda, dtype, H, D, far, aligned):
    """K2 allocates out and den without filling them: every row must hold
    the plain version's value (out 0 and den 0 where no edge counts),
    whatever the memory held before, in the vector layout (D = 8, 4) and
    the general one (D = 10, 7, or D = 8 with E1 off its alignment), on the
    batch and on the one with non-tile-local edges."""
    gb = _batch().to(cuda)
    bn = gb.num_nodes // gb.extras["tile_starts"].shape[0]
    args, csr = _far_batch(gb, bn) if far else (_args(gb), batch_csr(gb))
    qkve, _ = _attn_inputs(gb, H, D, dtype, seed=H * D + 2 * far)
    Q, K, V, E1 = (t.detach() for t in qkve)
    if not aligned:
        E1 = _off_alignment(E1)
    layout = attn_mod.bwd_variant(
        H, D, E1.data_ptr() % (4 * E1.element_size()) == 0)
    assert layout == int(D % 4 == 0 and aligned)
    with nan_filled_empty():
        out, den = attn_mod._launch_fwd(Q, K, V, E1, args[0], args[2],
                                        *args[3:], csr[0], bn)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())
    assert bool(torch.isfinite(den).all())
    ref = ops.edge_softmax_attention_plain(Q, K, V, E1, *args, bn)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-3))
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(den, ops.edge_softmax_den_plain(Q, K, E1, *args,
                                                               bn),
                               rtol=1e-5, atol=1e-5)


def test_transformer_train_step_on_card_counts_attention_launches(cuda):
    """TransformerNet under tile_dense: one K2 per layer per forward, one K3
    per layer per backward, no K1."""
    gb = _batch(n_graphs=40).to(cuda)
    model = gnn_model("Transformer", hidden_dim=32, out_dim=32, n_layers=3,
                      num_heads=4, layer_norm=True, pos_enc_dim=8,
                      lap_method="sign_inv", sign_inv_layers=2,
                      phi_out_dim=4, pe_aggregate="concat").to(cuda)
    step, ev = build_steps(model, make_zinc_predict(model, "sign_inv"),
                           adam(model.parameters()))
    f = ops.edge_softmax_attention_tiled
    seg.set_agg_backend("tile_dense")
    try:
        k1 = ops.spmm_tiled.launches
        fwd, bwd = f.launches_fwd, f.launches_bwd
        loss = step(gb, 1e-3)["loss"]
        assert (f.launches_fwd - fwd, f.launches_bwd - bwd) == (3, 3)
        ev(gb)
        assert (f.launches_fwd - fwd, f.launches_bwd - bwd) == (6, 3)
        assert ops.spmm_tiled.launches == k1
    finally:
        seg.set_agg_backend("xla")
    assert torch.isfinite(loss)


def _gate_inputs(gb, F, dtype, seed):
    g = torch.Generator(device=gb.senders.device).manual_seed(seed)
    n, e = gb.num_nodes, gb.num_edges
    mk = lambda rows: torch.randn(rows, F, device=gb.senders.device,
                                  generator=g)
    return [mk(n).to(dtype), mk(n).to(dtype), mk(n).to(dtype),
            mk(e).to(dtype)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [68, 77, 70])
def test_gate_kernel_matches_plain(cuda, dtype, F):
    """K4's agg and e_new at every row and edge slot, the weight-0 padding
    edges on the last node included."""
    gb = _batch().to(cuda)
    bn = gb.num_nodes // gb.extras["tile_starts"].shape[0]
    feats = _gate_inputs(gb, F, dtype, seed=F)
    got = gate_mod._launch(*feats, *_args(gb), gb.extras["dst_ptr"], bn)
    want = ops.gatedgcn_gate_plain(*feats, *_args(gb), bn)
    torch.cuda.synchronize()
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-3))
    for name, a, b in zip(("agg", "e_new"), got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), msg=name, **tol)


def test_gate_autograd_counter_and_nonlocal_edges(cuda):
    """One K4 launch per forward and none in the backward (the plain VJP);
    an in-range edge whose source lies in another tile counts fully, in
    the kernel as in the plain version and the reference."""
    gb = _batch().to(cuda)
    bn = gb.num_nodes // gb.extras["tile_starts"].shape[0]
    s_far = gb.senders.clone()
    real = torch.nonzero(gb.edge_mask > 0)[:, 0]
    pick = real[::17]
    s_far[pick] = (s_far[pick] + bn) % gb.num_nodes
    args = (s_far,) + _args(gb)[1:]
    csr = edge_csr(s_far, gb.receivers, gb.num_nodes)
    feats = [t.requires_grad_(True)
             for t in _gate_inputs(gb, 68, torch.float32, seed=1)]
    g = torch.Generator(device=cuda).manual_seed(2)
    c1 = torch.randn(gb.num_nodes, 68, device=cuda, generator=g)
    c2 = torch.randn(gb.num_edges, 68, device=cuda, generator=g)

    def run(fn):
        agg, e_new = fn(*feats)
        ((agg * c1).sum() + (e_new * c2).sum()).backward()
        out = [agg, e_new] + [t.grad for t in feats]
        for t in feats:
            t.grad = None
        return out

    f = ops.gatedgcn_gate_tiled
    before = f.launches
    got = run(lambda *a: f(*a, *args, gb.num_nodes, bn, csr))
    assert f.launches == before + 1
    want = run(lambda *a: ops.gatedgcn_gate_plain(*a, *args, bn))
    for name, a, b in zip(("agg", "e_new", "dBh", "dDh", "dEh", "dCe"), got,
                          want):
        torch.testing.assert_close(a, b, msg=name, **_grad_tol(b))
    ref = ops.gatedgcn_gate_reference(*(t.detach() for t in feats),
                                      *args[:3], gb.num_nodes)
    for name, a, b in zip(("agg", "e_new"), got, ref):
        torch.testing.assert_close(a, b, msg=name, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F,far", [
    (68, False), (68, True), (70, False), (70, True), (77, False),
    (16, False), (128, False), (128, True)])
def test_gate_writes_every_row_and_slot(cuda, dtype, F, far):
    """K4 allocates agg and e_new without filling them: every row and slot
    must hold the plain version's value (the weight-0 padding slots their
    e_new), whatever the memory held before, in one pass of a warp's lanes
    over the row (F = 68, 70, 77, 16) and in two (F = 128), on the batch
    and on the one with non-tile-local edges (counted fully)."""
    gb = _batch().to(cuda)
    bn = gb.num_nodes // gb.extras["tile_starts"].shape[0]
    args, csr = _far_batch(gb, bn) if far else (_args(gb), batch_csr(gb))
    feats = _gate_inputs(gb, F, dtype, seed=F + far)
    with nan_filled_empty():
        got = gate_mod._launch(*feats, *args, csr[0], bn)
    want = ops.gatedgcn_gate_plain(*feats, *args, bn)
    torch.cuda.synchronize()
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-3))
    for name, a, b in zip(("agg", "e_new"), got, want):
        assert a.dtype == dtype and bool(torch.isfinite(a.float()).all())
        torch.testing.assert_close(a.float(), b.float(), msg=name, **tol)


def test_gatedgcn_train_step_on_card_counts_gate_launches(cuda):
    """GatedGCNNet under pallas_tile: one K4 per layer per forward and none
    in the backward; the phi's K1, one per layer forward and one per layer
    but the first backward."""
    gb = _batch(n_graphs=40).to(cuda)
    model = gnn_model("GatedGCN", hidden_dim=32, out_dim=32, n_layers=3,
                      pos_enc_dim=8, lap_method="sign_inv",
                      sign_inv_layers=2, phi_out_dim=4,
                      pe_aggregate="concat").to(cuda)
    step, ev = build_steps(model, make_zinc_predict(model, "sign_inv"),
                           adam(model.parameters()))
    f = ops.gatedgcn_gate_tiled
    seg.set_agg_backend("pallas_tile")
    try:
        k1, k4 = ops.spmm_tiled.launches, f.launches
        loss = step(gb, 1e-3)["loss"]
        assert (f.launches - k4, ops.spmm_tiled.launches - k1) == (3, 3)
        ev(gb)
        assert (f.launches - k4, ops.spmm_tiled.launches - k1) == (6, 5)
    finally:
        seg.set_agg_backend("xla")
    assert torch.isfinite(loss)


def _flat_problem(cuda, n, d, dtype, seed=0):
    """bench_ops' flat SpMM problem (6912 edges, sources anywhere, 90 % of
    weight 1, padded to 1024, 256-node tile ranges) on the card."""
    p = bench_ops.flat_problem(n, d=d, seed=seed)
    args = [torch.from_numpy(p[k]).to(cuda)
            for k in ("sp", "rp", "wp", "st", "en")]
    return torch.from_numpy(p["x"]).to(cuda, dtype), args


# bench_ops' shape, D = 95 (one element a load), N = 300 (not a multiple
# of 256); rows in two passes (D = 256 f32, 130, 512 bf16) and rows of 16
# lanes (D = 64, 33; bf16 D = 128): every instance the picker can choose
# (tests/test_torch_spmm_flat.py holds them to that on the CPU)
FLAT_SHAPES = [(3072, 128), (3072, 95), (300, 128), (3072, 256), (300, 130),
               (300, 512), (3072, 64), (3072, 33)]


@pytest.mark.parametrize("n,d", FLAT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_kernel_matches_plain(cuda, n, d, dtype):
    """K5 at every shape of FLAT_SHAPES over NaN-filled output memory: every
    row, f32 within 1e-5, bf16 within one bf16 rounding of the same f32 sum
    (2**-7 relative)."""
    x, args = _flat_problem(cuda, n, d, dtype)
    with nan_filled_empty():
        got = ops.spmm_flat(x, *args, n)
    want = ops.spmm_flat_plain(x, *args, n)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (n, d)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flat_kernel_confines_a_nonfinite_row_and_counts_launches(cuda):
    """x[0] = inf, read by counted edges and by the weight-0 padding edges:
    only the counted edges' destination rows may be non-finite.  One launch
    per call on the card; forward only."""
    n = 3072
    x, args = _flat_problem(cuda, n, 128, torch.float32, seed=1)
    s, r, w = args[:3]
    x[0] = float("inf")
    counted = (s == 0) & (w != 0)
    hit = torch.zeros(n, dtype=torch.bool, device=cuda)
    hit[r[counted].long()] = True
    assert bool(((s == 0) & (w == 0)).any()) and not bool(hit[r[-1]])
    before = ops.spmm_flat.launches
    got = ops.spmm_flat(x, *args, n)
    assert ops.spmm_flat.launches == before + 1
    bad = ~torch.isfinite(got).all(1)
    assert torch.equal(bad, hit)
    want = ops.spmm_flat_plain(x, *args, n)
    torch.testing.assert_close(got[~hit], want[~hit], rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError):
        ops.spmm_flat(x.requires_grad_(True), *args, n)
    assert ops.spmm_flat.launches == before + 1


def _flat_case(cuda, case, d, dtype):
    """bench_ops' flat problem with its ranges narrowed (in-range and
    out-of-range edges share rows), with tile 3's range emptied, with x one
    element off its alignment, or (`boundary`) 600 nodes with runs of 3000
    and 2000 edges on rows 255 and 256 and tile 0's range reaching 700
    slots into row 256's run: (x, args, n)."""
    if case == "boundary":
        n = 600
        g = torch.Generator().manual_seed(7)
        r = torch.cat([torch.randint(0, n, (3000,), generator=g),
                       torch.full((3000,), 255), torch.full((2000,), 256)])
        r = r.sort().values.int().numpy()
        e = len(r)
        w = ((torch.rand(e, generator=g) + 0.5)
             * (torch.rand(e, generator=g) < 0.8)).numpy()
        s = torch.randint(0, n, (e,), generator=g).int().numpy()
        s, r, w = ops.pad_edges_to(s, r, w, 1024)
        st, en = ops.tile_edge_ranges(r, n, 256)
        en = en.copy()
        en[0] += 700
        args = [torch.from_numpy(a).to(cuda) for a in (s, r, w, st, en)]
        x = torch.randn(n, d, generator=g).to(cuda, dtype)
        return x, args, n
    n = 3072
    x, args = _flat_problem(cuda, n, d, dtype, seed=2)
    if case == "narrowed":
        st = args[3] + 5
        args = args[:3] + [st, torch.maximum(args[4] - 7, st)]
    elif case == "empty_tile":
        en = args[4].clone()
        en[3] = args[3][3]
        args = args[:4] + [en]
    elif case == "unaligned":
        x = _off_alignment(x)
    return x, args, n


@pytest.mark.parametrize("case", ["narrowed", "empty_tile", "boundary",
                                  "unaligned"])
@pytest.mark.parametrize("d", [128, 95])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_kernel_writes_every_row(cuda, case, d, dtype):
    """Every row over NaN-filled output memory, rows with no counted edge
    zeros: f32 within 1e-5, bf16 within one bf16 rounding.  The boundary
    case's rows of up to 2400 counted edges are f32 sums taken in another
    order than the plain version's: 1e-5 of the sum of their terms'
    magnitudes more (a missing or doubled edge moves a row by a whole
    term)."""
    x, args, n = _flat_case(cuda, case, d, dtype)
    with nan_filled_empty():
        got = ops.spmm_flat(x, *args, n)
    want = ops.spmm_flat_plain(x, *args, n).float()
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (n, d)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    bar = tol + tol * want.abs()
    if case == "boundary":
        bar += 1e-5 * ops.spmm_flat_plain(x.float().abs(), args[0], args[1],
                                          args[2].abs(), *args[3:], n)
    err = (got.float() - want).abs()
    assert bool((err <= bar).all()), float(err.max())
    if case == "empty_tile":
        assert not bool(got[3 * 256:4 * 256].any())


def test_flat_call_is_one_device_kernel(cuda):
    """One spmm_flat call on the card is one device kernel, the K5 kernel:
    no CSR pointers are made for it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x, args = _flat_problem(cuda, 3072, 128, torch.float32)
    ops.spmm_flat(x, *args, 3072)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            ops.spmm_flat(x, *args, 3072)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    assert len(kernels) == 1 and sum(kernels.values()) == 5, kernels
    assert "spmm_flat_kernel" in next(iter(kernels))


# ---------------------------------------------------------------------------
# the train step captured in a CUDA graph (training.capture_train_step)

# path -> (net, aggregation backend, kernel names the profiler shows and
# their launches per train step at n_layers 3, sign_inv_layers 2)
CAPTURE_PATHS = {
    "GIN": (dict(hidden_dim=16, out_dim=16, n_layers=3),
            "pallas_tile", {"spmm_tiled_kernel": 2 * 5 - 1}),
    "Transformer": (dict(hidden_dim=32, out_dim=32, n_layers=3, num_heads=4,
                         layer_norm=True),
                    "tile_dense", {"attn_fwd": 3, "attn_bwd": 3}),
    "GatedGCN": (dict(hidden_dim=32, out_dim=32, n_layers=3),
                 "pallas_tile", {"gate_kernel": 3,
                                 "spmm_tiled_kernel": 2 * 2 - 1}),
}
# the same launches by the wrappers' counters (bench_ops.launch_counts)
CAPTURE_COUNTERS = {
    "GIN": {"spmm_tiled": 9},
    "Transformer": {"edge_attention_fwd": 3, "edge_attention_bwd": 3},
    "GatedGCN": {"gatedgcn_gate_fwd": 3, "spmm_tiled": 3},
}
SIGNNET = dict(pos_enc_dim=8, lap_method="sign_inv", sign_inv_layers=2,
               phi_out_dim=4, pe_aggregate="concat")


def _two_batches(cuda, n_graphs=40, tile=256):
    """Two batches packed to one set of budgets, on the card."""
    gs = synthetic_zinc(2 * n_graphs, 0, 0, seed=5)["train"]
    add_lap_pe(gs, 8)
    nb, eb, gc = choose_budgets(gs, n_graphs, tile=tile)
    return [from_arrays(a).to(cuda)
            for a in pack_batches(gs, nb, eb, gc, k=8, tile=tile)[:2]]


def _capture_pair(name, cuda, gbs, eager_runs=1, **extra):
    """(eager steps, captured step, models, optimizers) from one init, all
    with the capturable Adam, so that the eager and the captured steps
    differ only in the capture: `eager_runs` eager models, then the
    captured one (last in models and optimizers)."""
    from signnet_basisnet_tpu_torch.training import capture_train_step
    net = dict(CAPTURE_PATHS[name][0], **SIGNNET, **extra)
    models = [gnn_model(name, **net).to(cuda) for _ in range(eager_runs + 1)]
    opts = [adam(m.parameters(), capturable=True) for m in models]
    eager = [build_steps(m, make_zinc_predict(m, "sign_inv"), o)[0]
             for m, o in zip(models[:-1], opts[:-1])]
    captured = capture_train_step(
        models[-1], make_zinc_predict(models[-1], "sign_inv"), opts[-1],
        gbs[0])
    return eager, captured, models, opts


def _state(model, opt):
    out = {n: t.detach().clone() for n, t in
           list(model.named_parameters()) + list(model.named_buffers())}
    for i, p in enumerate(model.parameters()):
        for k, v in opt.state.get(p, {}).items():
            out[f"adam.{i}.{k}"] = v.detach().clone()
    return out


@pytest.mark.parametrize("name", list(CAPTURE_PATHS))
def test_captured_step_matches_eager(cuda, name):
    """4 steps over 2 batches.  The eager step is not bitwise repeatable
    (index_add_'s atomics in the readout sum in any order), and Adam turns
    that rounding into steps of up to the LR where a gradient is zero in
    exact arithmetic or a ReLU sits at its kink.  So the captured step is
    held to the eager one within 1e-5 relative (loss) and 1e-5 + 1e-4
    relative (every parameter, BN statistic and Adam state) plus twice
    the spread between two eager runs from the same init, all with
    deterministic algorithms (index_add_ as a sorted index_put_), so the
    spread is expected to be 0."""
    gbs = _two_batches(cuda)
    seg.set_agg_backend(CAPTURE_PATHS[name][1])
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        eager, captured, models, opts = _capture_pair(name, cuda, gbs,
                                                      eager_runs=2)
        for m0, m1 in zip(models[0].state_dict().values(),
                          models[-1].state_dict().values()):
            assert torch.equal(m0, m1)  # the warm-up was undone
        losses = [[], [], []]
        for i in range(4):
            for run, step in zip(losses, eager + [captured]):
                run.append(float(step(gbs[i % 2], 1e-3)["loss"]))
    finally:
        torch.use_deterministic_algorithms(False)
        seg.set_agg_backend("xla")
    le, la, lc = (torch.tensor(v, dtype=torch.float64) for v in losses)
    assert bool(((lc - le).abs() <= 1e-5 * le.abs()
                 + 2 * (la - le).abs()).all()), (le, la, lc)
    se, sa, sc = (_state(m, o) for m, o in zip(models, opts))
    assert se.keys() == sc.keys()
    for k in se:
        bar = 1e-5 + 1e-4 * se[k].abs() + 2 * (sa[k] - se[k]).abs().max()
        err = (sc[k] - se[k]).abs()
        assert bool((err <= bar).all()), (k, float(err.max()),
                                          float((sa[k] - se[k]).abs().max()))


@pytest.mark.parametrize("name", list(CAPTURE_PATHS))
def test_captured_replay_launches_what_the_eager_step_launches(cuda, name):
    from signnet_basisnet_tpu_torch.utils.profiling import (
        device_kernel_counts)
    gbs = _two_batches(cuda)
    kernels = CAPTURE_PATHS[name][2]
    seg.set_agg_backend(CAPTURE_PATHS[name][1])
    try:
        (eager,), captured, _, _ = _capture_pair(name, cuda, gbs)
        before = bench_ops.launch_counts()
        eager(gbs[1], 1e-3)
        after = bench_ops.launch_counts()
        cc = device_kernel_counts(lambda: captured(gbs[1], 1e-3), kernels)
    finally:
        seg.set_agg_backend("xla")
    ce = {k: after[k] - before[k] for k in after}
    for k, n in kernels.items():
        assert cc[k] == n, (k, cc)
    assert {k: v for k, v in ce.items() if v} == CAPTURE_COUNTERS[name]


def test_capturable_adam_round_trips_through_a_checkpoint(cuda, tmp_path):
    """A capturable optimizer's state (its step and LR on the card) saved
    by training/checkpoint.py loads into a fresh model and optimizer, and
    the step captured after the restore continues as the saved one."""
    from signnet_basisnet_tpu_torch.training import (Checkpointer,
                                                     capture_train_step,
                                                     load_train_state,
                                                     train_state)
    gbs = _two_batches(cuda)
    seg.set_agg_backend("pallas_tile")
    try:
        _, captured, models, opts = _capture_pair("GIN", cuda, gbs)
        for i in range(2):
            captured(gbs[i], 1e-3)
        ck = Checkpointer(str(tmp_path))
        ck.save(1, train_state(models[1], opts[1], 5e-4, 1))
        assert opts[1].state[next(models[1].parameters())]["step"].is_cuda
        net = dict(CAPTURE_PATHS["GIN"][0], **SIGNNET, seed=9)
        m2 = gnn_model("GIN", **net).to(cuda)
        o2 = adam(m2.parameters(), capturable=True)
        lr_tensor = o2.param_groups[0]["lr"]
        assert load_train_state(m2, o2, ck.restore()) == 5e-4
        assert o2.param_groups[0]["lr"] is lr_tensor
        assert float(lr_tensor) == pytest.approx(5e-4, rel=1e-7)
        step2 = capture_train_step(m2, make_zinc_predict(m2, "sign_inv"),
                                   o2, gbs[0])
        a = float(captured(gbs[0], 5e-4)["loss"])
        b = float(step2(gbs[0], 5e-4)["loss"])
    finally:
        seg.set_agg_backend("xla")
    assert a == pytest.approx(b, rel=1e-6)
    for t1, t2 in zip(models[1].state_dict().values(),
                      m2.state_dict().values()):
        torch.testing.assert_close(t2, t1, rtol=1e-5, atol=1e-6)


def test_captured_step_draws_a_fresh_dropout_mask_each_replay(cuda):
    gbs = _two_batches(cuda)
    seg.set_agg_backend("pallas_tile")
    try:
        _, captured, models, _ = _capture_pair("GIN", cuda, gbs,
                                               dropout=0.5)
        # at LR 0 the parameters stay; only the masks change the loss
        losses = [float(captured(gbs[0], 0.0)["loss"]) for _ in range(3)]
    finally:
        seg.set_agg_backend("xla")
    assert len(set(losses)) == 3, losses
    assert models[1].dropout_rng.generator.device.type == "cuda"


def test_captured_step_draws_fresh_sign_flips_each_replay(cuda):
    """The GatedGCN LapPE net under sign_flip (configs/gatedgcn_zinc_lappe
    .json's PE, k = 16, through K4): the train flip generator is
    registered with the graph, so each replay draws its own flips; at LR 0
    only the flips change the loss."""
    from signnet_basisnet_tpu_torch.training import capture_train_step
    gs = synthetic_zinc(80, 0, 0, seed=5)["train"]
    add_lap_pe(gs, 16)
    nb, eb, gc = choose_budgets(gs, 40, tile=256)
    gb = from_arrays(pack_batches(gs, nb, eb, gc, k=16, tile=256)[0]).to(
        cuda)
    model = gnn_model("GatedGCN", hidden_dim=32, out_dim=32, n_layers=2,
                      pos_enc_dim=16, lap_method="sign_flip").to(cuda)
    seg.set_agg_backend("pallas_tile")
    try:
        captured = capture_train_step(
            model, make_zinc_predict(model, "sign_flip"),
            adam(model.parameters(), capturable=True), gb)
        losses = [float(captured(gb, 0.0)["loss"]) for _ in range(3)]
    finally:
        seg.set_agg_backend("xla")
    assert len(set(losses)) == 3, losses
    assert model.flip_rng.generator.device.type == "cuda"


def _alchemy_gine_batch(cuda, which):
    """An untiled all-n eigenvector batch, as train_alchemy (40 synthetic
    Alchemy graphs) and train_zinc_gine (40 synthetic ZINC graphs) pack
    them."""
    from signnet_basisnet_tpu_torch.data import (add_full_evd,
                                                 synthetic_alchemy)
    gs = (synthetic_alchemy(40, 0, 0, seed=2) if which == "alchemy"
          else synthetic_zinc(40, 0, 0, seed=2))["train"]
    add_full_evd(gs, normalization=None)
    nb, eb, gc = choose_budgets(gs, 40)
    return from_arrays(pack_batches(gs, nb, eb, gc)[0]).to(cuda)


ALCHEMY_GINE_NETS = {
    "alchemy": dict(n_hid=108, n_out=12, nl_signnet=8, nl_gnn=16, nl_rho=8,
                    node_vocab=10, edge_vocab=10, node_code_dims=6),
    "gine_zinc": dict(n_hid=110, n_out=1, nl_signnet=8, nl_gnn=6, nl_rho=1,
                      ignore_eigval=True, node_vocab=28, edge_vocab=4),
}


@pytest.mark.parametrize("phi", ["MaskedGINConv", "MaskedGINEConv"])
@pytest.mark.parametrize("which", ["alchemy", "gine_zinc"])
def test_alchemy_and_gine_steps_launch_no_kernel(cuda, which, phi):
    """The two trainers' nets at published widths on the card: a finite
    train and eval step, and no K1-K5 launch (untiled batches: the phi's
    aggregation is the flat gather + index_add_)."""
    from signnet_basisnet_tpu_torch.models import SignNetGNN
    from signnet_basisnet_tpu_torch.training import make_module_predict
    gb = _alchemy_gine_batch(cuda, which)
    model = SignNetGNN(phi_gnn_type=phi, **ALCHEMY_GINE_NETS[which]).to(cuda)
    train, evaluate = build_steps(model, make_module_predict(model),
                                  adam(model.parameters()))
    counters = (spmm_mod.spmm_tiled, attn_mod.edge_softmax_attention_tiled,
                gate_mod.gatedgcn_gate_tiled, ops.spmm_flat)
    before = [(getattr(f, "launches", 0), getattr(f, "launches_fwd", 0),
               getattr(f, "launches_bwd", 0)) for f in counters]
    loss = float(train(gb, 1e-3)["loss"])
    out = evaluate(gb)
    torch.cuda.synchronize()
    after = [(getattr(f, "launches", 0), getattr(f, "launches_fwd", 0),
              getattr(f, "launches_bwd", 0)) for f in counters]
    assert before == after
    assert torch.isfinite(torch.tensor(loss)) and torch.isfinite(
        out["mae_sum"]).item()


def test_attention_dropout_draws_a_fresh_mask_each_step(cuda):
    """The set transformer's attention dropout (0.1) on the card draws
    from the net's `dropout_rng`, made there: at LR 0 only its masks change
    the train loss from step to step; a captured step registers it, so
    each replay draws its own."""
    from signnet_basisnet_tpu_torch.models import SignNetGNN
    from signnet_basisnet_tpu_torch.training import (capture_train_step,
                                                     make_module_predict)
    gb = _alchemy_gine_batch(cuda, "alchemy")
    net = dict(ALCHEMY_GINE_NETS["alchemy"], n_hid=32, nl_signnet=2,
               nl_gnn=2, nl_rho=2)
    model = SignNetGNN(**net).to(cuda)
    train, _ = build_steps(model, make_module_predict(model),
                           adam(model.parameters()))
    eager = [float(train(gb, 0.0)["loss"]) for _ in range(3)]
    assert len(set(eager)) == 3, eager
    assert model.dropout_rng.generator.device.type == "cuda"
    m2 = SignNetGNN(**net).to(cuda)
    captured = capture_train_step(m2, make_module_predict(m2),
                                  adam(m2.parameters(), capturable=True), gb)
    replays = [float(captured(gb, 0.0)["loss"]) for _ in range(3)]
    assert len(set(replays)) == 3, replays


# ------------------------------------------------- LearningFilters (no kernel)

def _grid_mat(path, side=12, images=3, seed=0):
    """A side x side grid .mat in the 2Dgrid.mat layout (A, F, mask)."""
    import numpy as np
    import scipy.io as sio
    n = side * side
    A = np.zeros((n, n), np.uint8)
    for i in range(side):
        for j in range(side):
            u = i * side + j
            if j + 1 < side:
                A[u, u + 1] = A[u + 1, u] = 1
            if i + 1 < side:
                A[u, u + side] = A[u + side, u] = 1
    mask = np.ones((n, 1), np.uint8)
    mask[:3] = 0
    sio.savemat(path, dict(A=A, F=np.random.default_rng(seed).random(
        (n, images)), mask=mask))
    return str(path)


FILTER_ROWS = {
    "basis_inv": ["--net", "DS", "--use_eig", "--lap_method", "basis_inv",
                  "--ign_hidden", "16", "--hidden_channels", "16"],
    "sign_inv_ds": ["--net", "Transformer", "--use_eig", "--lap_method",
                    "sign_inv", "--hidden_channels", "16"],
    "bernnet": ["--net", "BernNet"],
    "gatnet_flip": ["--net", "GatNet", "--use_eig", "--lap_method",
                    "sign_flip", "--k", "8"],
}


def _kernel_counts():
    return [(getattr(f, "launches", 0), getattr(f, "launches_fwd", 0),
             getattr(f, "launches_bwd", 0)) for f in (
        spmm_mod.spmm_tiled, attn_mod.edge_softmax_attention_tiled,
        gate_mod.gatedgcn_gate_tiled, ops.spmm_flat)]


def _stacked_vs_serial_f64(tf, args, device, steps=4):
    """`train_filters.stacked_trainer` against the serial `train_step`, in
    f64 from the same seeds: the largest relative gap of the per-step
    losses."""
    import numpy as np
    p = tf.prepare(args, lambda m: None, device, torch.float64)
    seeds = [args.seed * 100003 + i for i in p.img_ids]
    xs = torch.stack([p.x[:, i:i + 1] for i in p.img_ids])
    ys = torch.stack([p.y[:, i:i + 1] for i in p.img_ids])
    serial = []
    for i, seed in enumerate(seeds):
        model = p.make_model(seed)
        opt = adam(model.parameters())
        opt.param_groups[0]["lr"] = args.lr
        serial.append([float(tf.train_step(model, opt, p.gb, xs[i], ys[i],
                                           p.mask, p.kwargs)[0])
                       for _ in range(steps)])
    step, _ = tf.stacked_trainer([p.make_model(s) for s in seeds], p,
                                 args.lr)
    stacked = np.array([step(xs, ys)[0].cpu().numpy()
                        for _ in range(steps)]).T
    serial = np.array(serial)
    return float(np.max(np.abs(stacked - serial) / np.abs(serial)))


@pytest.mark.parametrize("row", list(FILTER_ROWS))
def test_filter_step_on_the_card_matches_the_cpu(cuda, tmp_path, row):
    """One `train_filters` train step on a 12x12 grid from the same seed,
    on the card and on the CPU in f64 under deterministic algorithms
    (index_add_'s atomics otherwise sum in any order): the loss, r2 and
    every gradient within 1e-9 of the CPU's (relative to the tensor's
    largest); in f32 the loss within 1e-4 relative.  Sign flips are drawn
    once on the CPU and passed to both.  No K1-K5 launch."""
    from signnet_basisnet_tpu_torch import train_filters as tf
    args = tf.build_parser().parse_args(FILTER_ROWS[row] + [
        "--mat_path", _grid_mat(tmp_path / "grid.mat"), "--label_dir",
        str(tmp_path), "--results_dir", ""])
    flips = None
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for dev in ("cuda", "cpu"):
            for dt in (torch.float64, torch.float32):
                p = tf.prepare(args, lambda m: None, torch.device(dev), dt)
                model = p.make_model(0)
                kw = dict(p.kwargs)
                if row == "gatnet_flip":
                    if flips is None:
                        flips = model.draw_flips(8, torch.device("cpu"))
                    kw["flips"] = flips.to(dev)
                before = _kernel_counts()
                loss, r2 = tf.train_step(
                    model, adam(model.parameters()), p.gb, p.x[:, :1],
                    p.y[:, :1], p.mask, kw)
                torch.cuda.synchronize()
                assert _kernel_counts() == before
                runs[dev, dt] = (float(loss), float(r2), {
                    n: t.grad.detach().cpu().double()
                    for n, t in model.named_parameters()
                    if t.grad is not None})
    finally:
        torch.use_deterministic_algorithms(False)
    card, cpu = runs["cuda", torch.float64], runs["cpu", torch.float64]
    assert abs(card[0] - cpu[0]) <= 1e-9 * abs(cpu[0])
    assert abs(card[1] - cpu[1]) <= 1e-9
    assert card[2].keys() == cpu[2].keys()
    top = max(float(g.abs().max()) for g in cpu[2].values())
    for n, g in cpu[2].items():
        assert float((card[2][n] - g).abs().max()) <= 1e-9 * max(
            float(g.abs().max()), 1e-4 * top), n
    f32 = runs["cuda", torch.float32][0], runs["cpu", torch.float32][0]
    assert abs(f32[0] - f32[1]) <= 1e-4 * abs(f32[1]), f32


def test_train_filters_runs_on_the_card_without_kernels(cuda, tmp_path):
    """On the card (12x12 grid, lr 1e-3), for the BasisNet and the
    SignNet-MLP (k = 8) rows: the vmapped trainer against the serial steps
    in f64 over 4 steps of 2 images, losses within 1e-6 relative; then
    `train_filters.run` in f32 over 3 images, serially and vmapped in
    chunks of 2 (one partial): finite, the initial losses (1 epoch) within
    1e-4 relative, no K1-K5 launch.  (After a few f32 epochs the two runs
    part by more than f32 rounding: Adam moves the weights whose exact
    gradient is 0 by +-lr on their rounding noise, which each summation
    order draws anew.)"""
    import numpy as np
    from signnet_basisnet_tpu_torch import train_filters as tf
    common = ["--mat_path", _grid_mat(tmp_path / "grid.mat"), "--label_dir",
              str(tmp_path), "--results_dir", "", "--lr", "1e-3"]
    mlp = ["--net", "MLP", "--use_eig", "--lap_method", "sign_inv",
           "--sign_inv_net", "MLP", "--k", "8"]
    before = _kernel_counts()
    for argv in (FILTER_ROWS["basis_inv"], mlp):
        assert _stacked_vs_serial_f64(tf, tf.build_parser().parse_args(
            argv + common + ["--img_num", "2"]), cuda) <= 1e-6
        out = {}
        for epochs, vm in (("1", "1"), ("1", "2"), ("4", "2")):
            out[epochs, vm] = tf.run(tf.build_parser().parse_args(
                argv + common + ["--img_num", "3", "--epochs", epochs,
                                 "--scan_epochs", epochs, "--vmap_images",
                                 vm]), log=lambda m: None)
            assert out[epochs, vm].shape == (3, 2)
            assert np.isfinite(out[epochs, vm]).all()
        first = out["1", "2"][:, 0] / out["1", "1"][:, 0]
        assert np.abs(first - 1).max() <= 1e-4
    torch.cuda.synchronize()
    assert _kernel_counts() == before


# ---------------------------------------------------------- parallel paths

PAR_NET = dict(hidden_dim=16, out_dim=16, n_layers=3, pos_enc_dim=4,
               lap_method="sign_inv", sign_inv_layers=2, phi_out_dim=2,
               dropout=0.0)


def _par_batches(n=2):
    """Two tiled batches of 12 synthetic molecules, k = 4."""
    gs = synthetic_zinc(48, 0, 0, seed=3)["train"]
    add_lap_pe(gs, 4)
    nb, eb, gc = choose_budgets(gs, 12, tile=32)
    return pack_batches(gs, nb, eb, gc, k=4, tile=32)[:n]


def test_dp_step_at_world_size_one_on_the_card(cuda):
    """build_dp_steps in a world of one rank over NCCL (a card a rank)
    with two microbatches under pallas_tile: its gradients and BN
    statistics are the mean of the two single-device steps' from the same
    seeded init (1e-4 relative + 1e-6: index_add_'s atomics sum in any
    order on the card), and it launches K1 as the two single-device steps
    do together."""
    import numpy as np
    import torch_ranks
    from signnet_basisnet_tpu_torch.parallel.mesh import spawn_ranks
    micro = _par_batches()
    case = dict(kind="dp_step", name="GIN", net=PAR_NET, variables=None,
                lap_method="sign_inv", backend="pallas_tile", micro=[micro])
    (got,), = spawn_ranks(torch_ranks.run_cases, 1, ([case],),
                          device="cuda", timeout=300)
    seg.set_agg_backend("pallas_tile")
    try:
        singles = [torch_ranks.single_step(dict(case, arrays=a), "cuda")
                   for a in micro]
    finally:
        seg.set_agg_backend("xla")
    want_k1 = sum(s["launches"]["K1"] for s in singles)
    assert want_k1 > 0 and got["launches"] == dict(
        singles[0]["launches"], K1=want_k1)
    for key in ("grads", "buffers"):
        for n, a in singles[0][key].items():
            mean = (a + singles[1][key][n]) / 2
            np.testing.assert_allclose(got[key][n], mean, rtol=1e-4,
                                       atol=1e-6, err_msg=n)


def test_mp_step_on_the_card(cuda):
    """build_mp_steps at mp = 2, two ranks sharing the card over gloo, in
    f64: loss, MAE, gradients (of each tensor's largest, or of 1e-4 of the
    model's largest) and BN statistics within 1e-9 of the single-device
    step on the card from the same seeded init, the two ranks equal, and
    no kernel launched (a shard carries no tile ranges)."""
    import numpy as np
    import torch_ranks
    from signnet_basisnet_tpu_torch.parallel.mesh import spawn_ranks
    case = dict(kind="mp_step", name="GatedGCN", net=PAR_NET,
                variables=None, lap_method="sign_inv",
                arrays=_par_batches(1)[0], dtype=torch.float64)
    ranks = [r[0] for r in spawn_ranks(torch_ranks.run_cases, 2, ([case],),
                                       device="cuda", timeout=300)]
    want = torch_ranks.single_step(case, "cuda")
    top = max(float(np.abs(g).max()) for g in want["grads"].values())
    for r in ranks:
        assert r["launches"] == {k: 0 for k in r["launches"]}
        for key in ("loss", "mae"):
            assert abs(r[key] - want[key]) <= 1e-9 * abs(want[key])
        for n, g in want["grads"].items():
            assert float(np.abs(r["grads"][n] - g).max()) <= 1e-9 * max(
                float(np.abs(g).max()), 1e-4 * top), n
        for n, b in want["buffers"].items():
            np.testing.assert_allclose(r["buffers"][n], b, rtol=1e-9,
                                       atol=1e-12, err_msg=n)
    for n, g in ranks[0]["grads"].items():
        np.testing.assert_array_equal(ranks[1]["grads"][n], g)


# ---------------------------------------------------------------------------
# the captured step's device spans and launches per replay
# (utils/profiling.py, training.capture_train_step)

def test_captured_step_spans_and_launches_per_replay(cuda):
    """The flagship GIN's layers at width 16: `step.launches` reads the 47
    K1 launches of the eager step, `step.replays` counts the calls, and a
    replay's sample reads every region, each within its step, and the step
    within 10 % of a CUDA-event time of the same replay with the queue
    empty (that time also holds the batch's copy-in, the LR fill and the
    metric copies; the previous replay's sample is read before it)."""
    from signnet_basisnet_tpu_torch.training import capture_train_step
    from signnet_basisnet_tpu_torch.utils import profiling
    gb = _batch(n_graphs=40).to(cuda)
    net = dict(hidden_dim=16, out_dim=16, n_layers=16, pos_enc_dim=8,
               lap_method="sign_inv", sign_inv_layers=8, phi_out_dim=4,
               pe_aggregate="concat")
    seg.set_agg_backend("pallas_tile")
    try:
        models = [gnn_model("GIN", **net).to(cuda) for _ in range(2)]
        opts = [adam(m.parameters(), capturable=True) for m in models]
        eager = build_steps(models[0], make_zinc_predict(models[0],
                                                         "sign_inv"),
                            opts[0])[0]
        before = ops.spmm_tiled.launches
        eager(gb, 1e-3)
        eager_k1 = ops.spmm_tiled.launches - before
        step = capture_train_step(models[1], make_zinc_predict(
            models[1], "sign_inv"), opts[1], gb)
        step.spans.EVERY = 1   # every replay copied out
        profiling.COUNTERS.reset()
        step(gb, 1e-3)
        torch.cuda.synchronize()
        assert step.spans.sample()   # the first replay's, read here
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step(gb, 1e-3)
        b.record()
        b.synchronize()
        assert step.spans.sample()
    finally:
        seg.set_agg_backend("xla")
    assert eager_k1 == 47
    assert step.launches == {"K1": 47, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    assert step.replays == 2
    samples = profiling.COUNTERS.values("step.regions")
    assert len(samples) == 2
    last = samples[-1]
    assert set(last) == {"pe", "convs", "head", "bn", "adam", "step"}
    for region, ms in last.items():
        assert 0 < ms <= last["step"], (region, last)
    outer = a.elapsed_time(b)
    assert abs(last["step"] - outer) <= 0.1 * outer, (last["step"], outer)


def test_only_the_sampled_replays_stamp(cuda):
    """A captured step replays the graph with the stamps on its first call
    and then one call in `DeviceSpans.EVERY`; the other calls replay the
    graph without them, which leaves the stamps' buffer as it was.  Both
    graphs train: the losses of 10 calls are finite and fall."""
    gbs = _two_batches(cuda)
    seg.set_agg_backend("pallas_tile")
    try:
        _, captured, _, _ = _capture_pair("GIN", cuda, gbs)
        buf = captured.spans.recorder.chunks[0]
        every = captured.spans.EVERY
        first, written, losses = None, [], []
        for i in range(every + 2):
            losses.append(float(captured(gbs[0], 1e-3)["loss"]))
            torch.cuda.synchronize()
            if i == 0:
                first = buf[0].item()
            written.append(buf[0].item() != first)
    finally:
        seg.set_agg_backend("xla")
    # calls 1 .. EVERY - 1 stamp nothing; call EVERY stamps anew
    assert written == [False] * every + [True, True]
    assert bool(torch.isfinite(torch.tensor(losses)).all()), losses
    assert losses[-1] < losses[0], losses
    assert captured.replays == every + 2


def test_captured_step_without_device_spans(cuda, monkeypatch):
    """With `profiling.DEVICE_SPANS` off at the capture no stamp enters the
    graph: no sample is read, and the step still trains."""
    from signnet_basisnet_tpu_torch.training import capture_train_step
    from signnet_basisnet_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "DEVICE_SPANS", False)
    gbs = _two_batches(cuda)
    seg.set_agg_backend("pallas_tile")
    try:
        net = dict(CAPTURE_PATHS["GIN"][0], **SIGNNET)
        model = gnn_model("GIN", **net).to(cuda)
        step = capture_train_step(model, make_zinc_predict(model, "sign_inv"),
                                  adam(model.parameters(), capturable=True),
                                  gbs[0])
        profiling.COUNTERS.reset()
        losses = [float(step(gbs[i % 2], 1e-3)["loss"]) for i in range(3)]
    finally:
        seg.set_agg_backend("xla")
    assert step.spans is None and step.replays == 3
    assert step.launches["K1"] == CAPTURE_COUNTERS["GIN"]["spmm_tiled"]
    assert profiling.COUNTERS.values("step.regions") == []
    assert all(torch.isfinite(torch.tensor(losses)))


def test_timer_stamps_follow_the_stream(cuda):
    """`ops.timer_stamp` around a ~10 ms spin reads that spin within 2 %
    of CUDA events around the same stamps, in stream order, eagerly and as
    kernel nodes of a CUDA graph replayed twice (each replay writes its
    own times), and refuses a slot outside the buffer."""
    from signnet_basisnet_tpu_torch.ops import timer_stamp
    buf = torch.zeros(4, dtype=torch.int64, device=cuda)

    def body():
        timer_stamp(buf, 0)
        torch.cuda._sleep(20_000_000)
        timer_stamp(buf, 1)

    def timed(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b), (buf[1] - buf[0]).item() * 1e-6

    before = timer_stamp.launches
    outer, inner = timed(body)
    assert timer_stamp.launches - before == 2
    assert 0.98 * outer <= inner <= outer, (inner, outer)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    stamps = []
    for _ in range(2):
        outer, inner = timed(graph.replay)
        assert 0.98 * outer <= inner <= outer, (inner, outer)
        stamps.append(buf[0].item())
    assert stamps[1] > stamps[0] + 5_000_000   # the second replay's own
    with pytest.raises(IndexError):
        timer_stamp(buf, 4)
