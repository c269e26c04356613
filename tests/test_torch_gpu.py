"""K1 on the card: the CUDA kernel against its plain version.

Marked `gpu`: each test asks the `cuda` fixture for the card and skips
without one, so on a machine with no NVIDIA card they skip with a reason.
Run them on the card with

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: f32, 1e-5 (each row sums its edges in a fixed order; only the
order differs from the plain index_add_); bf16, one bf16 rounding of the
output (2**-8 relative) beside the plain version that rounds once too.
"""
import importlib

import pytest
import torch

from signnet_basisnet_tpu_torch import ops
from signnet_basisnet_tpu_torch.data import (add_lap_pe, choose_budgets,
                                             pack_batches, synthetic_zinc)
from signnet_basisnet_tpu_torch.graph import edge_csr, from_arrays
from signnet_basisnet_tpu_torch.graph import segment as seg
from signnet_basisnet_tpu_torch.training import (adam, build_steps,
                                                 make_zinc_predict)
from signnet_basisnet_tpu_torch.models import gnn_model
from signnet_basisnet_tpu_torch.models.conv import batch_csr

spmm_mod = importlib.import_module("signnet_basisnet_tpu_torch.ops.spmm_tiled")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU path)")
    return torch.device("cuda")


def _batch(n_graphs=60, tile=256, seed=0):
    gs = synthetic_zinc(n_graphs, 0, 0, seed=seed)["train"]
    add_lap_pe(gs, 8)
    nb, eb, gc = choose_budgets(gs, n_graphs, tile=tile)
    return from_arrays(pack_batches(gs, nb, eb, gc, k=8, tile=tile)[0])


def _args(gb):
    return (gb.senders, gb.receivers, gb.edge_mask, gb.extras["tile_starts"],
            gb.extras["tile_ends"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("feat", [16, 95, 1520])
def test_kernel_matches_plain(cuda, dtype, transpose, feat):
    gb = _batch().to(cuda)
    g = torch.Generator(device=cuda).manual_seed(feat)
    x = torch.randn(gb.num_nodes, feat, device=cuda, generator=g).to(dtype)
    bn = gb.num_nodes // gb.extras["tile_starts"].shape[0]
    got = spmm_mod._launch(x, *_args(gb), batch_csr(gb), bn, transpose)
    ref = ops.spmm_tiled_plain(x, *_args(gb), bn, transpose=transpose)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


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
