"""Roofline share of the flagship train step on the card, captured.

Counterpart of the JAX package's bench_roofline.py, run from the
repository root:

    python -m signnet_basisnet_tpu_torch.bench_roofline [--reps 30]

For the JAX script's batch sizes (128 graphs, the reference protocol's
batch, and 2048) it packs one flat synthetic ZINC batch, captures the
flagship train step (bench.NET: GINNet 16x95 + GINDeepSigns k = 8, Adam,
`xla` aggregation, f32) in a CUDA graph, times `--reps` replays (default
30; best of 3 loops, each ended by a fetch of the loss's value) and
divides an analytic count of the step's FLOPs and bytes by the card's
peaks.  `analytic_cost` is a copy of the JAX script's (the same model, the
same counting): every matmul as
2*m*n*k, the aggregations' adds, backward as twice the forward matmuls plus
one more aggregation pass, Adam as 12 FLOPs a parameter; bytes as a lower
bound under perfect fusion.  Real traffic is at least that, so a share
above 100 % means the model or the timer is broken: the script then fails.
The JAX script also printed XLA's `cost_analysis` beside its count; torch
has no counterpart of that, so only the analytic count is given.

Peaks: NVIDIA H100 SXM data sheet, dense, at 700 W: 3.35e12 B/s of HBM3
and 67e12 f32 FLOP/s outside the tensor cores (the step's f32 matmuls run
in full f32: TF32 is off), as chip_smoke.py states them; the TF32 tensor
cores' 495e12 FLOP/s is given separately, as the rate the same FLOPs would
meet with TF32 on.  The last line is one JSON object whose `mfu_f32_pct_*`
keys hold the step's share of the f32 peak, with the card's name and power
limit.  It measures the card: without one it raises.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import bench
from .data import add_lap_pe, choose_budgets, pack_batches, synthetic_zinc
from .graph import from_arrays
from .training import count_params
from .utils.profiling import card_label, timed

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_TENSOR_FLOP_PER_S = 495e12
BATCH_SIZES = (128, 2048)
REPS = 30

HIDDEN, N_LAYERS, K, SIGN_INV_LAYERS, PHI_OUT = (
    bench.HIDDEN, bench.N_LAYERS, bench.K, bench.SIGN_INV_LAYERS,
    bench.PHI_OUT)
F32 = 4  # bytes


def analytic_cost(N, E, G, P):
    """(train_flops, train_bytes_lower_bound) for the benchmark model
    (GINNet L=16 h=95 + GINDeepSigns phi 8 layers k=8 phi_out=4).

    N/E/G: padded node/edge/graph counts of one batch; P: param count.
    """
    H = HIDDEN
    mm = 0.0          # forward matmul FLOPs
    agg = 0.0         # forward aggregation (gather + segment-add) FLOPs
    act = 0.0         # inter-layer activation elements (saved for backward)

    # --- phi: SIGN_INV_LAYERS GIN layers on [2*N, K, d] (sign_fuse stacks
    # +v/-v), d_in = 1 then H, d_out = H except PHI_OUT at the last layer
    rows = 2 * N * K
    d_in = 1
    for i in range(SIGN_INV_LAYERS):
        d_out = PHI_OUT if i == SIGN_INV_LAYERS - 1 else H
        agg += 2 * E * K * d_in          # gather + segment-add, both signs
        mm += 2 * rows * d_in * H        # Linear d_in -> H
        mm += 2 * rows * H * d_out       # Linear H -> d_out
        act += rows * (d_in + H + d_out)
        d_in = d_out

    # --- rho: MLP (SIGN_INV_LAYERS layers) on [N, K*PHI_OUT] -> [N, K]
    d_in = K * PHI_OUT
    for i in range(SIGN_INV_LAYERS):
        d_out = K if i == SIGN_INV_LAYERS - 1 else H
        mm += 2 * N * d_in * d_out
        act += N * (d_in + d_out)
        d_in = d_out

    # --- PE merge: Linear K -> H (embedding_p); atom embedding is a lookup
    mm += 2 * N * K * H
    act += N * H

    # --- base: N_LAYERS GIN convs, each agg + Linear(H->H) + Linear(H->H)
    for _ in range(N_LAYERS):
        agg += E * H
        mm += 2 * N * H * H * 2
        act += N * H * 3

    # --- readout: segment-sum over nodes + MLPReadout (H -> H/2 -> H/4 -> 1)
    agg += N * H
    mm += 2 * G * (H * (H // 2) + (H // 2) * (H // 4) + (H // 4))

    fwd_flops = mm + agg
    # backward: 2 matmuls per forward matmul (dX and dW) + aggregation
    # transpose pass; optimizer: ~12 FLOPs/param (Adam moments + update)
    train_flops = fwd_flops + 2 * mm + agg + 12 * P

    # --- bytes (lower bound, perfect fusion):
    param_bytes = F32 * P * (1 + 1 + 1 + 4)  # fwd read, bwd read, grad
    # write, Adam read m+v+p / write m+v+p (approx 4P more transfers)
    act_bytes = F32 * act * 2                # write in fwd + read in bwd
    idx_bytes = 4 * E * 2 * (SIGN_INV_LAYERS + N_LAYERS)  # src+dst per agg
    input_bytes = F32 * (N * K) + 4 * (N + 2 * E + G)     # eigvecs + ids
    train_bytes = param_bytes + act_bytes + idx_bytes + input_bytes
    return train_flops, train_bytes


def build(batch_graphs, seed=0):
    """One flat batch of `batch_graphs` synthetic ZINC graphs (arrays)."""
    train = synthetic_zinc(num_train=batch_graphs, num_val=8, num_test=8,
                           seed=seed)["train"]
    add_lap_pe(train, K)
    nb, eb, gc = choose_budgets(train, batch_graphs)
    return pack_batches(train, nb, eb, gc, k=K)[0]


def roofline(batch_graphs, device, reps=REPS):
    """The captured step's time and its shares of the card's peaks at one
    batch size."""
    arrays = build(batch_graphs)
    gb = from_arrays(arrays).to(device)
    edges = float(arrays["edge_mask"].sum())
    with bench.backends("xla", "xla"):
        step = bench.captured_step(bench.NET, gb)
        P = count_params(step.model)
        for _ in range(5):
            m = step(gb, bench.LR)
        float(m["loss"])
        best = float("inf")
        for _ in range(3):
            with timed() as t:
                for _ in range(reps):
                    m = step(gb, bench.LR)
                float(m["loss"])
            best = min(best, t["seconds"] / reps)
    N, E, G = (arrays[k].shape[0] for k in ("node_mask", "edge_mask", "y"))
    flops, bytes_lb = analytic_cost(N, E, G, P)
    t_compute = flops / PEAK_F32_FLOP_PER_S
    t_mem = bytes_lb / PEAK_BYTES_PER_S
    return dict(batch_graphs=batch_graphs, num_nodes=N, num_edges=E,
                num_graphs=G, real_edges=edges, params=P, step_ms=best * 1e3,
                edges_per_s=edges / best, gflop=flops / 1e9,
                mb_lower_bound=bytes_lb / 1e6,
                mfu_f32_pct=flops / best / PEAK_F32_FLOP_PER_S * 100,
                tf32_tensor_pct=(flops / best / PEAK_TF32_TENSOR_FLOP_PER_S
                                 * 100),
                hbm_pct=bytes_lb / best / PEAK_BYTES_PER_S * 100,
                bound_ms=max(t_compute, t_mem) * 1e3,
                bound_by="operations" if t_compute > t_mem else "bytes")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=REPS,
                    help="replays in each of the 3 timed loops")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: bench_roofline measures the card")
    dev = torch.device("cuda")
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    label = card_label()
    out = {"device": label}
    try:
        for bg in BATCH_SIZES:
            r = roofline(bg, dev, args.reps)
            print(f"batch={bg:5d} graphs  N_pad={r['num_nodes']} "
                  f"E_pad={r['num_edges']} G_pad={r['num_graphs']} "
                  f"real_edges={r['real_edges']:.0f} params={r['params']}")
            print(f"  captured step {r['step_ms']:8.3f} ms  "
                  f"{r['edges_per_s'] / 1e6:8.2f} M real edges/s ({label})")
            print(f"  analytic: {r['gflop']:7.2f} GFLOP (train step), "
                  f">= {r['mb_lower_bound']:6.1f} MB device-memory traffic")
            print(f"  {r['mfu_f32_pct']:6.2f}% of the f32 peak (67 TFLOP/s); "
                  f"{r['tf32_tensor_pct']:6.2f}% of the TF32 tensor-core "
                  f"peak (495 TFLOP/s); HBM >= {r['hbm_pct']:5.1f}% of "
                  "3.35 TB/s")
            print(f"  speed-of-light step {r['bound_ms']:.3f} ms (bound by "
                  f"{r['bound_by']}) -> {r['step_ms'] / r['bound_ms']:.1f}x "
                  "off roofline", flush=True)
            if r["mfu_f32_pct"] > 100 or r["hbm_pct"] > 100:
                raise AssertionError(
                    f"batch {bg}: above 100 % of a peak (f32 "
                    f"{r['mfu_f32_pct']:.2f} %, HBM {r['hbm_pct']:.2f} %): "
                    "the analytic model or the timer is broken")
            out[f"b{bg}"] = r
            out[f"mfu_f32_pct_b{bg}"] = r["mfu_f32_pct"]
            torch.cuda.empty_cache()
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
