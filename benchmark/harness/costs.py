"""The yardstick's arithmetic: the card's peaks, a model's FLOPs and a
kernel's least bytes and time, from shapes and the real counts of a batch.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at 700 W: 67 TFLOP/s in
float32 outside the tensor cores (the benchmark's steps run f32 with TF32
off) and 3.35 TB/s of HBM3.

FLOPs are counted at the rows the inputs need: a batch's real nodes,
edges and graphs, not its padded slots (`real` holds them).  Matmuls count
2 m n k; a neighbour sum one add an edge and feature; the backward twice
the forward matmuls (dX and dW) plus one more aggregation pass; Adam 12 a
parameter.  BatchNorm, activations, residual adds and the loss are not
counted, so a share of the peak is a lower bound.  The count follows
`signnet_basisnet_tpu_torch/bench_roofline.py: analytic_cost`, with the
padded counts replaced by the real ones and the `embedding_hp` merge
(pe_aggregate concat) added.

A kernel's bytes: each input byte it needs read once, each output byte
written once: the feature rows that counted edges reach, the whole output
array, the row pointers, and an index and a weight for each counted edge.
Every synthetic molecule is connected, so every real node is reached.
"""
from __future__ import annotations

F32 = 4
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def signnet(real: dict, k: int, hidden: int, phi_out: int, layers: int):
    """(matmul, aggregation) forward FLOPs of the fixed-k GIN SignNet: a
    GIN phi over the 2k sign-fused channels, then the rho MLP."""
    n, e = real["nodes"], real["edges"]
    mm = agg = 0.0
    rows = 2 * k * n
    d_in = 1
    for i in range(layers):
        d_out = phi_out if i == layers - 1 else hidden
        agg += 2 * k * e * d_in
        mm += 2 * rows * d_in * hidden + 2 * rows * hidden * d_out
        d_in = d_out
    d_in = k * phi_out
    for i in range(layers):
        d_out = k if i == layers - 1 else hidden
        mm += 2 * n * d_in * d_out
        d_in = d_out
    return mm, agg


def embed_and_readout(real: dict, k: int, hidden: int, out: int):
    """(matmul, aggregation) forward FLOPs of embedding_p, the concat merge
    embedding_hp, the mean readout and the halving MLP head."""
    n, g = real["nodes"], real["graphs"]
    mm = 2 * n * k * hidden + 2 * n * (2 * hidden) * hidden
    mm += 2 * g * (out * (out // 2) + (out // 2) * (out // 4) + out // 4)
    return mm, n * out


def train_flops(mm: float, agg: float, params: int) -> float:
    """Forward, backward (2 mm + one aggregation pass) and Adam."""
    return mm + agg + 2 * mm + agg + 12 * params


def k1_bound_s(feat: int, transposed: bool, slots: tuple, real: dict):
    """Least seconds of one K1 launch (tile-local SpMM) at `feat` f32
    features: bytes over the HBM peak or FLOPs over the f32 peak."""
    n_slots = slots[0]
    e = real["edges"]
    idx = 3 if transposed else 2           # + the source order
    bytes_ = (F32 * feat * (real["nodes"] + n_slots)
              + 4 * (n_slots + 1) + 4 * idx * e)
    return max(bytes_ / PEAK_BYTES, 2 * feat * e / PEAK_F32_FLOPS)


def k4_bound_s(feat: int, slots: tuple, real: dict):
    """Least seconds of one K4 launch (the fused GatedGCN gate) at `feat`
    f32 features: Bh and Dh at the source rows, Eh at the destination
    rows, Ce at the counted edges read; agg at every node slot and e_new at
    every edge slot written; and per edge 2 adds, the sigmoid (3), the
    weighting (1) and the two sums (2)."""
    n_slots, e_slots = slots[0], slots[1]
    n, e = real["nodes"], real["edges"]
    bytes_ = (F32 * feat * (3 * n + e + n_slots + e_slots)
              + 4 * (n_slots + 1) + 8 * e)
    return max(bytes_ / PEAK_BYTES, 8 * feat * e / PEAK_F32_FLOPS)
