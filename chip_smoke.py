#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (signnet_basisnet_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing its start and its seconds, with a synchronize after
each so a stall shows where it happened:

0. the card's name and power limit (nvidia-smi); build every kernel of the
   ported paths from the checkout's sources, one nvcc per source, all
   started together (nvcc seconds and the -Xptxas -v summary of every
   kernel instance; every K1, K2, K3, K4 and K5 instance must be named
   and must not spill);
1. each kernel against its plain PyTorch version on the card at the main
   paths' shapes, with the stated tolerance: K1 (the tile-local SpMM; f32
   and bf16, forward and transposed, at every row width a path runs it
   with, F = 16, 74, 95, 122, 128, 896, 1088, 1120, 1520 and 4958;
   autograd; a batch with non-tile-local edges), K2/K3 (the fused edge-softmax attention
   forward and backward; f32 and bf16 at D = 8, 10 and 7, both layouts,
   K2's out and den at every row and K3's dE1 at every slot over NaN-filled
   memory, a batch with non-tile-local edges) and K4 (the fused GatedGCN
   gate; f32 and bf16 at F = 68, 77, 70, 67 and 128 (two passes of a
   warp's lanes), agg and e_new at every row and slot over NaN-filled memory, the
   padding slots included, the autograd path, a batch with non-tile-local
   edges); CUDA-event times of each kernel, cold and warm (K1 at each of
   its row widths, forward and transposed; K2/K3 at D = 8, and at 7 and 10
   in the general layout; K4 at F = 68, 67 and 77; K2-K4 also without the
   batch's padding edges), of its plain
   version and, where one exists, of one library call (a yardstick, never
   used by the port: torch.sparse.mm at each of K1's widths) beside the
   bound the card's memory and arithmetic rates put on the same work;
   and (1e) the timer stamp kernel (ops/timer_stamp.py, the stamps of the
   train step's device spans) around a spin of ~10 ms within 2 % of CUDA
   events, eagerly and in each replay of a graph;
2. the GIN path: one full-width train step on the card against the same
   step on the CPU (the kernels' plain versions) from the same weights; the
   warm step's time on one fixed batch, f32 and bf16 in turns, with the
   profiler's device share; then the flagship trainer
   (configs/gin_zinc_signinv_gin.json with data.agg_backend pallas_tile:
   GIN 16x95, SignNet k=8 with an 8-layer GIN phi, 128-graph batches in
   256-node tiles, synthetic ZINC) through train_zinc.run in f32, with the
   launch counts read against 47 K1 per train step and 24 per eval step
   (and no K2/K3);
3. the same trainer in bf16 compute for a few steps;
4. the Transformer path, the same three checks on
   configs/transformer_zinc_signinv_gin.json as shipped (tile_dense:
   TransformerNet 10x64 with 8 heads, LayerNorm and BatchNorm, SignNet
   k=16 with an 8-layer GIN phi): card vs CPU step, warm steps with the
   K2/K3 share of the device time, then train_zinc.run in f32 and bf16
   with the launch counts read against 10 K2 and 10 K3 per train step, 10
   K2 per eval step and no K1.  The card-vs-CPU check also runs the card's
   plain path (no kernels) in f32 and f64: the f64 step must match the
   CPU's f64 step;
5. the GatedGCN path, the same three checks on
   configs/gatedgcn_zinc_signinv_gin.json with data.tile 256 and
   data.agg_backend pallas_tile (GatedGCNNet 16x68, residual, BatchNorm on
   h and e, SignNet k=8 with an 8-layer GIN phi): card vs CPU step (with
   the plain path's f32 and f64 runs), warm steps with the K4/K1 share of
   the device time, then train_zinc.run in f32 and bf16 with the launch
   counts read against 16 K4 and 15 K1 per train step, 16 K4 and 8 K1 per
   eval step and no K2/K3;
6. the port's bench_ops entry point (python -m
   signnet_basisnet_tpu_torch.bench_ops, and with --packer), through its
   main(): every section's comparison within its tolerance, each kernel's
   launch counter equal to the calls the script made (K5, the flat SpMM,
   runs on no model path: this is its main path), the train steps' launches
   per step, and the host packers' times.

7. the train step captured in a CUDA graph (training.capture_train_step)
   against the eager step, at full width from one init over 2 batches
   copied in turn into the graph's static batch, for GIN (pallas_tile, f32
   and bf16), the Transformer (f32) and GatedGCN (pallas_tile, f32): each
   step's loss within 1e-5 relative and every parameter, BN statistic and
   Adam state within 1e-5 + 1e-4 relative, each plus twice the spread of
   two eager runs, all with deterministic algorithms (index_add_'s atomics
   make the eager step unrepeatable, and Adam amplifies that; the first
   replay runs the graph with the device spans' stamps, the others the
   one without); a replay's kernel launches (the step's `launches`)
   against the eager step's counters (GIN 47 K1; Transformer 10 K2 and 10
   K3; GatedGCN 16 K4 and 15 K1) and `replays` against the calls; then,
   outside deterministic mode, a fresh eager step (float LR) and a fresh
   capture: the replay's launches again, both step times in interleaved
   windows (host clock, median and min-max), the last device-span sample
   (every region within its step) against the replays' median, and each
   one's device busy share and device ops per step (profiler);
8. the port's bench (python -m signnet_basisnet_tpu_torch.bench --mode
   auto) and bench_roofline, each in its own process: exit 0, their JSON
   last lines, every mfu_* share at most 100 %;
9. checkpoint and resume on the card: the flagship trainer for 2 epochs
   with train.checkpoint_dir under out/, then resumed to epoch 3, which
   must start at epoch 2 at the saved LR;
10. the masked all-eigenvector SignNet (full-EVD batches, k = 37): one
   full-width train step of configs/gatedgcn_zinc_signinv_masked.json with
   data.agg_backend pallas_tile (GatedGCNNet 67 wide, cut to 4 of its 16
   layers for this check, its whole 8-layer phi over the [N, 74, 67]
   stack through K1 at F = 74 and 4958) and of
   configs/transformer_zinc_signinv_masked.json as shipped (tile_dense,
   10x56 with 8 heads: K2/K3 at D = 7), each card vs CPU with phase 4a's
   bar (the card's plain path in f32 and f64 too; the GatedGCN check also
   prints each f32 run's pre-ReLU signs that differ from the f64 run's,
   which show why it takes that bar); then train_zinc.run
   of both in f32 and of the GatedGCN one in bf16, with the launch counts
   read against 16 K4 and 15 K1 (1 at F = 74 and 7 at 4958 forward, 7 at
   4958 transposed) per train step and 16 K4 and 8 K1 per eval step
   (GatedGCN), 10 K2 and 10 K3 per train step and 10 K2 per eval step
   (Transformer), the warm step time on the host clock and peak memory;
11. the PE baselines and LSPE through train_zinc.run at their published
   widths on small synthetic splits: configs/gatedgcn_zinc_lappe{,_abs,
   _canonical}.json with data.tile 256 data.agg_backend pallas_tile (16 K4
   a step), gin_zinc_lappe (the same overrides: 32 K1 at F = 122 a train
   step, 16 an eval step), transformer_zinc_lappe with data.tile 256
   data.agg_backend tile_dense (8 K2 and 8 K3 at D = 10 a train step),
   gin_zinc_rwpe_lspe (K1 at F = 95) and gatedgcn_zinc_rwpe_lspe (pallas_tile
   overrides, and no K4: the LSPE layer has none); finite val and test
   MAE, and under sign_flip one eval draw per eval batch;
12. PNA and GAT (no kernel of their own: their JAX layers are XLA segment
   ops): one full-width train step of configs/pna_zinc_signinv_gin.json
   (PNANet 70 wide, 5 towers, cut to 8 of its 16 layers for this check)
   and of configs/gat_zinc_signinv_gin.json
   (GATNet 8x56, 4 heads), each with data.tile 256 and data.agg_backend
   pallas_tile so that the 8-layer GIN phi runs K1 at F = 16 and 16 x 70 =
   1120 (PNA) or 16 x 56 = 896 (GAT): card vs CPU, loss, gradients and BN
   statistics, with the card's plain path in f32 and f64 (phase 5a's bar
   is printed; the check holds phase 4a's), and K1's launches and forward
   widths read against 1 + 7 forward and 7 transposed; the warm step's
   device time from the profiler; then all seven PNA
   and GAT configs through train_zinc.run at their published widths (the
   two SignNet-GIN ones with the pallas_tile overrides, the masked PNA one
   as shipped, tile_dense, full EVD): eager train and eval step times,
   peak memory (the masked PNA's beside the masked GatedGCN's of phase
   10c), every kernel's launches per train and eval step, finite MAE.
13. the Alchemy and GINE-ZINC paths (`_phase_13`; no kernel: both
   trainers pack untiled batches, as the JAX ones do): one train step
   card vs CPU at published widths and depths, the set transformer's
   attention dropout off on both devices, on eigenvectors with N(0, 1e-2)
   noise (exact ones put the phi's first layer on ReLU's kink, where each
   device takes the side its summation order gives), each held to phase
   4a's bar (gradients and BN statistics; the card's plain f64 step within
   1e-9 of the CPU's; a tensor that is 0 in exact arithmetic measured
   against 1e-6 of the largest): the Alchemy SignNetGNN (108 wide, 8-layer
   GIN phi, 8-layer rho, 8 of its 16 GINE layers, 12 targets) on 64
   synthetic Alchemy graphs, the GINE-ZINC one (110 wide, 8-layer phi,
   1-layer rho, 6 GINE layers, eigenvalues ignored) on 32 synthetic ZINC
   graphs (the CPU's f64 step at 128 graphs is the slow part), and
   NetGINE (64 x 6, Set2Set); then warm eager steps on full batches (64 and 128 graphs)
   with the profiler's device time and busy share and the peak memory,
   and one step with the MaskedGINEConv phi; then train_alchemy.run and
   train_zinc_gine.run for 2 epochs on 256-384 synthetic graphs at
   published widths: train and eval step times, peak memory, finite MAE,
   Alchemy's per-target MAE and logMAE; zero K1-K5 launches throughout.
14. the LearningFilters workload (`_phase_14`; no kernel: `propagate` is a
   gather and index_add_, the IGN, DeepSets and attention dense ops, in
   both packages): 14a one `train_filters.train_step` card vs CPU on a
   12x12 grid for each of the nine base nets, the SignNet PE with the DS,
   MLP and Transformer phi and the BasisNet PE with IGN and IGNShared,
   under deterministic algorithms: the card's f64 step within 1e-9 of the
   CPU's, the f32 gradients to phase 4a's bar or, where a ReLU flip near
   its kink defeats it, to 13a's median and gross bounds; 14b the three
   published rows of RESULTS.md's band-filter table (SignNet-DS,
   Transformer base, BasisNet) on the real 32x32 grid with all 1024
   eigenvectors, `--matmul_precision highest`, through `train_filters.run`
   (1 image x 100 epochs: PARAMETERS asserted 48,732 / 48,331 / 48,221),
   then image 0's model apart: the epoch's time on the host clock, the
   loss at epochs 1, 50 and 100 (finite, falling), a profiled epoch
   (device time, busy share, top device ops), peak memory and, for
   BasisNet, the CUDA-event time of the first IGN layer's contractions
   over the projector stacks, which every epoch recomputes; 14c
   `--vmap_images 2` against the serial run (lr 1e-3, 2 images) for the
   BasisNet row and the SignNet-MLP row (k = 8): in f64 the vmapped
   trainer's first step within 1e-9 of the serial ones (losses relative,
   gradients of the model's largest; the 4-step loss gap printed: at n =
   1024 f64 noise on zero-gradient weights is enough for Adam too);
   in f32 through `train_filters.run` the initial losses (1 epoch) within
   1e-4, and after 4 epochs the gap printed, with whether the rtol 2e-3 of
   tests/test_filters_vmap.py holds (in f32 Adam moves the weights whose
   exact gradient is 0 by +-lr on their rounding noise, which each
   summation order draws anew); zero K1-K5 launches throughout.
15. the rest of the ZINC model paths (`_phase_15`), on 128-graph synthetic
   ZINC batches: 15a the flagship GIN with the transformer SignNet phi
   (`model.sign_inv_net transformer`: 4 attention layers of width 95, 2
   heads, graphs padded to 40 nodes) card vs CPU (the attention dropout
   off on both; the card's plain f64 step within 1e-9 of the CPU's, the
   f32 gradients to 13a's median and gross bounds, 4a's bar printed) and
   through train_zinc.run for 4 epochs (losses finite, the last epoch's
   mean train loss below the first's; K1 32 a train step
   and 16 an eval step, at F = 95: the phi launches none); 15b remat
   against the plain step from one init under deterministic algorithms,
   for the flagship GIN (pallas_tile), the Transformer as shipped
   (tile_dense), GatedGCN tiled with pallas_tile and the GIN with dropout
   0.1: the loss within 1e-6 relative, every gradient, BN statistic,
   parameter and Adam moment within 1e-6 of the tensor's largest (a
   parameter whose gradient is below 1e-6 of the largest may move by
   +-2 lr: Adam's step on rounding noise), the launches a train step with
   and without remat (the recompute launches each wrapped layer's forward
   kernel again: GIN 63 K1 against 47, the Transformer 20 K2 against 10,
   GatedGCN 32 K4 against 16), the peak memory over a step, which remat
   must lower, and the warm step times; 15c the full-graph Transformer
   (10x64, 8 heads, the SignNet phi, on 64 complete graphs tiled, under
   tile_dense) card vs CPU as 15a, no kernel launched (the layer never
   takes K2/K3's path), its warm step time, and train_zinc.run refusing
   `model.full_graph`; 15d `bench --mode dense` through its main() (edges/s
   and step ms, no kernel launched), one train step of the flagship GIN on
   bench's first dense batch against the same graphs flat (scores within
   2e-4, losses within 1e-5 relative, no kernel in the dense step), and
   `masked_eigh` of the batch's [128, 40, 40] Laplacians on the card in
   f32 and f64 against the CPU's f64 call (eigenvalues, |L v - lambda v|,
   eigenspace projectors): the card's f64 within 1e-9 (eigenvalues) and
   1e-6 (projectors); its f32 eigenvalues within 10 s and residuals within
   40 s, s = eps_f32 * 512, the rounding scale the padding slots' diagonal
   (256-512) sets for a backward-stable solver.
16. the parallel paths (`_phase_16`; ranks are processes that
   parallel.mesh.spawn_ranks starts, so the phase imports this file in
   each; two ranks share the one card over gloo, which measures the
   parallel step's overhead, not scaling): 16a data parallelism on the
   flagship (GIN 16x95 + GINDeepSigns k = 8, pallas_tile, two 128-graph
   microbatches in 256-node tiles): a world of one rank over NCCL with
   both microbatches, and a world of two ranks over gloo with one each;
   the DP step's gradients and BN statistics against the mean of the two
   single-device steps' from the same seeded init, under deterministic
   algorithms (f32 through K1 within 1e-6 of each tensor's largest, f64
   on the plain path within 1e-9), K1 47 launches a rank per microbatch,
   step ms beside the single-device step's; then whether NCCL takes two
   ranks on the one card (recorded, not asserted); 16b model parallelism
   at mp = 2 (two ranks over gloo) for the flagship GIN on its tiled
   128-graph batch (N = 3584, shard_n 1792: the boundary cuts no graph)
   and GatedGCN 16x68 on the same graphs packed untiled into 3584 slots
   (the boundary cuts a graph): one train step against the single-device
   step on the card (f64 within 1e-9: loss, gradients of each tensor's
   largest or of 1e-4 of the model's, BN statistics; f32 as 13a bounds a
   card step: the error against the f64 step of the loss, the MAE, each
   BN statistic and the gradients (median over tensors and worst tensor)
   within 10x the same mp step's on the CPU, which the same two ranks run
   after every timed step),
   zero K1-K5 launches, the halo H, the rows and bytes an exchange moves,
   the step ms, and the collectives of a step timed alone (a synchronize
   before and after each); 16c train_zinc with
   train.mp 2 for 2 epochs of the synthetic stand-in in the same world
   (the train loss falls, rank 0 alone logs, no kernel), then
   bench_scaling at the world sizes one card allows (DP and GSPMD world 1
   over NCCL and 2 over gloo, mp 1 and 2).
17. GSPMD (`_phase_17`; parallel/gspmd.py: the single-device step,
   unchanged, on a batch of DTensors sharded over two ranks that share the
   card over gloo; its jobs run last in phase 16's two-rank world): 17a
   bench_scaling's SignNetGNN(32, 1, 4, 8, 2) on make_global(2), an eval
   step then a train
   step of the GSPMD step against the single-device step from one seeded
   init, under deterministic algorithms: f64 loss, MAE and eval sums
   within 1e-12 relative and every gradient, BN statistic and Adam moment
   within 1e-10 of its tensor's largest (or of 1e-4 of its kind's
   largest, 16b's bar); f32 loss, MAE and eval sums within 1e-5 relative
   and the gradients' distance from the f64 single-device step within
   twice the single-device f32 step's (median over tensors and worst
   tensor), with the attention dropout on in f64 and off in f32 (the
   card's bernoulli_ draws other masks in f64 than in f32); 17b the
   flagship step (GIN 16x95, SignNet k = 8 with an 8-layer GIN phi, 128
   graphs in 256-node tiles) under xla in f64 and under pallas_tile in
   f32 by the same bars, with K1's launches (47 a rank per train step
   and 24 per eval step, GSPMD and single-device alike, each rank running
   the replicated aggregation); 17c the flagship's warm GSPMD step times
   beside the single-device step's (host clock, steps in turns, median
   and min-max: overhead, not scaling) and its first GSPMD train step's
   collectives, each timed alone.

Phase 1d holds K5 against its plain version over NaN-filled output memory
(f32 and bf16 at bench_ops' shape N = 3072, D = 128; D = 95; N = 300;
D = 256, 130 and 512, rows in two passes; D = 64 and 33, 16 lanes a row:
every K5 instance launched; narrowed tile ranges, a tile with no edge,
long runs of equal receivers across a tile boundary; rows with no counted
edge must be zeros; a non-finite row of x read by a counted and by a
weight-0 edge), asserts that one spmm_flat call is one device kernel, and
times the call cold and warm (and by the profiler) beside its plain
version, torch.sparse.mm and the index_add_ reference.

The last two lines are the kernels' JSON record and the result line.  Any
failure raises (exit code 1); without a card it exits 2 and prints no
result.  Imports no JAX and nothing of the JAX package.
"""
import contextlib
import copy
from concurrent.futures import ThreadPoolExecutor
import importlib
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join("configs", "gin_zinc_signinv_gin.json")
TRANSFORMER_CONFIG = os.path.join("configs",
                                  "transformer_zinc_signinv_gin.json")
GATEDGCN_CONFIG = os.path.join("configs", "gatedgcn_zinc_signinv_gin.json")
OUT_DIR = os.path.join("out", "chip_smoke")
MASKED_GATEDGCN_CONFIG = os.path.join("configs",
                                      "gatedgcn_zinc_signinv_masked.json")
MASKED_TRANSFORMER_CONFIG = os.path.join(
    "configs", "transformer_zinc_signinv_masked.json")
PNA_CONFIG = os.path.join("configs", "pna_zinc_signinv_gin.json")
GAT_CONFIG = os.path.join("configs", "gat_zinc_signinv_gin.json")
# every row width K1 runs at: GIN 16 (phi layer 1), 95 (the base layers),
# 1520 (phi layers 2-8: 16 channels of 95); the GatedGCN phi 1088 (16 of
# 68); the masked GatedGCN phi 74 (layer 1: 2k = 74 channels of width 1)
# and 4958 (layers 2-8: 74 of 67); the GAT phi 896 (16 of 56) and the PNA
# phi 1120 (16 of 70); the GIN LapPE layers 122; bench_ops 128
K1_FEATS = (16, 74, 95, 122, 128, 896, 1088, 1120, 1520, 4958)
# each K4 width a path runs: GatedGCN SignNet 68, masked 67, LapPE 77
K4_FEATS = (68, 67, 77)

# published H100 SXM peaks at 700 W (NVIDIA data sheet): HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores (the kernel's FMAs run in f32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def _worst(a, b):
    """The larger error of two, NaN if either is (max() would drop it)."""
    return float("nan") if math.isnan(a) or math.isnan(b) else max(a, b)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        print(f"[phase {self.name}] start", flush=True)
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        import torch
        if exc[0] is None:
            torch.cuda.synchronize()
            print(f"[phase {self.name}] done in {time.time() - self.t0:.1f} s",
                  flush=True)
        return False


def _bytecode_cache():
    """Python's bytecode cached under OUT_DIR, for this process and every
    process it starts.  Where the environment turns the cache off
    (PYTHONDONTWRITEBYTECODE), each new process compiles torch from its
    sources again: beside an NVIDIA H100 80GB HBM3 (700.00 W) `import
    torch` took 7.9-8.0 s and torch.distributed.tensor 4.1-5.0 s more, in
    each of the ten or so processes the run starts."""
    prefix = os.path.join(ROOT, OUT_DIR, "pycache")
    sys.dont_write_bytecode = False
    sys.pycache_prefix = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = prefix


def _fail_without_checkout_or_card():
    if not os.path.isdir(os.path.join(ROOT, "signnet_basisnet_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(signnet_basisnet_tpu_torch/ not found)", file=sys.stderr)
        sys.exit(2)
    _bytecode_cache()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script measures the card "
              "and has no CPU fallback", file=sys.stderr)
        sys.exit(2)


def _cuda_time_ms(fn, iters=50, flush=None):
    """Mean CUDA-event time of fn()'s device work in ms, L2 flushed before
    each call when `flush` is given (the main path finds x cold: other
    layers' work runs in between); utils.profiling.cuda_event_ms holds the
    card ~1 ms before each start event, so the events time the device work
    alone."""
    from signnet_basisnet_tpu_torch.utils.profiling import cuda_event_ms
    ms = cuda_event_ms(fn, iters, flush=flush)
    return sum(ms) / len(ms)


def _profiled_kernel_us(fn, name, iters=20):
    """Mean device time in us of the kernels whose name holds `name`, from
    torch.profiler, or "not measured" if the trace shows none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if name in e.key]
    total = sum(getattr(e, "device_time_total", 0.0) for e in hits)
    count = sum(e.count for e in hits)
    return round(total / count, 2) if count and total else "not measured"


def _interleaved_ms(steps, batch, repeats=5, window=10):
    """Host-clock ms per warm train step for each named step function, on
    one fixed batch (no input pipeline): `repeats` windows of `window`
    steps each, the steps taking turns window by window so that a slow
    spell of the shared host falls on all of them alike."""
    import torch
    for step in steps.values():
        for _ in range(2):
            step(batch, 1e-3)
    torch.cuda.synchronize()
    ms = {name: [] for name in steps}
    for _ in range(repeats):
        for name, step in steps.items():
            t0 = time.time()
            for _ in range(window):
                step(batch, 1e-3)
            torch.cuda.synchronize()
            ms[name].append((time.time() - t0) / window * 1e3)
    return ms


def _profile_steps(step, batch, kernels, steps=3):
    """From torch.profiler over `steps` warm train steps: the device time
    and busy share per step, the device ops per step and each of `kernels`'
    share of the device time.  The card's activity only: with the host's
    ops traced too, reading the trace of 3 eager GIN steps took 5.2-5.6 s
    against 1.1-2.1 for the same device time (NVIDIA H100 80GB HBM3,
    700.00 W), and the host's tracing slowed the steps it measures."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step(batch, 1e-3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(steps):
            step(batch, 1e-3)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    # device work only (user-annotation ranges on the device timeline
    # would span kernels already counted)
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in dev)
    if not busy:
        return "not measured (no device events in the trace)"
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    return dict(
        wall_ms_per_step=round(wall_us / steps / 1e3, 2),
        device_us_per_step=round(busy / steps, 1),
        device_busy_share=round(busy / wall_us, 3),
        device_ops_per_step=round(sum(e.count for e in dev) / steps, 1),
        kernel_share_of_device={
            k: round(sum(e.self_device_time_total for e in dev
                         if k in e.key) / busy, 4) for k in kernels},
        top=[(e.key[:60], round(e.self_device_time_total / steps, 1))
             for e in top])


@contextlib.contextmanager
def _deterministic():
    """Deterministic algorithms while the block runs (index_add_ as a
    sorted index_put_ on the card), warning only where an op has none.
    The eager step is otherwise not repeatable: index_add_'s atomics sum
    the readout in any order, and over a few steps Adam turns that
    rounding into parameter steps of up to the LR (two eager f32 GIN runs
    from one init were 6.2e-3 apart in the loss and 0.2 in a tensor after
    5 steps), which hides what the capture itself does."""
    import torch
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


def _captured_vs_eager(le, la, lc, se, sa, sc):
    """The captured run (losses lc, tensors sc) against the eager run (le,
    se), with a second eager run (la, sa) for the spread: each loss within
    1e-5 relative and each tensor within 1e-5 + 1e-4 * |eager|, each plus
    twice the eager run-to-run spread.  Returns ((worst tensor error / bar,
    its name), the same without the spread, the worst loss error beyond
    its bar, the loss spread, the largest tensor spread); NaN counts as
    worst."""
    spread_l = max(abs(a - b) for a, b in zip(le, la))
    spread = {n: float((sa[n] - se[n]).abs().max()) if se[n].numel()
              else 0.0 for n in se}
    worst_l = max(abs(a - b) - 1e-5 * abs(b) - 2 * spread_l
                  for a, b in zip(lc, le))
    if math.isnan(worst_l):
        worst_l = math.inf
    worst, plain = (-1.0, ""), (-1.0, "")
    for n in se:
        if not se[n].numel():
            continue
        err = (sc[n].double() - se[n].double()).abs()
        bar = 1e-5 + 1e-4 * se[n].double().abs()
        for best, b in ((0, bar + 2 * spread[n]), (1, bar)):
            r = float((err / b).max())
            r = math.inf if math.isnan(r) else r
            if best == 0 and r > worst[0]:
                worst = (r, n)
            if best == 1 and r > plain[0]:
                plain = (r, n)
    return worst, plain, worst_l, spread_l, max(spread.values())


def _train_state_tensors(model, opt):
    """Every parameter, buffer and Adam state tensor of a model, copied
    (Adam's by parameter index)."""
    out = {n: t.detach().clone() for n, t in
           list(model.named_parameters()) + list(model.named_buffers())}
    for i, p in enumerate(model.parameters()):
        for k, v in opt.state.get(p, {}).items():
            out[f"adam.{i}.{k}"] = v.detach().clone()
    return out


_TEMPLATE_ARG = re.compile(r"f|13__nv_bfloat16|L[ib](\d+)E")


def _kernel_label(line):
    """`name<args>` of the kernel a ptxas line names by its mangled name
    (f32, bf16 and the integer and bool template arguments in order), or
    None."""
    m = re.search(r"_kernelI", line)
    if not m:
        return None
    # the name is the source name of the length its digits give
    end = m.start() + len("_kernel")
    name = next((line[end - n:end] for n in range(1, end)
                 if line[:end - n].endswith(str(n))), None)
    if name is None:
        return None
    args, pos = [], m.end()
    while a := _TEMPLATE_ARG.match(line, pos):
        args.append({"f": "f32", "13__nv_bfloat16": "bf16"}.get(
            a.group(0), a.group(1)))
        pos = a.end()
    return f"{name}<{', '.join(args)}>"


def _ptxas_summary(report):
    """(label, registers, spill stores, spill loads) of every kernel
    instance nvcc's -Xptxas -v report names."""
    out, name, spill = [], None, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = _kernel_label(line)
        elif name and "spill" in line:
            spill = [int(v) for v in re.findall(r"(\d+) bytes spill", line)]
        elif name and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append((name, regs, *spill))
            name = None
    return out


def _build_all(modules):
    """Build every kernel library at once, one nvcc per source, all started
    together (each build runs in a thread; nvcc runs outside the GIL)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(modules)) as pool:
        for f in [pool.submit(m.build) for m in modules]:
            f.result()


@contextlib.contextmanager
def _attention_plain_on_card():
    """The Transformer layers' attention through its plain version, not
    K2/K3, while the block runs: the card's own plain path."""
    from signnet_basisnet_tpu_torch.models import conv
    from signnet_basisnet_tpu_torch.ops import edge_softmax_attention_plain
    tiled = conv.edge_softmax_attention_tiled
    conv.edge_softmax_attention_tiled = (
        lambda *args: edge_softmax_attention_plain(*args[:-1]))
    try:
        yield
    finally:
        conv.edge_softmax_attention_tiled = tiled


@contextlib.contextmanager
def _gate_plain_on_card():
    """The GatedGCN layers' gate and the phi's aggregation through their
    plain versions (autograd through them), not K4/K1, while the block
    runs: the card's own plain path, in any float type."""
    from signnet_basisnet_tpu_torch.models import conv
    from signnet_basisnet_tpu_torch.ops import (gatedgcn_gate_plain,
                                                spmm_tiled_plain)
    saved = conv.gatedgcn_gate_tiled, conv.spmm_tiled
    conv.gatedgcn_gate_tiled = (
        lambda *args: gatedgcn_gate_plain(*args[:9], args[10]))
    conv.spmm_tiled = lambda *args, csr: spmm_tiled_plain(*args[:6],
                                                           args[7])
    try:
        yield
    finally:
        conv.gatedgcn_gate_tiled, conv.spmm_tiled = saved


def _check_step_card_vs_cpu(model_name, net, arrays, make_step,
                            plain_on_card=None, floor_cpu_error=False,
                            relu_inputs=None, bn_state=False,
                            other_orders=(), many_kinks=False):
    """One train step from the same weights: on the card in f32, on the CPU
    (the kernels' plain versions) in f32 and in f64.  The net is
    `gnn_model(model_name, **net)`, or `model_name()` where that is a
    function making it (seeded, so each call makes the same weights).  The f64 step stands
    for the exact one; the card's f32 error against it must stay within
    10x of the CPU's f32 error, tensor by tensor (float noise grows through
    the BatchNorm'd layers on both).

    With `plain_on_card` (a context that swaps the kernels for their plain
    versions) the step also runs on the card without the kernels, in f32
    and in f64.  The card's f64 step must match the CPU's to 1e-9 of each
    tensor's largest gradient (or of 1e-4 of the model's largest, if that
    is more): both are exact to f64 rounding, so the card's f32 error is
    f32 rounding and not a fault of the card's path.
    With `floor_cpu_error` too, the CPU's error on a tensor is taken as no
    less than the CPU's median relative error over all tensors times the
    tensor's largest gradient: a ReLU or clamp that sits within float noise
    of its kink sends the gradient of the layers below it one way or the
    other, so one run lands near the f64 step by luck and another does not,
    with or without the kernels (the card's plain run shows which way it
    fell).  With `relu_inputs` (a test on module names: the modules whose
    output a ReLU takes) each f32 run's pre-ReLU signs are compared with
    the CPU's f64 run's, and the flips printed: how many, how near 0 they
    lie in f64, and how many sit in the layer of the worst gradient.
    With `bn_state` the BatchNorm running statistics after the step are
    held as the gradients are: the card's f32 error within 10x the CPU's
    plus 1e-6 of the tensor's largest value, and (with `plain_on_card`)
    the card's plain f64 run within 1e-9 of it.
    `other_orders` (batches of the same graphs in other orders, which give
    the same gradients in exact arithmetic) adds a CPU f32 step on each:
    a tensor's CPU error is then the largest over the orders, a better
    estimate of its f32 noise where a sum cancels or a pre-ReLU value sits
    within float noise of 0 (the single-order ratio is printed too).
    With `many_kinks` (deep nets, whose f32 runs each put tens of
    pre-ReLU values within float noise of 0 on the other side of the f64
    run's, a different set on each device: pass `relu_inputs` to see
    them) one flipped value can move a gradient that sums over all rows,
    such as a GIN eps, by a few percent in one run and not in another, so
    the per-tensor bar above is printed and not asserted.  Asserted
    instead: the median over tensors of the card's error relative to the
    tensor's largest gradient within 10x the CPU's (a loss of precision on
    the card, such as TF32, would raise every tensor's error; a flip in a
    late layer raises every earlier layer's a little: 2.8x seen), and every
    tensor's within 10x the CPU's worst relative error (over tensors and
    orders) times its largest gradient (a gross error).  A tensor whose f64
    gradient is below 1e-6 of the model's largest (0 in exact arithmetic:
    a bias straight before a BatchNorm) is left out of both, and a BN
    statistic is measured against at least 1e-6 of the largest statistic
    (the mean of a bias-free Linear over the sign-fused [v, -v] stack is
    0).  The f64 and BN checks stand as above.
    Returns the card's (step, batch) and the errors read."""
    import numpy as np
    import torch
    from signnet_basisnet_tpu_torch.graph import from_arrays
    from signnet_basisnet_tpu_torch.models import gnn_model
    runs = [("card", "cuda", torch.float32, contextlib.nullcontext)]
    if plain_on_card is not None:
        runs += [("card_plain", "cuda", torch.float32, plain_on_card),
                 ("card_plain_f64", "cuda", torch.float64, plain_on_card)]
    runs += [("cpu", "cpu", torch.float32, contextlib.nullcontext),
             ("cpu_f64", "cpu", torch.float64, contextlib.nullcontext)]
    runs = [r + (arrays,) for r in runs] + [
        (f"cpu_order_{i}", "cpu", torch.float32, contextlib.nullcontext, a)
        for i, a in enumerate(other_orders)]
    losses, grads, signs, stats = {}, {}, {}, {}
    for run_name, d, dt, ctx, run_arrays in runs:
        model = (model_name() if callable(model_name)
                 else gnn_model(model_name, **net)).to(d, dt)
        step = make_step(model)
        batch = from_arrays(run_arrays).to(d).cast_floats(dt)
        rec = {}
        hooks = [mod.register_forward_hook(
            lambda mod, i, o, n=n: rec.__setitem__(n, o.detach().cpu()))
            for n, mod in model.named_modules()
            if relu_inputs is not None and relu_inputs(n)
            and run_arrays is arrays]
        with ctx():
            losses[run_name] = float(step(batch, 1e-3)["loss"])
        for h in hooks:
            h.remove()
        if run_arrays is arrays:
            signs[run_name] = (rec if run_name == "cpu_f64" else
                               {n: o > 0 for n, o in rec.items()})
        grads[run_name] = {n: p.grad.detach().cpu().double() for n, p in
                           model.named_parameters() if p.grad is not None}
        stats[run_name] = {n: b.detach().cpu().double()
                           for n, b in model.named_buffers()}
        if run_name == "card":
            card_step = (step, batch)
    print("  loss " + ", ".join(f"{k} {v:.9f}" for k, v in losses.items()),
          flush=True)
    if not np.isfinite(losses["card"]) or abs(
            losses["card"] - losses["cpu_f64"]) > 10 * abs(
            losses["cpu"] - losses["cpu_f64"]) + 1e-6:
        raise AssertionError("card and CPU losses disagree")
    errs = {n: {k: float((grads[k][n] - g).abs().max()) for k in grads
                if not k.endswith("f64")} for n, g in grads["cpu_f64"].items()}
    one_order = {n: e["cpu"] for n, e in errs.items()}
    order_errs = {n: [e.pop(f"cpu_order_{i}")
                      for i in range(len(other_orders))]
                  for n, e in errs.items()}
    for n, e in errs.items():
        e["cpu"] = max([e["cpu"]] + order_errs[n])
    scale = {n: float(g.abs().max()) for n, g in grads["cpu_f64"].items()}
    f64_gap = None
    if plain_on_card is not None:
        # a tensor whose gradient is zero in exact arithmetic (a bias
        # straight before a BatchNorm) is measured against 1e-4 of the
        # model's largest gradient
        top = max(scale.values())
        f64_gap = max((float((grads["card_plain_f64"][n] - g).abs().max())
                       / (scale[n] + 1e-4 * top), n)
                      for n, g in grads["cpu_f64"].items())
        print(f"  card plain f64 vs CPU f64: loss "
              f"{abs(losses['card_plain_f64'] - losses['cpu_f64']):.3e} "
              f"apart; grads at most {f64_gap[0]:.3e} of the tensor's "
              f"largest gradient apart, at {f64_gap[1]}", flush=True)
        if not f64_gap[0] < 1e-9:
            raise AssertionError("the card's f64 step (plain path) departs "
                                 "from the CPU's f64 step")
    typical = 0.0
    if floor_cpu_error:
        typical = float(np.median([e["cpu"] / s for n, e in errs.items()
                                   if (s := scale[n]) > 0]))
        print(f"  CPU f32 error, median over tensors relative to the "
              f"tensor's largest gradient: {typical:.3e}", flush=True)
    worst_plain = (0.0, "")
    ratio, ratio_cpu = {}, {}
    top_g = max(scale.values())
    zeros = [n for n in errs if scale[n] < 1e-6 * top_g]
    if many_kinks:
        print(f"  {len(zeros)} tensors with an exact gradient of 0 (below "
              f"1e-6 of the largest in f64): {zeros[:6]}", flush=True)
    for n, e in errs.items():
        floor = 1e-6 * scale[n] + 1e-12
        bar = 10 * e["cpu"] + floor
        ratio_cpu[n] = e["card"] / bar
        noise = (1e-6 * top_g if many_kinks and n in zeros
                 else typical * scale[n])
        ratio[n] = e["card"] / (10 * max(e["cpu"], noise) + floor)
        if "card_plain" in e:
            worst_plain = max(worst_plain, (e["card_plain"] / bar, n))
    worst = max((r, n) for n, r in ratio.items())
    worst_cpu = max((r, n) for n, r in ratio_cpu.items())
    worst_one_order = None
    if other_orders:
        worst_one_order = max(
            (errs[n]["card"] / (10 * max(one_order[n], typical * scale[n])
                                + 1e-6 * scale[n] + 1e-12), n)
            for n in errs)
        # the same bar with the CPU's reversed-batch run in the card's place
        cpu_vs_cpu = max(
            (order_errs[n][0] / (10 * max(one_order[n], typical * scale[n])
                                 + 1e-6 * scale[n] + 1e-12), n)
            for n in errs)
        print(f"  CPU f32 error over {1 + len(other_orders)} orders of the "
              f"batch's graphs; with the first order alone the worst card "
              f"error / (10x the larger of the CPU's error and its median "
              f"relative error) is {worst_one_order[0]:.3f} at "
              f"{worst_one_order[1]}; the CPU's own run on the reversed "
              f"batch, by that bar: {cpu_vs_cpu[0]:.3f} at {cpu_vs_cpu[1]}",
              flush=True)
        worst_one_order += cpu_vs_cpu
    print(f"  {len(errs)} gradient tensors; the five nearest their bar:",
          flush=True)
    for n in sorted(ratio, key=lambda n: -ratio[n])[:5]:
        print(f"  {n}: max|g| {scale[n]:.3e} f32 error " + " ".join(
            f"{k} {v:.3e}" for k, v in errs[n].items())
            + f"; card error / bar {ratio[n]:.3f}", flush=True)
    print(f"  grads: worst card error / (10x the CPU's error on the tensor) "
          f"{worst_cpu[0]:.3f} at {worst_cpu[1]}", flush=True)
    if f64_gap is not None:
        n = worst_cpu[1]
        f64_gap_at_worst = float((grads["card_plain_f64"][n]
                                  - grads["cpu_f64"][n]).abs().max())
        rel = f64_gap_at_worst / (scale[n] + 1e-4 * top)
        print(f"  ... there the card's plain f64 step is "
              f"{f64_gap_at_worst:.3e} from the CPU's f64 step ({rel:.3e} "
              "of the tensor's largest gradient)", flush=True)
        f64_gap = f64_gap + (n, rel)
    if plain_on_card is not None:
        print(f"  grads: the same for the card's plain run (no kernels) "
              f"{worst_plain[0]:.3f} at {worst_plain[1]}", flush=True)
    if floor_cpu_error:
        print(f"  grads: worst card error / (10x the larger of the CPU's "
              f"error and its median relative error) {worst[0]:.3f} at "
              f"{worst[1]}", flush=True)
    if relu_inputs is not None:
        ref = signs["cpu_f64"]
        layer = worst[1].split(".")[0] + "."
        for run_name in (r for r in signs if not r.endswith("f64")):
            flips = {n: s != (ref[n] > 0) for n, s in signs[run_name].items()}
            near = [float(ref[n][f].abs().max()) for n, f in flips.items()
                    if f.any()]
            print(f"  pre-ReLU signs, {run_name} f32 against the CPU's f64: "
                  f"{sum(int(f.sum()) for f in flips.values())} flips in "
                  f"{len(near)} of {len(flips)} tensors, all within "
                  f"{max(near, default=0.0):.2e} of 0 in f64; in {layer}* "
                  f"{sum(int(f.sum()) for n, f in flips.items() if n.startswith(layer))}",
                  flush=True)
    worst_bn = None
    if bn_state:
        ref = stats["cpu_f64"]
        worst_bn, gap_bn = (0.0, ""), (0.0, "")
        # with many_kinks, a statistic that is 0 in exact arithmetic
        # (the mean of a bias-free Linear over the sign-fused [v, -v]
        # stack) is measured against 1e-6 of the largest statistic
        top_bn = max((float(r.abs().max()) for r in ref.values()),
                     default=0.0)
        for n, r in ref.items():
            s = float(r.abs().max())
            if many_kinks:
                s = max(s, 1e-6 * top_bn)
            e = {k: float((stats[k][n] - r).abs().max()) for k in stats}
            worst_bn = max(worst_bn, (e["card"] / (10 * e["cpu"] + 1e-6 * s
                                                   + 1e-12), n))
            if "card_plain_f64" in e:
                gap_bn = max(gap_bn, (e["card_plain_f64"] / (s + 1e-12), n))
        print(f"  BN statistics ({len(ref)} tensors): worst card error / "
              f"(10x the CPU's + 1e-6 of the largest) {worst_bn[0]:.3f} at "
              f"{worst_bn[1]}; card plain f64 vs CPU f64 {gap_bn[0]:.3e} of "
              f"the largest, at {gap_bn[1]}", flush=True)
        if worst_bn[0] > 1 or (plain_on_card is not None
                               and not gap_bn[0] < 1e-9):
            raise AssertionError(f"BN statistics {worst_bn[1]} / "
                                 f"{gap_bn[1]}: card and CPU disagree")
    kink_check = None
    if many_kinks:
        rel = {k: {n: e[k] / scale[n] for n, e in errs.items()
                   if scale[n] >= 1e-6 * top_g} for k in ("card", "cpu")}
        med = {k: float(np.median(list(v.values()))) for k, v in rel.items()}
        cpu_worst = max(rel["cpu"].values())
        gross = max((v / (10 * cpu_worst), n) for n, v in rel["card"].items())
        kink_check = dict(median_card=med["card"], median_cpu=med["cpu"],
                          cpu_worst_rel=cpu_worst, gross=gross,
                          per_tensor_4a=worst)
        print(f"  grads relative to each tensor's largest: median card "
              f"{med['card']:.3e}, CPU {med['cpu']:.3e} (ratio "
              f"{med['card'] / med['cpu']:.3f}, asserted <= 10); the CPU's "
              f"worst {cpu_worst:.3e}; worst card error / (10x that) "
              f"{gross[0]:.3f} at {gross[1]}; phase 4a's per-tensor bar "
              f"{'holds' if worst[0] <= 1 else 'does not hold'} "
              f"({worst[0]:.3f} at {worst[1]}, not asserted here)",
              flush=True)
        if med["card"] > 10 * med["cpu"] or gross[0] > 1:
            raise AssertionError(f"grads: the card's f32 errors {kink_check}")
    elif worst[0] > 1:
        raise AssertionError(f"grad {worst[1]}: the card's f32 error is "
                             "beyond 10x the CPU's")
    return card_step, dict(kink_check=kink_check,
        losses=losses, worst_vs_pr4_bar=worst_cpu, worst=worst,
        worst_one_order=worst_one_order,
        worst_plain_vs_pr4_bar=worst_plain, f64_gap=f64_gap,
        worst_bn=worst_bn)


def _counts():
    """Every kernel wrapper's launch counter, K1-K5."""
    from signnet_basisnet_tpu_torch.training.train import kernel_launches
    return kernel_launches()


def _reset_counts():
    from signnet_basisnet_tpu_torch import ops
    ops.spmm_tiled.launches = 0
    ops.edge_softmax_attention_tiled.launches_fwd = 0
    ops.edge_softmax_attention_tiled.launches_bwd = 0
    ops.gatedgcn_gate_tiled.launches = 0
    ops.spmm_flat.launches = 0


def _phase_13(record, dev, reset_counts, launches):
    """Phase 13, the Alchemy and GINE-ZINC paths (no kernel: the trainers
    pack untiled batches): `reset_counts()` sets every kernel's launch
    counter to 0, `launches()` reads them."""
    import numpy as np
    import torch
    from signnet_basisnet_tpu_torch import train_alchemy, train_zinc_gine
    from signnet_basisnet_tpu_torch.data import (add_full_evd,
                                                 choose_budgets,
                                                 pack_batches,
                                                 synthetic_alchemy,
                                                 synthetic_zinc)
    from signnet_basisnet_tpu_torch.graph import from_arrays
    from signnet_basisnet_tpu_torch.graph import segment as seg
    from signnet_basisnet_tpu_torch.models import (NetGINE, SignNetGNN,
                                                   set_attention_dropout)
    from signnet_basisnet_tpu_torch.training import (adam, build_steps,
                                                     make_module_predict)
    seg.set_agg_backend("xla")

    def no_launches(tag):
        got = launches()
        print(f"  {tag}: launches {got} (expected none)", flush=True)
        if any(got.values()):
            raise AssertionError(f"{tag}: kernels launched {got}")

    def evd_graphs(graphs, n_graphs, jitter):
        """Copies of the first `n_graphs` graphs with all n eigenpairs;
        with `jitter`, N(0, 1e-2) noise on every eigenvector entry (see
        13a)."""
        gs = copy.deepcopy(graphs[:n_graphs])
        add_full_evd(gs, normalization=None)
        if jitter:
            r = np.random.default_rng(0)
            for g in gs:
                g["eigvecs"] = (g["eigvecs"] + r.normal(
                    scale=1e-2, size=g["eigvecs"].shape)).astype(np.float32)
        return gs

    def one_batch(gs):
        """`gs` in one untiled batch (k = the largest graph), as the
        trainers pack them."""
        b_nb, b_eb, b_gc = choose_budgets(gs, len(gs))
        out = pack_batches(gs, b_nb, b_eb, b_gc)
        assert len(out) == 1
        return out[0]

    def with_orders(gs):
        """The batch of `gs`, and of the same graphs reversed and shuffled
        (the same gradients in exact arithmetic): the CPU's f32 noise is
        taken over the three summation orders."""
        perm = np.random.default_rng(1).permutation(len(gs))
        return one_batch(gs), [one_batch(gs[::-1]),
                               one_batch([gs[i] for i in perm])]

    def signnet_gnn(kw):
        def make():
            m = SignNetGNN(**kw)
            set_attention_dropout(m, 0.0)
            return m
        return make

    module_step = lambda model: build_steps(
        model, make_module_predict(model), adam(model.parameters()))[0]
    al_gs = synthetic_alchemy(64, 0, 0, seed=0)["train"]
    zn_gs = synthetic_zinc(128, 0, 0, seed=0)["train"]
    alchemy_net = dict(n_hid=108, n_out=12, nl_signnet=8, nl_gnn=16,
                       nl_rho=8, gnn_type="GINEConv",
                       phi_gnn_type="MaskedGINConv", node_vocab=10,
                       edge_vocab=10, node_code_dims=6)
    gine_net = dict(n_hid=110, n_out=1, nl_signnet=8, nl_gnn=6, nl_rho=1,
                    ignore_eigval=True, gnn_type="GINEConv",
                    phi_gnn_type="MaskedGINConv", node_vocab=28,
                    edge_vocab=4)
    # exact eigenvectors put the phi's first layer on ReLU's kink: the
    # sign-fused stack [v, -v] has mean 0, and (1 + eps) v_i + sum_j v_j =
    # (1 + eps + d_i - lambda) v_i is 0 up to rounding wherever v_i is or
    # lambda = d_i + 1, so each device takes the side its summation order
    # gives and the f64 steps part; the card-vs-CPU steps run on
    # eigenvectors with N(0, 1e-2) noise (as tests/test_torch_alchemy.py)
    al_arrays, al_orders = with_orders(evd_graphs(al_gs, 64, True))
    zn_arrays, zn_orders = with_orders(evd_graphs(zn_gs, 32, True))
    for tag, label, make, arrays_13, orders_13 in (
            # 8 of the net's 16 GINE layers: the CPU's f64 step at full
            # depth costs more than the run's time allows beside phases 16
            # and 17 (13b times the whole net)
            ("alchemy", "13a Alchemy SignNetGNN 108 (8 phi, 8 rho, 8 of "
             "16 GINE), 64 graphs", signnet_gnn(dict(alchemy_net,
                                                     nl_gnn=8)),
             al_arrays, al_orders),
            ("gine_zinc", "13a GINE-ZINC SignNetGNN 110 (8 phi, 1 rho, 6 "
             "GINE), 32 graphs", signnet_gnn(gine_net), zn_arrays,
             zn_orders),
            ("netgine", "13a NetGINE 64x6 (Set2Set), 64 Alchemy graphs",
             lambda: NetGINE(hidden=64, num_layers=6), al_arrays,
             al_orders)):
        with Phase(f"{label}, card vs CPU"):
            print(f"  batch: {int(arrays_13['graph_mask'].sum())} graphs, "
                  f"{len(arrays_13['node_mask'])} node slots, eigvecs "
                  f"{arrays_13['eigvecs'].shape}", flush=True)
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            # deterministic algorithms: with index_add_'s atomics a run's
            # rounding, and so the side a pre-ReLU value within float noise
            # of 0 falls on, changes from run to run (one of two card runs
            # put gnn.conv_8's gradients 10x past the bar, the other run
            # of the same code in the same call within it)
            with _deterministic():
                _, info = _check_step_card_vs_cpu(
                    make, None, arrays_13, module_step,
                    plain_on_card=contextlib.nullcontext,
                    floor_cpu_error=True, bn_state=True,
                    other_orders=orders_13, many_kinks=True,
                    relu_inputs=lambda n: n.endswith(("bn_0", "bn_1"))
                    or ".norm_" in n)
            info["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
            print(f"  peak memory over the card's steps "
                  f"{info['peak_mib']:.0f} MiB", flush=True)
            no_launches(tag)
            record[f"{tag}_card_vs_cpu"] = info

    with Phase("13b warm eager steps at published widths (profiler)"):
        # full batches: Alchemy 64 graphs, GINE-ZINC 128 (exact
        # eigenvectors), attention dropout on as the trainers run it; then
        # one step of the GINE-ZINC net with the MaskedGINEConv phi
        full = {"alchemy": (dict(alchemy_net),
                            one_batch(evd_graphs(al_gs, 64, False))),
                "gine_zinc": (dict(gine_net),
                              one_batch(evd_graphs(zn_gs, 128, False)))}
        full["gine_zinc_gine_phi"] = (dict(gine_net,
                                           phi_gnn_type="MaskedGINEConv"),
                                      full["gine_zinc"][1])
        for tag, (kw, arrays_13) in full.items():
            model = SignNetGNN(**kw).to(dev)
            step = module_step(model)
            batch = from_arrays(arrays_13).to(dev)
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            loss = float(step(batch, 1e-3)["loss"])
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            if not np.isfinite(loss):
                raise AssertionError(f"{tag}: loss {loss}")
            no_launches(tag)
            prof = ("not profiled" if tag == "gine_zinc_gine_phi"
                    else _profile_steps(step, batch, []))
            print(f"  {tag}: eigvecs {arrays_13['eigvecs'].shape}, loss "
                  f"{loss:.6f}, peak memory of a train step {peak:.0f} MiB; "
                  f"profiler {prof}", flush=True)
            record[f"{tag}_warm_step"] = dict(loss=loss, peak_mib=peak,
                                              profile=prof)
            del model, step, batch

    def run_trainer(tag, module, argv, result_json):
        """`module.run` at published widths with every counter at 0 just
        before it, read just after; the last epoch's train and eval step
        times from its JSON, peak memory."""
        args = module.build_parser().parse_args(argv + [
            "--epochs", "2", "--log_every", "1", "--out_dir",
            os.path.join(OUT_DIR, tag)])
        jpath = os.path.join(OUT_DIR, tag, result_json)
        if os.path.exists(jpath):
            os.remove(jpath)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        module.run(args, log=lambda m: print("  " + m, flush=True))
        torch.cuda.synchronize()
        no_launches(tag)
        with open(jpath) as f:
            res = json.load(f)
        h = res["history"][-1]
        step_ms = h["train_time"] / h["train_steps"] * 1e3
        eval_ms = h["eval_time"] / max(h["eval_steps"], 1) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        print(f"  {tag}: train step {step_ms:.2f} ms ({h['train_steps']} "
              f"steps, host clock to the last loss on the host), eval step "
              f"{eval_ms:.2f} ms ({h['eval_steps']} steps), peak memory "
              f"{peak:.0f} MiB", flush=True)
        record[f"{tag}_run"] = dict(step_ms=step_ms, eval_ms=eval_ms,
                                    peak_mib=peak, result=res)
        return res

    with Phase("13c train_alchemy.run (published widths, 2 epochs)"):
        res = run_trainer("alchemy", train_alchemy, [
            "--seeds", "1", "--synth_train", "256", "--synth_eval", "128"],
            "alchemy_s0.json")
        mae_t = np.asarray(res["per_target_mae"])
        print(f"  test MAE {res['test_mae']:.4f} logMAE {res['logmae']:.4f}; "
              f"per-target MAE " + " ".join(f"{v:.4f}" for v in mae_t),
              flush=True)
        if not (np.isfinite([res["test_mae"], res["logmae"]]).all()
                and mae_t.shape == (12,) and np.isfinite(mae_t).all()):
            raise AssertionError(f"alchemy: non-finite metrics {res}")

    with Phase("13d train_zinc_gine.run (published widths, 2 epochs)"):
        res = run_trainer("gine_zinc", train_zinc_gine, [
            "--synth_train", "384", "--synth_eval", "128"],
            "zinc_gine_s0.json")
        print(f"  best val MAE {res['best_val']:.4f}, test MAE at the best "
              f"val {res['test_at_best_val']:.4f}", flush=True)
        if not np.isfinite([res["best_val"], res["test_at_best_val"]]).all():
            raise AssertionError(f"gine_zinc: non-finite metrics {res}")


# the LearningFilters rows of RESULTS.md's band-filter table, with the
# PARAMETERS line of the JAX logs (results/r2/band50_*.log)
FILTER_ROWS = {
    "signnet_ds": (["--net", "DS", "--hidden_channels", "32",
                    "--num_layers", "3", "--use_eig", "--lap_method",
                    "sign_inv", "--sign_inv_net", "DS"], 48732),
    "transformer": (["--net", "Transformer", "--hidden_channels", "16",
                     "--use_eig", "--lap_method", "sign_inv",
                     "--sign_inv_net", "DS"], 48331),
    "basisnet": (["--net", "DS", "--hidden_channels", "16", "--use_eig",
                  "--lap_method", "basis_inv", "--ign_hidden", "16"], 48221),
}


def _grid_mat(path, side, images=3, seed=0):
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
    return path


def _filter_step_card_vs_cpu(tf, args):
    """One `train_filters.train_step` of image 0 from the same seed on the
    card and on the CPU, each in f32 and f64: the losses and every
    gradient."""
    import torch
    runs = {}
    for dev in ("cuda", "cpu"):
        for dt in (torch.float32, torch.float64):
            p = tf.prepare(args, lambda m: None, torch.device(dev), dt)
            model = p.make_model(args.seed * 100003)
            loss, _ = tf.train_step(model, tf.adam(model.parameters()), p.gb,
                                    p.x[:, :1], p.y[:, :1], p.mask, p.kwargs)
            runs[f"{dev}_{str(dt)[-2:]}"] = (float(loss), {
                n: t.grad.detach().cpu().double()
                for n, t in model.named_parameters() if t.grad is not None})
    return runs


def _stacked_vs_serial_f64(tf, args, steps=4):
    """The vmapped trainer (`stacked_trainer`) against the serial
    `train_step`, both in f64 on the card from the same seeds, over the
    first images of `args`: the first step's largest relative loss gap,
    its gradients' largest gap relative to the model's largest gradient,
    and the largest relative loss gap over `steps` steps."""
    import numpy as np
    import torch
    p = tf.prepare(args, lambda m: None, torch.device("cuda"), torch.float64)
    seeds = [args.seed * 100003 + i for i in p.img_ids]
    xs = torch.stack([p.x[:, i:i + 1] for i in p.img_ids])
    ys = torch.stack([p.y[:, i:i + 1] for i in p.img_ids])
    serial, grads = [], []
    for i, seed in enumerate(seeds):
        model = p.make_model(seed)
        opt = tf.adam(model.parameters())
        tf.set_lr(opt, args.lr)
        losses = []
        for s in range(steps):
            losses.append(float(tf.train_step(model, opt, p.gb, xs[i], ys[i],
                                              p.mask, p.kwargs)[0]))
            if s == 0:
                grads.append({n: t.grad.clone() for n, t in
                              model.named_parameters()})
        serial.append(losses)
    step, params = tf.stacked_trainer([p.make_model(s) for s in seeds], p,
                                      args.lr)
    stacked = []
    for s in range(steps):
        stacked.append(step(xs, ys)[0].cpu().numpy())
        if s == 0:
            top = max(float(g.abs().max()) for g in grads[0].values())
            grad_gap = max(float((params[n].grad[i] - g).abs().max()) / top
                           for i, gi in enumerate(grads)
                           for n, g in gi.items())
    stacked, serial = np.array(stacked).T, np.array(serial)
    gaps = np.abs(stacked - serial) / np.abs(serial)
    return float(gaps[:, 0].max()), grad_gap, float(gaps.max())


def _hold_filter_step(tag, runs):
    """The card's f64 step within 1e-9 of the CPU's (loss relative; each
    gradient relative to the larger of its largest entry and 1e-4 of the
    model's); the card's f32 gradients to phase 4a's bar (each tensor's
    error from the CPU's f64 one within 10x the CPU's f32 error + 1e-6 of
    its largest), or, where a flip near a ReLU's kink defeats that, to 13a's
    (the median relative error within 10x the CPU's, each tensor within 10x
    the CPU's worst relative error), tensors with an exact gradient of 0
    (below 1e-6 of the largest) left out of the f32 checks."""
    import numpy as np
    ref = runs["cpu_64"][1]
    top = max(float(g.abs().max()) for g in ref.values())
    gap = max((float((runs["cuda_64"][1][n] - g).abs().max())
               / max(float(g.abs().max()), 1e-4 * top), n)
              for n, g in ref.items())
    loss_gap = abs(runs["cuda_64"][0] - runs["cpu_64"][0]) / abs(
        runs["cpu_64"][0])
    live = [n for n, g in ref.items() if float(g.abs().max()) >= 1e-6 * top]
    err = {k: {n: float((runs[k][1][n] - ref[n]).abs().max()) for n in live}
           for k in ("cuda_32", "cpu_32")}
    scale = {n: float(ref[n].abs().max()) for n in live}
    ratio = max((err["cuda_32"][n] / (10 * err["cpu_32"][n]
                                      + 1e-6 * scale[n]), n) for n in live)
    rel = {k: {n: v / scale[n] for n, v in e.items()} for k, e in err.items()}
    med = {k: float(np.median(list(v.values()))) for k, v in rel.items()}
    cpu_worst = max(rel["cpu_32"].values())
    gross = max((v / (10 * cpu_worst + 1e-12), n)
                for n, v in rel["cuda_32"].items())
    held_4a = ratio[0] <= 1
    print(f"  {tag}: loss card/CPU f32 {runs['cuda_32'][0]:.7f} / "
          f"{runs['cpu_32'][0]:.7f}; f64 loss {loss_gap:.2e} apart, grads "
          f"at most {gap[0]:.2e} of the tensor's largest ({gap[1]}); f32 "
          f"grads: phase 4a's bar {'holds' if held_4a else 'does not hold'}"
          f" ({ratio[0]:.3f} at {ratio[1]}); median relative error card "
          f"{med['cuda_32']:.2e} CPU {med['cpu_32']:.2e}, gross "
          f"{gross[0]:.3f} ({len(ref) - len(live)} zero-gradient tensors "
          f"left out)", flush=True)
    if not (loss_gap < 1e-9 and gap[0] < 1e-9):
        raise AssertionError(f"{tag}: the card's f64 step departs from the "
                             f"CPU's ({loss_gap}, {gap})")
    if not held_4a and (med["cuda_32"] > 10 * med["cpu_32"]
                        or gross[0] > 1):
        raise AssertionError(f"{tag}: the card's f32 gradients {ratio}, "
                             f"{med}, {gross}")
    return dict(f64_loss_gap=loss_gap, f64_grad_gap=gap, bar_4a=ratio,
                held_4a=held_4a, median_rel=med, gross=gross,
                loss_f32={k: runs[k][0] for k in ("cuda_32", "cpu_32")})


def _phase_14(record, reset_counts, launches):
    """Phase 14, the LearningFilters workload (no kernel: `propagate` is a
    gather and index_add_, the IGN and attention dense ops):
    `reset_counts()` sets every kernel's launch counter to 0,
    `launches()` reads them."""
    import numpy as np
    import torch
    from signnet_basisnet_tpu_torch import train_filters as tf
    from signnet_basisnet_tpu_torch.graph import segment as seg
    seg.set_agg_backend("xla")
    seg.set_sum_backend("xla")
    fdir = os.path.join(OUT_DIR, "filters")
    os.makedirs(fdir, exist_ok=True)
    parse = tf.build_parser().parse_args

    def no_launches(tag):
        got = launches()
        if any(got.values()):
            raise AssertionError(f"{tag}: kernels launched {got}")

    with Phase("14a filter steps, card vs CPU (12x12 grid)"):
        # each grid in a directory of its own: the eigenpair and label
        # caches are kept beside the .mat
        small_dir = os.path.join(fdir, "grid12")
        os.makedirs(small_dir, exist_ok=True)
        small = _grid_mat(os.path.join(small_dir, "grid.mat"), 12)
        common = ["--mat_path", small, "--label_dir", small_dir,
                  "--results_dir", ""]
        variants = {name: ["--net", name] for name in
                    tf.FILTER_MODEL_REGISTRY}
        for phi in ("DS", "MLP", "Transformer"):
            variants[f"sign_inv_{phi}"] = [
                "--net", "DS", "--use_eig", "--lap_method", "sign_inv",
                "--sign_inv_net", phi]
        for enc in ("IGN", "IGNShared"):
            variants[f"basis_inv_{enc}"] = [
                "--net", "DS", "--use_eig", "--lap_method", "basis_inv",
                "--basis_inv_net", enc, "--ign_hidden", "16"]
        out = {}
        reset_counts()
        # deterministic algorithms: index_add_'s atomics would sum in any
        # order on the card
        with _deterministic():
            for tag, argv in variants.items():
                out[tag] = _hold_filter_step(tag, _filter_step_card_vs_cpu(
                    tf, parse(argv + common)))
        held = sum(v["held_4a"] for v in out.values())
        print(f"  phase 4a's bar held by {held} of {len(out)} steps; "
              f"launches {launches()} (expected none)", flush=True)
        no_launches("14a")
        record["filters_card_vs_cpu"] = out

    # 100 epochs (not 200): the run's time
    with Phase("14b the three published rows (real grid, 1 image x 100 "
               "epochs, matmul_precision highest)"):
        real_dir = os.path.join(fdir, "2dgrid")
        os.makedirs(real_dir, exist_ok=True)
        real = os.path.join(real_dir, "2Dgrid.mat")
        shutil.copy(os.path.join("data", "2dgrid", "2Dgrid.mat"), real)
        for tag, (argv, want_params) in FILTER_ROWS.items():
            args = parse(argv + [
                "--mat_path", real, "--label_dir", real_dir, "--img_num",
                "1", "--epochs", "100", "--scan_epochs", "50",
                "--matmul_precision", "highest", "--results_dir",
                os.path.join(fdir, "results")])
            lines = []
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            res = tf.run(args, log=lambda m: (lines.append(m), print(
                "  " + m, flush=True)))
            torch.cuda.synchronize()
            run_s = time.time() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            no_launches(tag)
            params = int(next(l for l in lines
                              if l.startswith("PARAMETERS")).split()[1])
            if params != want_params or not np.isfinite(res).all():
                raise AssertionError(f"{tag}: PARAMETERS {params}, "
                                     f"results {res}")
            # the epochs apart: image 0's model, one loss per epoch read at
            # the end; the host clock over epochs 51-100
            with tf.matmul_precision("highest"):
                p = tf.prepare(args, lambda m: None, torch.device("cuda"))
                model = p.make_model(args.seed * 100003)
                opt = tf.adam(model.parameters())
                tf.set_lr(opt, args.lr)
                step = lambda b, lr: tf.train_step(
                    model, opt, p.gb, p.x[:, :1], p.y[:, :1], p.mask,
                    p.kwargs)
                losses = []
                for e in range(100):
                    if e == 50:
                        torch.cuda.synchronize()
                        t1 = time.time()
                    losses.append(step(None, None)[0])
                torch.cuda.synchronize()
                epoch_ms = (time.time() - t1) / 50 * 1e3
                prof = _profile_steps(step, None, [], steps=5)
                contraction_ms = None
                if p.kwargs["projs"] is not None:
                    # the first IGN layer's 2->1 contractions over the
                    # constant projector stacks, which every epoch
                    # recomputes: CUDA-event time, all multiplicities
                    from signnet_basisnet_tpu_torch.nn.ign import (
                        contractions_2_to_1)
                    contraction_ms = _cuda_time_ms(lambda: [
                        contractions_2_to_1(P)
                        for P in p.kwargs["projs"].values()], iters=20)
            losses = torch.stack(losses).cpu().numpy()
            l1, l50, l100 = (float(losses[i]) for i in (0, 49, 99))
            if contraction_ms is not None:
                share = (contraction_ms * 1e3 / prof["device_us_per_step"]
                         if isinstance(prof, dict) else "not measured")
                print(f"  {tag}: the first IGN layer's contractions "
                      f"{contraction_ms:.3f} ms an epoch (CUDA events), "
                      f"{share} of the epoch's device time", flush=True)
            print(f"  {tag}: PARAMETERS {params}; run() {run_s:.1f} s for 1 "
                  f"image x 100 epochs (set-up included), results "
                  f"{res.tolist()}; epoch {epoch_ms:.2f} ms on the host "
                  f"clock (epochs 51-100); loss at epochs 1 / 50 / 100 "
                  f"{l1:.6g} / {l50:.6g} / {l100:.6g}; peak memory "
                  f"{peak:.0f} MiB; profiler {prof}", flush=True)
            if not (np.isfinite(losses).all() and l100 < l50 < l1):
                raise AssertionError(f"{tag}: losses {l1}, {l50}, {l100}")
            no_launches(tag)
            record[f"filters_{tag}"] = dict(
                params=params, run_s=run_s, results=res.tolist(),
                epoch_ms=epoch_ms, loss_1_50_100=(l1, l50, l100),
                contraction_ms=contraction_ms,
                peak_mib=peak, profile=prof)
            del p, model, opt, step

    with Phase("14c --vmap_images 2 against the serial run (lr 1e-3)"):
        common = ["--mat_path", real, "--label_dir", real_dir, "--img_num",
                  "2", "--lr", "1e-3", "--results_dir", ""]
        mlp = ["--net", "MLP", "--use_eig", "--lap_method", "sign_inv",
               "--sign_inv_net", "MLP", "--k", "8"]
        out = {}
        reset_counts()
        for tag, argv in (("basisnet", FILTER_ROWS["basisnet"][0]),
                          ("signnet_mlp_k8", mlp)):
            # the stacked trainer's math: the first f64 step's loss and
            # gradients against the serial ones (later steps part where
            # Adam moves zero-gradient weights on rounding noise)
            f64_first, f64_grads, f64_gap = _stacked_vs_serial_f64(
                tf, parse(argv + common))
            got = {}
            for epochs, vm, dev in (("1", "1", "cuda"), ("1", "2", "cuda"),
                                    ("4", "1", "cuda"), ("4", "2", "cuda")):
                torch.cuda.synchronize()
                t0 = time.time()
                got[epochs, vm, dev] = tf.run(parse(argv + common + [
                    "--epochs", epochs, "--scan_epochs", epochs,
                    "--vmap_images", vm, "--device", dev]),
                    log=lambda m: None)[:, 0]
                torch.cuda.synchronize()
                got[epochs, vm, dev, "s"] = time.time() - t0
            rel = lambda a, b: float(np.max(np.abs(a - b) / np.abs(b)))
            # 1 epoch: the initial loss, before Adam has moved a weight
            first = rel(got["1", "2", "cuda"], got["1", "1", "cuda"])
            gap = rel(got["4", "2", "cuda"], got["4", "1", "cuda"])
            out[tag] = dict(f64_first_step=f64_first,
                            f64_first_step_grads=f64_grads,
                            f64_gap=f64_gap, first_epoch_gap=first, gap=gap,
                            held_2e3=gap <= 2e-3,
                            runs={"_".join(k): (
                                v if isinstance(v, float) else v.tolist())
                                for k, v in got.items()})
            print(f"  {tag}: f64, the stacked trainer against the serial "
                  f"steps: first step's losses {f64_first:.2e} and gradients "
                  f"{f64_grads:.2e} (of the largest) apart, losses over 4 "
                  f"steps {f64_gap:.2e}; f32 run(): "
                  f"initial loss vmapped vs serial {first:.2e} apart; after "
                  f"4 epochs serial {got['4', '1', 'cuda'].tolist()} "
                  f"({got['4', '1', 'cuda', 's']:.1f} s), vmapped "
                  f"{got['4', '2', 'cuda'].tolist()} "
                  f"({got['4', '2', 'cuda', 's']:.1f} s): {gap:.2e} apart "
                  f"(rtol 2e-3 {'holds' if gap <= 2e-3 else 'does not hold'}"
                  f")", flush=True)
            finite = all(np.isfinite(v).all() for v in got.values()
                         if not isinstance(v, float))
            if max(f64_first, f64_grads) > 1e-9 or first > 1e-4 or not finite:
                raise AssertionError(f"14c {tag}: vmapped and serial part "
                                     f"{out[tag]}")
        no_launches("14c")
        record["filters_vmap"] = out


def _phase_15(record, dev, reset_counts, launches, run_path, arrays):
    """Phase 15: the transformer SignNet phi (15a), remat (15b), the
    full-graph Transformer (15c) and dense mode (15d), on synthetic ZINC
    128-graph batches (`arrays`: phase 1's, k = 8 in 256-node tiles).
    `reset_counts()` sets every kernel's launch counter to 0, `launches()`
    reads them, `run_path` is main()'s train_zinc.run check."""
    import numpy as np
    import torch
    from signnet_basisnet_tpu_torch import bench
    from signnet_basisnet_tpu_torch.data import (add_lap_pe, choose_budgets,
                                                 make_full_graphs,
                                                 pack_batches,
                                                 synthetic_zinc)
    from signnet_basisnet_tpu_torch.graph import (batch_np,
                                                  dense_from_arrays,
                                                  from_arrays)
    from signnet_basisnet_tpu_torch.graph import segment as seg
    from signnet_basisnet_tpu_torch.models import (gnn_model,
                                                   set_attention_dropout)
    from signnet_basisnet_tpu_torch.spectral import (PAD_EIGVAL, masked_eigh,
                                                     sym_laplacian_dense)
    from signnet_basisnet_tpu_torch.train_zinc import net_params, run
    from signnet_basisnet_tpu_torch.training import (adam, build_steps,
                                                     load_config,
                                                     make_zinc_predict)
    gs = synthetic_zinc(512, 0, 0, seed=0)["train"]
    zeros = {k: 0 for k in ("K1", "K2", "K3", "K4", "K5")}

    def cfg_of(path, extra):
        return load_config(path, extra + [
            "data.synth_train", "512", "data.synth_eval", "128",
            "train.epochs", "2", "train.print_epoch_interval", "1",
            "out_dir", OUT_DIR])

    def zinc_step(model):
        return build_steps(model, make_zinc_predict(model, model.lap_method),
                           adam(model.parameters()))[0]

    def no_attention_dropout(net):
        """A function making the seeded net with the transformer phi's
        attention dropout off: the two devices' generators draw different
        bits."""
        def make():
            model = gnn_model("GIN", **net)
            set_attention_dropout(model, 0.0)
            return model
        return make

    # -------------------------------------------------------------- 15a
    tcfg = cfg_of(CONFIG, ["data.agg_backend", "pallas_tile",
                           "model.sign_inv_net", "transformer",
                           "name", "gin_transformer_phi"])
    # 4 epochs of 4 steps: over 2 the mean train loss need not fall yet
    # (it rose by 4e-3 from epoch 1 to 2 on the CPU, and fell by 1.2e-2 by
    # epoch 4)
    tcfg.train.epochs = 4
    layers = tcfg.model.n_layers
    with Phase("15a GIN with the transformer phi, card vs CPU"):
        seg.set_agg_backend("pallas_tile")
        net = net_params(tcfg, gs)
        reset_counts()
        _, info = _check_step_card_vs_cpu(
            no_attention_dropout(net), None, arrays, zinc_step,
            plain_on_card=_gate_plain_on_card, floor_cpu_error=True,
            bn_state=True, many_kinks=True)
        got = launches()
        want = dict(zeros, K1=2 * layers)
        print(f"  launches over the card's train step {got}, expected "
              f"{want} (the base layers' K1, forward and transposed; the "
              f"transformer phi launches none)", flush=True)
        if got != want:
            raise AssertionError(f"15a: launches {got}")
        record["transformer_phi_card_vs_cpu"] = info
    with Phase("15a train_zinc.run with the transformer phi"):
        res = run_path("gin_transformer_phi", tcfg,
                       {"K1": (2 * layers, layers)}, {95: layers})
        losses = [h["train_loss"] for h in res.history]
        print(f"  train losses by epoch {losses}", flush=True)
        if not losses[-1] < losses[0]:
            raise AssertionError(f"15a: train loss did not fall: {losses}")

    # -------------------------------------------------------------- 15b
    gs_t = synthetic_zinc(512, 0, 0, seed=0)["train"]
    cases = {}
    for tag, path, extra in (
            ("gin", CONFIG, ["data.agg_backend", "pallas_tile"]),
            ("gin_dropout", CONFIG, ["data.agg_backend", "pallas_tile",
                                     "model.dropout", "0.1"]),
            ("transformer", TRANSFORMER_CONFIG, []),
            ("gatedgcn", GATEDGCN_CONFIG, ["data.tile", "256",
                                           "data.agg_backend",
                                           "pallas_tile"])):
        cfg = cfg_of(path, extra)
        k = cfg.model.pos_enc_dim
        if k == 8:
            batch_arrays = arrays
        else:   # the Transformer's k = 16, as phase 4a packs it
            gs_k = [dict(g) for g in gs_t]
            add_lap_pe(gs_k, k)
            nb, eb, gc = choose_budgets(gs_k, 128, tile=256)
            batch_arrays = pack_batches(gs_k, nb, eb, gc, k=k, tile=256)[0]
        cases[tag] = (cfg, batch_arrays)
    for tag, (cfg, batch_arrays) in cases.items():
        m = cfg.model
        with Phase(f"15b remat, {tag} ({m.model} {m.n_layers}x"
                   f"{m.hidden_dim}, {cfg.data.agg_backend}, dropout "
                   f"{m.dropout})"):
            seg.set_agg_backend(cfg.data.agg_backend)
            batch = from_arrays(batch_arrays).to(dev)
            net = net_params(cfg, gs)
            out = {}
            for remat_on in (False, True):
                model = gnn_model(m.model, **dict(net, remat=remat_on)).to(dev)
                opt = adam(model.parameters())
                step = build_steps(model, make_zinc_predict(
                    model, m.lap_method), opt)[0]
                reset_counts()
                with _deterministic():
                    loss = float(step(batch, 1e-3)["loss"])
                torch.cuda.synchronize()
                counts = launches()
                grads = {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()
                         if p.grad is not None}
                state = _train_state_tensors(model, opt)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                step(batch, 1e-3)
                torch.cuda.synchronize()
                peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
                out[remat_on] = dict(loss=loss, counts=counts, grads=grads,
                                     state=state, peak=peak, step=step)
            a, b = out[False], out[True]
            gap = abs(b["loss"] - a["loss"]) / max(abs(a["loss"]), 1e-12)
            top = max(float(g.abs().max()) for g in a["grads"].values())
            worst = (0.0, "")
            for n, g in a["grads"].items():
                d = float((b["grads"][n] - g).abs().max())
                worst = max(worst, (d / (1e-6 * float(g.abs().max())
                                         + 1e-7 * top + 1e-30), f"grad {n}"))
            for n, t in a["state"].items():
                d = (b["state"][n].double() - t.double()).abs()
                bar = 1e-6 * float(t.abs().max()) + 1e-12
                if n in a["grads"]:
                    # a parameter whose gradient is below 1e-6 of the
                    # largest moves by +-lr on its rounding noise in Adam
                    noise = a["grads"][n].abs() < 1e-6 * top
                    d = torch.where(noise, torch.clamp(d - 2e-3, min=0), d)
                worst = max(worst, (float(d.max()) / bar, n))
            ms = _interleaved_ms({"plain": a["step"], "remat": b["step"]},
                                 batch, repeats=3, window=5)
            med = {k: float(np.median(v)) for k, v in ms.items()}
            print(f"  loss {a['loss']:.9f} vs remat {b['loss']:.9f} "
                  f"({gap:.2e} relative, bar 1e-6); every gradient, BN "
                  f"statistic, parameter and Adam moment: worst "
                  f"{worst[0]:.3f} of its bar (1e-6 of the tensor's largest"
                  f" value; gradients plus 1e-7 of the largest gradient) at "
                  f"{worst[1]}", flush=True)
            print(f"  launches per train step: plain {a['counts']}, remat "
                  f"{b['counts']}; peak MiB over a step (above what was "
                  f"allocated before it): plain {a['peak']:.1f}, remat "
                  f"{b['peak']:.1f}; warm step ms (host clock, median of 3 "
                  f"windows of 5): plain {med['plain']:.2f}, remat "
                  f"{med['remat']:.2f}", flush=True)
            L = m.n_layers
            want_a = {"gin": dict(zeros, K1=47), "gin_dropout": dict(
                zeros, K1=47), "transformer": dict(zeros, K2=L, K3=L),
                "gatedgcn": dict(zeros, K4=L, K1=15)}[tag]
            # the recompute runs each wrapped layer's forward kernel again
            extra = {"gin": "K1", "gin_dropout": "K1", "transformer": "K2",
                     "gatedgcn": "K4"}[tag]
            want_b = dict(want_a, **{extra: want_a[extra] + L})
            if a["counts"] != want_a or b["counts"] != want_b:
                raise AssertionError(f"15b {tag}: launches {a['counts']}, "
                                     f"{b['counts']}; expected {want_a}, "
                                     f"{want_b}")
            if gap > 1e-6 or worst[0] > 1:
                raise AssertionError(f"15b {tag}: the remat step departs "
                                     f"from the plain one: {worst}")
            if not b["peak"] < a["peak"]:
                raise AssertionError(f"15b {tag}: remat did not lower the "
                                     f"peak ({a['peak']}, {b['peak']})")
            record[f"remat_{tag}"] = dict(
                loss=(a["loss"], b["loss"]), worst=worst,
                launches=(a["counts"], b["counts"]),
                peak_mib=(a["peak"], b["peak"]), step_ms=ms)
            del out, a, b, batch

    # -------------------------------------------------------------- 15c
    fcfg = cfg_of(TRANSFORMER_CONFIG, ["model.full_graph", "true"])
    with Phase("15c full-graph Transformer, card vs CPU (tile_dense)"):
        seg.set_agg_backend(fcfg.data.agg_backend)
        k = fcfg.model.pos_enc_dim
        gs_f = [dict(g) for g in gs[:64]]
        add_lap_pe(gs_f, k)
        full = make_full_graphs(gs_f)
        nb, eb, gc = choose_budgets(full, 64, tile=256)
        f_arrays = pack_batches(full, nb, eb, gc, k=k, tile=256)[0]
        print(f"  64 complete graphs: {nb} node slots, "
              f"{int(f_arrays['edge_mask'].sum())} edges, "
              f"{int(f_arrays['edge_real'].sum())} of them real", flush=True)
        fnet = net_params(fcfg, gs)
        assert fnet["full_graph"]
        reset_counts()
        (f_step, f_batch), info = _check_step_card_vs_cpu(
            "Transformer", fnet, f_arrays, zinc_step,
            plain_on_card=contextlib.nullcontext, floor_cpu_error=True,
            bn_state=True, many_kinks=True)
        got = launches()
        print(f"  launches over the card's steps {got} (expected none: the "
              f"full-graph layer bypasses K2/K3, the phi aggregates by the "
              f"block adjacency)", flush=True)
        if got != zeros:
            raise AssertionError(f"15c: launches {got}")
        ms = _interleaved_ms({"full_graph": f_step}, f_batch, repeats=3,
                             window=5)["full_graph"]
        print(f"  warm full-graph step (host clock, 3 windows of 5): median "
              f"{float(np.median(ms)):.2f} ms, {[round(t, 2) for t in ms]}",
              flush=True)
        try:
            run(fcfg, device="cuda", log=lambda s: None)
        except NotImplementedError as err:
            if "make_full_graph" not in str(err):
                raise
            print(f"  train_zinc.run refuses model.full_graph: {err}",
                  flush=True)
        else:
            raise AssertionError("15c: train_zinc.run ran model.full_graph")
        record["full_graph"] = dict(card_vs_cpu=info, step_ms=ms,
                                    launches=got)
        del f_step, f_batch

    # -------------------------------------------------------------- 15d
    with Phase("15d bench --mode dense (main)"):
        reset_counts()
        line = bench.main(["--mode", "dense"])
        got = launches()
        d = line["modes"]["dense"]
        print(f"  dense: {d['edges_per_s']:.0f} edges/s, step "
              f"{d['step_ms']:.2f} ms; flat eager {line['flat_eager_eps']:.0f}"
              f" edges/s; launches {got} (expected none)", flush=True)
        if got != zeros or not d["edges_per_s"] > 0:
            raise AssertionError(f"15d: launches {got}, {d}")
        record["bench_dense"] = line
    with Phase("15d dense against flat, masked eigh card vs CPU"):
        # bench's first dense batch (128 graphs in [128, 40, ...] blocks)
        # and the same graphs flat in 128 x 40 node slots, so that both
        # hold the same padding rows, which the phi's rho BatchNorm (no
        # mask) counts; one train step of the flagship GIN from one init
        # on each: the scores of the 128 graphs in the step's forward
        # (batch statistics) within 2e-4 (JAX tests/test_dense_mode.py's
        # bar) and the losses within 1e-5 relative
        seg.set_agg_backend("xla")
        d_arrays = bench.build_dense_batches(num_batches=1)[0]
        chunk = synthetic_zinc(128, 8, 8, seed=bench.SEED)["train"]
        add_lap_pe(chunk, bench.K)
        f_arrays = batch_np(chunk, 128 * bench.DENSE_MAX_NODES,
                            sum(len(g["senders"]) for g in chunk) + 8, 129,
                            k=bench.K)
        assert (f_arrays["n_node"][:128] == d_arrays["n_node"]).all()
        dense_b = dense_from_arrays(d_arrays).to(dev)
        flat_b = from_arrays(f_arrays).to(dev)
        scores, losses, got = {}, {}, {}
        for tag, b in (("dense", dense_b), ("flat", flat_b)):
            model = gnn_model("GIN", **bench.NET).to(dev)
            seen = []
            hook = model.mlp_readout.register_forward_hook(
                lambda mod, i, o: seen.append(o[:128, 0].detach().clone()))
            reset_counts()
            losses[tag] = float(zinc_step(model)(b, 1e-3)["loss"])
            torch.cuda.synchronize()
            got[tag] = launches()
            hook.remove()
            scores[tag] = seen[0]
        err = float((scores["dense"] - scores["flat"]).abs().max())
        lgap = abs(losses["dense"] - losses["flat"]) / abs(losses["flat"])
        print(f"  train step, dense vs flat (same init): scores of the 128 "
              f"graphs max |diff| {err:.3e} (bar 2e-4), losses "
              f"{losses['dense']:.7f} vs {losses['flat']:.7f} ({lgap:.2e} "
              f"relative, bar 1e-5); K1-K5 launches in the dense step "
              f"{got['dense']}", flush=True)
        if got["dense"] != zeros or not (err <= 2e-4 and lgap <= 1e-5):
            raise AssertionError(f"15d: dense vs flat {err}, {lgap}, "
                                 f"launches {got['dense']}")
        # masked_eigh of the batch's Laplacians: the card's f32 and f64
        # calls and the CPU's f32 one, each against the CPU's f64 one.  The
        # padding slots' diagonal (256-512) sets the scale s = eps * 512 of
        # a backward-stable solver's f32 rounding in every pair (the CPU's
        # LAPACK keeps the decoupled padding block apart and does better),
        # so the card's f32 call is held to 10 s on the eigenvalues and
        # 40 s (n s) on |L v - lambda v|, its projectors printed; its f64
        # call to 1e-9 (eigenvalues) and 1e-6 (projectors)
        L = sym_laplacian_dense(dense_b.adj, dense_b.node_mask)
        mask = dense_b.node_mask
        ref = [t.numpy() for t in masked_eigh(L.cpu().double(),
                                              mask.cpu().double())[:2]]
        runs = {"card_f32": masked_eigh(L, mask),
                "card_f64": masked_eigh(L.double(), mask.double()),
                "cpu_f32": masked_eigh(L.cpu(), mask.cpu())}
        L64 = L.cpu().double().numpy()

        def eig_errors(vals, vecs):
            """(eigenvalues, |L v - lambda v| on the real block, eigenspace
            projectors) against the CPU's f64 call; eigenspaces are runs
            of its eigenvalues less than 1e-3 apart."""
            vals = vals.cpu().double().numpy()
            vecs = vecs.cpu().double().numpy()
            v_err = float(np.abs(vals - ref[0]).max())
            resid = float(np.abs(L64 @ vecs - vecs * vals[:, None, :]).max())
            proj = 0.0
            for g in range(L64.shape[0]):
                n = int(d_arrays["n_node"][g])
                cv, start = ref[0][g], 0
                for j in range(1, n + 1):
                    if j == n or cv[j] - cv[j - 1] > 1e-3:
                        P = ref[1][g][:, start:j] @ ref[1][g][:, start:j].T
                        Q = vecs[g][:, start:j] @ vecs[g][:, start:j].T
                        proj = max(proj, float(np.abs(P - Q).max()))
                        start = j
            return v_err, resid, proj

        errs = {k: eig_errors(*r[:2]) for k, r in runs.items()}
        eig_ms = _cuda_time_ms(lambda: masked_eigh(L, mask), iters=10)
        print(f"  masked_eigh of [{L.shape[0]}, {L.shape[1]}, {L.shape[2]}] "
              f"Laplacians against the CPU's f64 call, (eigenvalues, |L v - "
              f"lambda v|, projectors): " + "; ".join(
                  f"{k} " + ", ".join(f"{e:.2e}" for e in v)
                  for k, v in errs.items())
              + f"; the card's f32 call {eig_ms:.3f} ms (CUDA events)",
              flush=True)
        c32, c64 = errs["card_f32"], errs["card_f64"]
        scale = float(torch.finfo(torch.float32).eps) * 2 * PAD_EIGVAL
        if not (c64[0] <= 1e-9 and c64[2] <= 1e-6 and c32[0] <= 10 * scale
                and c32[1] <= L.shape[-1] * scale):
            raise AssertionError(f"15d: masked_eigh card vs CPU {errs}")
        record["dense_vs_flat"] = dict(err=err, losses=losses,
                                       launches=got["dense"],
                                       masked_eigh=errs, eig_ms=eig_ms)


# ------------------------------------------------------------- phase 16
# The parallel paths.  The ranks are processes that parallel.mesh.
# spawn_ranks starts (spawn: each imports this file as a module and finds
# the _p16_* functions here); those sharing the one card talk over gloo.

P16_LR = 1e-3
P16_TIMEOUT = 600
P16_DP_KERNELS = ("K1", "K2", "K3", "K4", "K5")


def _p16_model(config, dev, dtype):
    """The config's net at its published widths, seeded (every process
    makes the same weights), and its lap_method."""
    from signnet_basisnet_tpu_torch.models import gnn_model
    from signnet_basisnet_tpu_torch.train_zinc import net_params
    from signnet_basisnet_tpu_torch.training import load_config
    cfg = load_config(config, [])
    model = gnn_model(cfg.model.model, **net_params(cfg, None))
    return model.to(dev, dtype), cfg.model.lap_method


def _p16_record(model, metrics, launches):
    return {"loss": float(metrics["loss"]), "mae": float(metrics["mae"]),
            "grads": {n: (p.grad.detach().double().cpu().numpy()
                          if p.grad is not None else None)
                      for n, p in model.named_parameters()},
            "buffers": {n: b.detach().double().cpu().numpy()
                        for n, b in model.named_buffers()},
            "launches": launches}


def _p16_ms(step, reps=5):
    """Host-clock ms of a warm step, over `reps` steps ending in a
    synchronize."""
    import torch
    step()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    return (time.time() - t0) / reps * 1e3


def _p16_dp(rank, dev, spec):
    """One build_dp_steps train step of the flagship on this rank's
    microbatches, under deterministic algorithms, with the launches it
    made; then the warm step's ms (f32)."""
    import torch
    from signnet_basisnet_tpu_torch.graph import from_arrays
    from signnet_basisnet_tpu_torch.graph import segment as seg
    from signnet_basisnet_tpu_torch.parallel import build_dp_steps
    from signnet_basisnet_tpu_torch.training import adam, make_zinc_predict
    dtype = getattr(torch, spec["dtype"])
    seg.set_agg_backend(spec["backend"])
    model, lap = _p16_model(CONFIG, dev, dtype)
    stack = [from_arrays(a).to(dev).cast_floats(dtype)
             for a in spec["micro"][rank]]
    train, _ = build_dp_steps(model, make_zinc_predict(model, lap),
                              adam(model.parameters()))
    with _deterministic():
        _reset_counts()
        m = train(stack, P16_LR, 0)
        torch.cuda.synchronize()
        out = _p16_record(model, m, _counts())
    if spec["dtype"] == "float32":
        out["ms"] = _p16_ms(lambda: train(stack, P16_LR, 0))
    seg.set_agg_backend("xla")
    return out


def _p16_collectives(step):
    """One call of `step` with each of its collectives timed alone: a
    synchronize before it and after it has ended, so that neither the
    card's queued work nor the host's next launches count.  Returns the
    collectives made, the ms spent in them and the ms of the whole step
    (which the synchronizes lengthen)."""
    import torch
    import torch.distributed as dist
    spent, made = [0.0], [0]
    saved = {name: getattr(dist, name)
             for name in ("all_reduce", "all_to_all_single")}

    def timed(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            work = fn(*args, **kwargs)
            if work is not None:
                work.wait()
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            made[0] += 1
            return work
        return call

    try:
        for name, fn in saved.items():
            setattr(dist, name, timed(fn))
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        whole = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
    return {"collectives": made[0], "collective_ms": spent[0] * 1e3,
            "step_ms": whole * 1e3}


def _p16_mp(rank, dev, spec):
    """One build_mp_steps train step of a config's net on this rank's
    shard of one batch, under deterministic algorithms, with the launches
    (none expected) and the layout; then, on the card, the warm step's ms
    (f32) and a step with its collectives timed alone.  With spec["cpu"]
    the rank runs the step on the CPU instead (gloo takes CPU tensors too),
    on half the host's cores."""
    import torch
    import torch.distributed as dist
    from signnet_basisnet_tpu_torch.parallel import (build_mp_steps,
                                                     device_arrays_mp,
                                                     partition_batch_mp,
                                                     shard_arrays_mp)
    from signnet_basisnet_tpu_torch.training import adam, make_zinc_predict
    dtype = getattr(torch, spec["dtype"])
    if spec.get("cpu"):
        dev = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    model, lap = _p16_model(spec["config"], dev, dtype)
    parts = partition_batch_mp(spec["arrays"], dist.get_world_size())
    arrs = shard_arrays_mp(device_arrays_mp(parts), rank, dev)
    arrs = {k: ({n: t.to(dtype) if t.is_floating_point() else t
                 for n, t in v.items()} if isinstance(v, dict) else v)
            for k, v in arrs.items()}
    train, _ = build_mp_steps(model, make_zinc_predict(model, lap),
                              adam(model.parameters()))
    with _deterministic():
        _reset_counts()
        m = train(arrs, P16_LR)
        out = _p16_record(model, m, _counts())
    out.update(halo=parts["halo"], shard_n=parts["shard_n"],
               e_shard=parts["edges"]["senders"].shape[1])
    if spec["dtype"] == "float32" and dev.type == "cuda":
        out["ms"] = _p16_ms(lambda: train(arrs, P16_LR))
        out["collectives"] = _p16_collectives(lambda: train(arrs, P16_LR))
    return out


def _p16_train_zinc(rank, dev, spec):
    """train_zinc.run of the flagship with train.mp = the world size."""
    from signnet_basisnet_tpu_torch.train_zinc import run
    from signnet_basisnet_tpu_torch.training import load_config
    cfg = load_config(CONFIG, spec["overrides"])
    logs = []
    _reset_counts()
    res = run(cfg, device="cuda", log=logs.append)
    return {"history": res.history, "logs": logs, "val_mae": res.val_mae,
            "test_mae": res.test_mae, "launches": _counts(),
            "train_steps": res.train_steps}


def _p16_world(rank, dev, jobs):
    """Every (function name, spec) of a world, in order, on this rank."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return [globals()[name](rank, dev, spec) for name, spec in jobs]


def _p16_nccl_probe(rank, dev):
    """One NCCL all_reduce on a CUDA tensor (two ranks, one card)."""
    import torch
    import torch.distributed as dist
    t = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return float(t[0])


def _p16_grad_errors(got, ref, exact):
    """Per tensor: |got - exact| and |ref - exact| over the largest |exact|
    (a tensor whose exact gradient is below 1e-6 of the model's largest
    is left out: 0 in exact arithmetic)."""
    import numpy as np
    top = max(float(np.abs(g).max()) for g in exact.values()
              if g is not None)
    errs = {}
    for n, e in exact.items():
        if e is None or float(np.abs(e).max()) < 1e-6 * top:
            continue
        scale = float(np.abs(e).max())
        errs[n] = (float(np.abs(got[n] - e).max()) / scale,
                   float(np.abs(ref[n] - e).max()) / scale)
    return errs


def _phase_16(record):
    """Phase 16: the parallel paths on the card (module docstring).
    Returns phase 17's jobs' results, which its two-rank world runs."""
    import numpy as np
    import torch
    from signnet_basisnet_tpu_torch import bench_scaling
    from signnet_basisnet_tpu_torch.data import (add_lap_pe, choose_budgets,
                                                 pack_batches,
                                                 synthetic_zinc)
    from signnet_basisnet_tpu_torch.graph import from_arrays
    from signnet_basisnet_tpu_torch.graph import segment as seg
    from signnet_basisnet_tpu_torch.parallel.mesh import spawn_ranks
    from signnet_basisnet_tpu_torch.training import (adam, build_steps,
                                                     make_zinc_predict)
    dev = torch.device("cuda")
    gs = synthetic_zinc(256, 0, 0, seed=0)["train"]
    add_lap_pe(gs, 8)
    nb, eb, gc = choose_budgets(gs, 128, tile=256)
    micro = pack_batches(gs, nb, eb, gc, k=8, tile=256)[:2]
    zeros = {k: 0 for k in P16_DP_KERNELS}
    rec = record.setdefault("phase16", {})

    def single(config, arrays, dtype, backend):
        """The single-device train step from the same seeded init on the
        card, under deterministic algorithms: its record, and a function
        that times its warm step (ms)."""
        seg.set_agg_backend(backend)
        model, lap = _p16_model(config, dev, dtype)
        step = build_steps(model, make_zinc_predict(model, lap),
                           adam(model.parameters()))[0]
        gb = from_arrays(arrays).to(dev).cast_floats(dtype)
        with _deterministic():
            _reset_counts()
            out = _p16_record(model, step(gb, P16_LR), _counts())
        seg.set_agg_backend("xla")

        def ms():
            seg.set_agg_backend(backend)
            try:
                return _p16_ms(lambda: step(gb, P16_LR))
            finally:
                seg.set_agg_backend("xla")
        return out, ms

    # ---------------------------------------------------------- 16a
    with Phase("16a data parallel (flagship, pallas_tile)"):
        # 16b and 16c run in the same two-rank world as 16a (one start).
        # GIN on the flagship's tiled batch: the shard boundary (node
        # 1792, 7 tiles) cuts no graph, so the halo is padding only;
        # GatedGCN on the same 128 graphs packed untiled into the same
        # 3584 slots, where the boundary cuts a graph and the halo carries
        # its rows
        mp_nets = ((CONFIG, "GIN 16x95", micro[0]),
                   (GATEDGCN_CONFIG, "GatedGCN 16x68",
                    pack_batches(gs, nb, eb, gc, k=8)[0]))
        mp_jobs = [("_p16_mp", dict(config=c, arrays=a, dtype=dt))
                   for c, _, a in mp_nets for dt in ("float32", "float64")]
        # 16b's f32 reference: the same mp steps on the CPU, run by the
        # same two ranks after every timed step
        cpu_jobs = [("_p16_mp", dict(config=c, arrays=a, dtype="float32",
                                     cpu=True)) for c, _, a in mp_nets]
        # NCCL with two ranks on the one card (recorded, not asserted:
        # NCCL is expected to refuse them) runs in a thread while the
        # single-device reference steps are taken, and ends before any
        # step is timed
        pool = ThreadPoolExecutor(1)
        nccl_probe = pool.submit(spawn_ranks, _p16_nccl_probe, 2,
                                 device="cuda", backend="nccl", timeout=60)
        pool.shutdown(wait=False)
        refs = {}
        for dt, backend in (("float32", "pallas_tile"), ("float64", "xla")):
            (a, a_ms), (b, _) = (single(CONFIG, m, getattr(torch, dt),
                                        backend) for m in micro)
            # the mean, and each tensor's scale: the larger of the two
            # steps' largest (their sum may cancel)
            refs[dt] = (a, {n: None if g is None else (
                (g + b["grads"][n]) / 2, max(float(np.abs(g).max()),
                                             float(np.abs(b["grads"][n])
                                                   .max()), 1e-30))
                for n, g in a["grads"].items()},
                {n: (v + b["buffers"][n]) / 2
                 for n, v in a["buffers"].items()}, a_ms)
        t0 = time.time()
        try:
            nccl_probe.result()
            nccl = "NCCL ran two ranks on one card"
        except RuntimeError as e:
            nccl = "refused: " + str(e).strip().splitlines()[-1][:300]
        print(f"  the NCCL probe ended {time.time() - t0:.1f} s after the "
              f"reference steps", flush=True)
        single_ms = refs["float32"][3]()
        specs = {dt: dict(backend=backend, dtype=dt)
                 for dt, backend in (("float32", "pallas_tile"),
                                     ("float64", "xla"))}
        w1 = spawn_ranks(_p16_world, 1, ([("_p16_dp", dict(
            s, micro=[micro])) for s in specs.values()],), device="cuda",
            timeout=P16_TIMEOUT)[0]
        dp2_jobs = [("_p16_dp", dict(s, micro=[[micro[0]], [micro[1]]]))
                    for s in specs.values()]
        tz = ("_p16_train_zinc", dict(overrides=[
            "train.mp", "2", "train.epochs", "2", "data.synth_train", "384",
            "data.synth_eval", "128", "train.print_epoch_interval", "1",
            "out_dir", ""]))
        # phase 17's GSPMD jobs run last in the same world (one start)
        own = dp2_jobs + mp_jobs + [tz] + cpu_jobs
        p17_jobs = _p17_jobs()
        t0 = time.time()
        w2 = spawn_ranks(_p16_world, 2, (own + p17_jobs,), device="cuda",
                         timeout=P16_TIMEOUT)
        p17_runs = [[r[len(own) + i] for r in w2]
                    for i in range(len(p17_jobs))]
        print(f"  the two-rank world (gloo, one card), phase 17's jobs "
              f"included: {time.time() - t0:.1f} s", flush=True)
        for tag, runs, n_micro in (("world 1 (NCCL), 2 microbatches",
                                    [w1[0:2]], 2),
                                   ("world 2 (gloo, one card), 1 "
                                    "microbatch a rank",
                                    [r[0:2] for r in w2], 1)):
            for rank, (r32, r64) in enumerate(runs):
                want = dict(zeros, K1=47 * n_micro)
                if r32["launches"] != want or r64["launches"] != zeros:
                    raise AssertionError(
                        f"16a {tag} rank {rank}: launches {r32['launches']}"
                        f" (f32), {r64['launches']} (f64); expected {want}")
                for dt, r in (("float32", r32), ("float64", r64)):
                    _, mean_g, mean_b, _ = refs[dt]
                    bar = 1e-6 if dt == "float32" else 1e-9
                    worst = 0.0
                    for n, gs_ in mean_g.items():
                        if gs_ is None:
                            continue
                        g, scale = gs_
                        worst = max(worst, float(np.abs(r["grads"][n] - g)
                                                 .max()) / scale)
                    bworst = max(float(np.abs(r["buffers"][n] - v).max())
                                 / max(float(np.abs(v).max()), 1e-30)
                                 for n, v in mean_b.items())
                    print(f"  16a {tag} rank {rank} {dt}: gradients within "
                          f"{worst:.2e} of the mean of the two single-"
                          f"device steps' (of the larger of each tensor's "
                          f"two largest; bar {bar:g}), BN statistics "
                          f"{bworst:.2e}; K1 "
                          f"{r['launches']['K1']} a step", flush=True)
                    if not (worst <= bar and bworst <= bar):
                        raise AssertionError(f"16a {tag} {dt}: gradients "
                                             f"{worst:.2e}, BN {bworst:.2e}")
        rec["dp"] = {
            "single_f32_ms": single_ms,
            "world1_nccl_2micro_ms": w1[0]["ms"],
            "world2_gloo_ms": max(r[0]["ms"] for r in w2)}
        print(f"  16a step ms (host clock, warm, f32, pallas_tile): single-"
              f"device 1 microbatch {rec['dp']['single_f32_ms']:.2f}; DP "
              f"world 1 over NCCL with 2 microbatches "
              f"{rec['dp']['world1_nccl_2micro_ms']:.2f}; DP world 2 over "
              f"gloo, 1 microbatch a rank, both ranks sharing the card "
              f"(overhead, not scaling) {rec['dp']['world2_gloo_ms']:.2f}",
              flush=True)
        rec["nccl_two_ranks_one_card"] = nccl
        print(f"  NCCL with two ranks on the one card: {nccl}", flush=True)

    # ---------------------------------------------------------- 16b
    with Phase("16b model parallel, mp = 2 (gloo, one card)"):
        for i, (config, name, mp_arrays) in enumerate(mp_nets):
            (s32, s32_ms), (s64, _) = (single(config, mp_arrays, dt, "xla")
                                       for dt in (torch.float32,
                                                  torch.float64))
            s32["ms"] = s32_ms()
            r32 = [r[2 + 2 * i] for r in w2]
            r64 = [r[3 + 2 * i] for r in w2]
            for r in r32 + r64:
                if r["launches"] != zeros:
                    raise AssertionError(f"16b {name}: launches "
                                         f"{r['launches']}")
            # f64: the mp step within 1e-9 of the single-device step, of
            # each tensor's largest gradient or of 1e-4 of the model's
            # largest if that is more (phase 4a's f64 bar)
            top = max(float(np.abs(g).max()) for g in s64["grads"].values()
                      if g is not None)
            f64 = max(float(np.abs(r64[0]["grads"][n] - g).max())
                      / max(float(np.abs(g).max()), 1e-4 * top)
                      for n, g in s64["grads"].items() if g is not None)
            f64_bn = max(float(np.abs(r64[0]["buffers"][n] - v).max())
                         / max(float(np.abs(v).max()), 1e-30)
                         for n, v in s64["buffers"].items())
            f64_loss = abs(r64[0]["loss"] - s64["loss"]) / abs(s64["loss"])
            # f32, as phase 13a bounds a card step: the card's mp step's
            # error against the f64 step within 10x the CPU's mp step's
            # (the same uncentred-variance BatchNorm), median over tensors
            # and worst tensor; BN statistics within 10x the CPU's + 1e-6
            cpu32 = w2[0][7 + i]
            errs = _p16_grad_errors(r32[0]["grads"], cpu32["grads"],
                                    s64["grads"])
            card_e = np.array([v[0] for v in errs.values()])
            cpu_e = np.array([v[1] for v in errs.values()])
            med = float(np.median(card_e)) / max(float(np.median(cpu_e)),
                                                 1e-12)
            gross = float(card_e.max()) / max(float(cpu_e.max()), 1e-12)
            sd_med = float(np.median([v[0] for v in _p16_grad_errors(
                s32["grads"], s32["grads"], s64["grads"]).values()]))

            def bn_err(got):
                return {n: float(np.abs(got[n] - v).max())
                        / max(float(np.abs(v).max()), 1e-30)
                        for n, v in s64["buffers"].items()}
            bn_card, bn_cpu = bn_err(r32[0]["buffers"]), bn_err(
                cpu32["buffers"])
            bn_bad = [n for n in bn_card
                      if bn_card[n] > 10 * bn_cpu[n] + 1e-6]
            # the loss and MAE likewise: their error against the f64 step
            # within 10x the CPU mp step's (+ 1e-7)
            loss32 = abs(r32[0]["loss"] - s32["loss"]) / abs(s32["loss"])
            met_bad = [k for k in ("loss", "mae")
                       if abs(r32[0][k] - s64[k]) > 10 * abs(
                           cpu32[k] - s64[k]) + 1e-7 * abs(s64[k])]
            same = all(np.array_equal(r["grads"][n], r32[0]["grads"][n])
                       for r in r32[1:] for n in r["grads"]
                       if r["grads"][n] is not None)
            H, shard_n = r32[0]["halo"], r32[0]["shard_n"]
            ms = max(r["ms"] for r in r32)
            widths = (95, 1520) if i == 0 else (68, 1088)
            print(f"  16b {name}: N = {2 * shard_n}, shard_n {shard_n}, "
                  f"edge shard {r32[0]['e_shard']}, halo H = {H} rows a "
                  f"pair: an exchange moves {2 * H} rows a rank, "
                  f"{2 * H * widths[0] * 4} bytes at the base layers' "
                  f"{widths[0]} f32 features and {2 * H * widths[1] * 4} at "
                  f"the phi's {widths[1]}; step {ms:.2f} ms (host clock, "
                  f"warm, f32; two ranks sharing the card over gloo: "
                  f"overhead, not scaling) against the single-device "
                  f"step's {s32['ms']:.2f} ms; launches 0", flush=True)
            coll = [r["collectives"] for r in r32]
            print(f"  16b {name} collectives (a step with a synchronize "
                  f"before and after each, ranks 0 / 1): "
                  + " / ".join(f"{c['collectives']} taking "
                               f"{c['collective_ms']:.2f} ms of "
                               f"{c['step_ms']:.2f}" for c in coll),
                  flush=True)
            print(f"  16b {name} f64: loss {f64_loss:.2e} apart, gradients "
                  f"within {f64:.2e}, BN statistics {f64_bn:.2e} (bar "
                  f"1e-9); f32: loss {loss32:.2e} from the single-device "
                  f"step's (the CPU mp step's "
                  f"{abs(cpu32['loss'] - s32['loss']) / abs(s32['loss']):.2e}"
                  f"); the gradients' error "
                  f"vs f64, median {float(np.median(card_e)):.2e} ("
                  f"{med:.2f}x the CPU mp step's; the single-device f32 "
                  f"step's {sd_med:.2e}), worst {gross:.2f}x the CPU's "
                  f"worst (bars 10x); BN statistics worst "
                  f"{max(bn_card.values()):.2e} (CPU mp "
                  f"{max(bn_cpu.values()):.2e}); ranks agree bit for "
                  f"bit: {same}", flush=True)
            rec[f"mp2_{name.split()[0]}"] = dict(
                halo=H, shard_n=shard_n, ms=ms, single_ms=s32["ms"],
                f64_grad=f64, f64_bn=f64_bn, f32_median_x=med,
                f32_gross_x=gross, loss32=loss32,
                bn32=max(bn_card.values()), collectives=coll)
            if not (f64 <= 1e-9 and f64_bn <= 1e-9 and f64_loss <= 1e-9
                    and med <= 10 and gross <= 10 and not met_bad
                    and not bn_bad and same):
                raise AssertionError(f"16b {name}: mp step disagrees "
                                     f"(BN {bn_bad}, metrics {met_bad})")

    # ---------------------------------------------------------- 16c
    with Phase("16c train_zinc train.mp 2 and bench_scaling"):
        tz0, tz1 = w2[0][6], w2[1][6]
        hist = [h["train_loss"] for h in tz0["history"]]
        print("\n".join("  " + s for s in tz0["logs"]), flush=True)
        print(f"  train losses {hist}; launches {tz0['launches']}",
              flush=True)
        if not (len(hist) == 2 and np.isfinite(hist).all()
                and hist[-1] < hist[0] and tz1["logs"] == []
                and tz0["launches"] == zeros):
            raise AssertionError(f"16c train_zinc mp 2: {hist}, "
                                 f"{tz0['launches']}")
        rec["train_zinc_mp2_losses"] = hist
        rec["bench_scaling"] = bench_scaling.main(["--reps", "1"])
    return p17_runs


# ------------------------------------------------------------- phase 17
# GSPMD (parallel/gspmd.py): the single-device step, unchanged, on a batch
# of DTensors sharded over two ranks that share the card over gloo (NCCL
# refuses two ranks on one card, phase 16a).  The _p17_* functions run in
# the ranks, through _p16_world.

P17_SGNN = dict(n_hid=32, n_out=1, nl_signnet=4, nl_gnn=8, nl_rho=2)
P17_WINDOWS = 2


def _p17_model(net, dev, dtype, dropout=0.1):
    """(model, predict) from one seeded init: bench_scaling's SignNetGNN
    (attention dropout `dropout` in its rho), or the flagship config's
    net."""
    from signnet_basisnet_tpu_torch.models import (SignNetGNN,
                                                   set_attention_dropout)
    from signnet_basisnet_tpu_torch.training import (make_module_predict,
                                                     make_zinc_predict)
    if net == "sgnn":
        model = SignNetGNN(**P17_SGNN).to(dev, dtype)
        set_attention_dropout(model, dropout)
        return model, make_module_predict(model)
    model, lap = _p16_model(CONFIG, dev, dtype)
    return model, make_zinc_predict(model, lap)


def _p17_record(model, opt, metrics, sums, launches):
    """A step's numbers, every tensor full and in f64 on the host."""
    full = lambda t: (t.full_tensor() if hasattr(t, "full_tensor")
                      else t).detach().double().cpu().numpy()
    return {"loss": float(metrics["loss"]), "mae": float(metrics["mae"]),
            "eval": {k: float(v) for k, v in sums.items()},
            "launches": launches,
            "grads": {n: full(p.grad) for n, p in model.named_parameters()
                      if p.grad is not None},
            "buffers": {n: full(b) for n, b in model.named_buffers()},
            "adam": {f"{n}.{k}": full(opt.state[p][k])
                     for n, p in model.named_parameters()
                     if p in opt.state for k in ("exp_avg", "exp_avg_sq")}}


class _P17Collectives:
    """Counts the collectives DTensor issues (the functional collectives
    its redistributions call) while the block runs, each timed alone as
    16b times them: a synchronize before it, and after it has ended."""

    NAMES = ("all_reduce", "all_gather_tensor", "all_gather_single",
             "reduce_scatter_tensor", "reduce_scatter_single",
             "all_to_all_single", "all_gather_inplace")

    def __init__(self):
        self.made, self.ms = {}, 0.0

    def __enter__(self):
        import torch
        import torch.distributed._functional_collectives as funcol
        self.saved = {n: getattr(funcol, n) for n in self.NAMES
                      if hasattr(funcol, n)}
        depth = [0]

        def timed(name, fn):
            def call(*args, **kwargs):
                if depth[0]:
                    return fn(*args, **kwargs)
                depth[0] += 1
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = fn(*args, **kwargs)
                    if isinstance(out, funcol.AsyncCollectiveTensor):
                        out = out.wait()
                    elif isinstance(out, torch.Tensor):
                        out = funcol.wait_tensor(out)
                    torch.cuda.synchronize()
                    self.ms += (time.perf_counter() - t0) * 1e3
                    self.made[name] = self.made.get(name, 0) + 1
                    return out
                finally:
                    depth[0] -= 1
            return call

        for n, fn in self.saved.items():
            setattr(funcol, n, timed(n, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed._functional_collectives as funcol
        for n, fn in self.saved.items():
            setattr(funcol, n, fn)
        return False


def _p17_steps(rank, dev, spec):
    """An eval step, then a train step, from one seeded init, under
    deterministic algorithms: the single-device step on rank 0 and, unless
    spec["single_only"], the GSPMD step (build_gspmd_steps over both
    ranks) on every rank, with each one's K1-K5 launches.  With
    spec["time"], the GSPMD train step's collectives are counted and timed
    alone, and P17_WINDOWS turns of one warm step follow (rank 0's
    single-device step while rank 1 waits, then the GSPMD step on both).
    The job's seconds are recorded."""
    import torch
    import torch.distributed as dist
    from signnet_basisnet_tpu_torch.graph import from_arrays
    from signnet_basisnet_tpu_torch.graph import segment as seg
    from signnet_basisnet_tpu_torch.parallel import (build_gspmd_steps,
                                                     make_mesh)
    from signnet_basisnet_tpu_torch.training import adam, build_steps
    dtype = getattr(torch, spec["dtype"])
    seg.set_agg_backend(spec["backend"])
    gb = from_arrays(spec["arrays"]).to(dev).cast_floats(dtype)
    mesh = make_mesh(dp=1, mp=dist.get_world_size(), device_type=dev.type)
    out, steps = {}, {}
    t_job = time.time()
    try:
        for how in ("single",) if spec.get("single_only") else (
                "single", "gspmd"):
            if how == "single" and rank != 0:
                continue
            model, predict = _p17_model(spec["net"], dev, dtype,
                                        spec.get("dropout", 0.1))
            opt = adam(model.parameters())
            train, ev = (build_steps(model, predict, opt) if how == "single"
                         else build_gspmd_steps(model, predict, opt, mesh,
                                                gb))
            with _deterministic():
                _reset_counts()
                sums = ev(gb)
                torch.cuda.synchronize()
                ev_l = _counts()
                _reset_counts()
                with _P17Collectives() as coll:
                    t0 = time.perf_counter()
                    m = train(gb, P16_LR)
                    torch.cuda.synchronize()
                    whole = (time.perf_counter() - t0) * 1e3
                rec = _p17_record(model, opt, m, sums,
                                  {"eval": ev_l, "train": _counts()})
            out[how] = rec if rank == 0 else {
                k: rec[k] for k in ("loss", "mae", "eval", "launches")}
            if how == "gspmd" and spec.get("time"):
                out["collectives"] = {"made": coll.made, "ms": coll.ms,
                                      "step_ms": whole}
            steps[how] = train
        if spec.get("time"):
            ms = {"single": [], "gspmd": []}
            for _ in range(P17_WINDOWS):
                for how in ("single", "gspmd"):
                    dist.barrier()
                    if how == "gspmd" or rank == 0:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        steps[how](gb, P16_LR)
                        torch.cuda.synchronize()
                        ms[how].append((time.perf_counter() - t0) * 1e3)
            out["ms"] = ms
    finally:
        seg.set_agg_backend("xla")
    out["s"] = time.time() - t_job
    return out


def _p17_f64_errors(got, want):
    """Per gradient, BN statistic and Adam moment: |got - want| over the
    larger of the tensor's largest |want| and 1e-4 of the largest of its
    kind (16b's bar: a tensor that is 0 in exact arithmetic keeps only
    f64 rounding)."""
    import numpy as np
    errs = {}
    for kind in ("grads", "buffers", "adam"):
        top = max(float(np.abs(v).max()) for v in want[kind].values())
        for n, v in want[kind].items():
            scale = max(float(np.abs(v).max()), 1e-4 * top, 1e-300)
            errs[f"{kind} {n}"] = float(np.abs(got[kind][n] - v).max()) \
                / scale
    return errs


def _p17_check(tag, runs, f64_ref, record):
    """Hold a GSPMD run to its single-device step: in f64 the loss, MAE and
    eval sums 1e-12 relative and `_p17_f64_errors` 1e-10; in f32 the loss,
    MAE and eval sums 1e-5 relative of the single-device f32 step's, and
    the gradients' distance from the f64 single-device step (`f64_ref`,
    from the same init and dropout), each over its tensor's largest
    (`_p16_grad_errors`), within twice the single-device f32 step's: the
    median over tensors and the worst tensor (phase 16b's form).  Both
    ranks' GSPMD metrics must agree."""
    import numpy as np
    s, g = runs[0]["single"], runs[0]["gspmd"]
    for r in runs[1:]:
        if (r["gspmd"]["loss"], r["gspmd"]["eval"]) != (g["loss"],
                                                        g["eval"]):
            raise AssertionError(f"{tag}: the ranks' GSPMD steps differ")
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-300)
    metrics = [rel(g["loss"], s["loss"]), rel(g["mae"], s["mae"])] + [
        rel(g["eval"][k], s["eval"][k]) for k in ("loss_sum", "mae_sum", "n")]
    res = dict(loss=(g["loss"], s["loss"]), metrics_worst=max(metrics),
               launches={"gspmd": g["launches"], "single": s["launches"]})
    if f64_ref is None:
        errs = _p17_f64_errors(g, s)
        worst = max(errs, key=errs.get)
        res.update(worst=errs[worst], worst_at=worst)
        print(f"  {tag}: loss {g['loss']:.15g} vs single-device "
              f"{s['loss']:.15g}; loss, MAE and eval sums within "
              f"{max(metrics):.2e} relative (bar 1e-12); every gradient, BN "
              f"statistic and Adam moment within {errs[worst]:.2e} (bar "
              f"1e-10; worst {worst})", flush=True)
        ok = max(metrics) <= 1e-12 and errs[worst] <= 1e-10
    else:
        errs = _p16_grad_errors(g["grads"], s["grads"], f64_ref["grads"])
        got = np.array([v[0] for v in errs.values()])
        own = np.array([v[1] for v in errs.values()])
        med = float(np.median(got)) / max(float(np.median(own)), 1e-30)
        gross = float(got.max()) / max(float(own.max()), 1e-30)
        per = {n: v[0] / max(v[1], 1e-30) for n, v in errs.items()}
        top = max(per, key=per.get)
        res.update(median_x=med, worst_x=gross, per_tensor_top=(top,
                                                                per[top]))
        print(f"  {tag}: loss {g['loss']:.8g} vs single-device "
              f"{s['loss']:.8g}; loss, MAE and eval sums within "
              f"{max(metrics):.2e} relative (bar 1e-5); the gradients' "
              f"distance from the f64 single-device step, of each tensor's "
              f"largest: median {float(np.median(got)):.2e} ({med:.2f}x the "
              f"single-device f32 step's {float(np.median(own)):.2e}), "
              f"worst {float(got.max()):.2e} ({gross:.2f}x its "
              f"{float(own.max()):.2e}; bars 2x); the largest ratio of one "
              f"tensor {per[top]:.2f} at {top}", flush=True)
        ok = max(metrics) <= 1e-5 and med <= 2 and gross <= 2
    record[tag] = res
    if not ok:
        raise AssertionError(f"{tag}: the GSPMD step departs from the "
                             f"single-device step ({res})")


def _p17_jobs():
    """Phase 17's (function name, spec) jobs for its two ranks."""
    from signnet_basisnet_tpu_torch.bench_scaling import make_global
    from signnet_basisnet_tpu_torch.data import (add_lap_pe, choose_budgets,
                                                 pack_batches,
                                                 synthetic_zinc)
    sgnn = make_global(2)
    gs = synthetic_zinc(128, 0, 0, seed=0)["train"]
    add_lap_pe(gs, 8)
    nb, eb, gc = choose_budgets(gs, 128, tile=256)
    flag = pack_batches(gs, nb, eb, gc, k=8, tile=256)[0]
    # 17a: f64 with the attention dropout on (the GSPMD step must draw the
    # single-device masks); f32 with it off, against an f64 single-device
    # step with it off: the card's bernoulli_ draws other masks in f64
    # than in f32, so an f32 step with dropout has no f64 reference
    sgnn_job = lambda **kw: ("_p17_steps", dict(net="sgnn", arrays=sgnn,
                                                backend="xla", **kw))
    jobs = [sgnn_job(dtype="float64", dropout=0.1),
            sgnn_job(dtype="float64", dropout=0.0, single_only=True),
            sgnn_job(dtype="float32", dropout=0.0)]
    # 17b: the f32 rule on the main path (pallas_tile); xla in f64
    jobs += [("_p17_steps", dict(net="flagship", arrays=flag, dtype=dt,
                                 backend=b, time=b == "pallas_tile"))
             for dt, b in (("float64", "xla"), ("float32", "pallas_tile"))]
    return jobs


def _phase_17(record, runs=None):
    """Phase 17: GSPMD on the card (module docstring).  `runs`: each job
    of `_p17_jobs()`'s results on both ranks, from phase 16's two-rank
    world, which runs them after its own; without them (the phase run
    alone) it starts a world of its own."""
    import numpy as np
    from signnet_basisnet_tpu_torch.parallel.mesh import spawn_ranks
    from signnet_basisnet_tpu_torch.utils import card_label
    rec = record.setdefault("phase17", {})
    jobs = _p17_jobs()
    sgnn, flag = jobs[0][1]["arrays"], jobs[3][1]["arrays"]
    with Phase("17a GSPMD vs single-device (SignNetGNN 32, 2 ranks)"):
        if runs is None:
            t0 = time.time()
            w = spawn_ranks(_p16_world, 2, (jobs,), device="cuda",
                            backend="gloo", timeout=P16_TIMEOUT)
            runs = [[r[i] for r in w] for i in range(len(jobs))]
            print(f"  the two-rank world (gloo, one card): "
                  f"{time.time() - t0:.1f} s", flush=True)
        print("  the jobs' seconds (rank 0): " + ", ".join(
            f"{s['net']} {s['dtype']} {s['backend']} {r[0]['s']:.1f}"
            for (_, s), r in zip(jobs, runs)), flush=True)
        print(f"  bench_scaling's SignNetGNN(32, 1, 4, 8, 2) on "
              f"make_global(2): N = {sgnn['node_mask'].shape[0]}, E = "
              f"{sgnn['edge_mask'].shape[0]}; attention dropout 0.1 in "
              f"f64, 0 in f32", flush=True)
        _p17_check("17a f64", runs[0], None, rec)
        _p17_check("17a f32", runs[2], runs[1][0]["single"], rec)
    with Phase("17b GSPMD vs single-device (flagship GIN 16x95)"):
        print(f"  the flagship step: N = {flag['node_mask'].shape[0]}, E = "
              f"{flag['edge_mask'].shape[0]}, 256-node tiles", flush=True)
        _p17_check("17b xla f64", runs[3], None, rec)
        _p17_check("17b pallas_tile f32", runs[4], runs[3][0]["single"],
                   rec)
        zeros = {k: 0 for k in P16_DP_KERNELS}
        for i, backend in ((3, "xla"), (4, "pallas_tile")):
            k1 = (47, 24) if backend == "pallas_tile" else (0, 0)
            want = {"train": dict(zeros, K1=k1[0]),
                    "eval": dict(zeros, K1=k1[1])}
            for rank, r in enumerate(runs[i]):
                for how, step in r.items():
                    if how in ("single", "gspmd") and (step["launches"]
                                                      != want):
                        raise AssertionError(
                            f"17b {backend} rank {rank} {how}: launches "
                            f"{step['launches']}, expected {want}")
        print(f"  K1 launches under pallas_tile, each rank's GSPMD step: "
              f"{runs[4][0]['gspmd']['launches']['train']['K1']} a train "
              f"step, {runs[4][0]['gspmd']['launches']['eval']['K1']} an "
              f"eval step (rank 1: "
              f"{runs[4][1]['gspmd']['launches']['train']['K1']}, "
              f"{runs[4][1]['gspmd']['launches']['eval']['K1']}); no K2-K5",
              flush=True)
    with Phase("17c GSPMD step times and collectives"):
        card = card_label()

        def spread(v):
            return (f"median {float(np.median(v)):.2f} (min {min(v):.2f}, "
                    f"max {max(v):.2f})")
        r0, r1 = runs[4]
        single = r0["ms"]["single"]
        gspmd = [max(a, b) for a, b in zip(r0["ms"]["gspmd"],
                                           r1["ms"]["gspmd"])]
        coll = [r0["collectives"], r1["collectives"]]
        print(f"  17c flagship pallas_tile f32 ({card}; host clock, warm, "
              f"{P17_WINDOWS} steps of each in turns; two ranks sharing the "
              f"card over gloo: overhead, not scaling; bench_scaling times "
              f"the SignNetGNN): GSPMD {spread(gspmd)} ms a step, "
              f"single-device {spread(single)}; the first GSPMD train "
              f"step's collectives (each with a synchronize before and "
              f"after, ranks 0 / 1): " + " / ".join(
                  f"{sum(c['made'].values())} {c['made']} taking "
                  f"{c['ms']:.2f} ms of {c['step_ms']:.2f}" for c in coll),
              flush=True)
        rec["17c"] = dict(gspmd_ms=gspmd, single_ms=single,
                          collectives=coll)

def main():
    _fail_without_checkout_or_card()
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from signnet_basisnet_tpu_torch.data import (add_full_evd, add_lap_pe,
                                                 choose_budgets,
                                                 pack_batches,
                                                 synthetic_zinc)
    from signnet_basisnet_tpu_torch.graph import edge_csr, from_arrays
    from signnet_basisnet_tpu_torch.graph import segment as seg
    from signnet_basisnet_tpu_torch.models import gnn_model
    from signnet_basisnet_tpu_torch.models.conv import batch_csr
    from signnet_basisnet_tpu_torch.ops import _nvcc
    attn = importlib.import_module(
        "signnet_basisnet_tpu_torch.ops.edge_attention")
    spmm_mod = importlib.import_module(
        "signnet_basisnet_tpu_torch.ops.spmm_tiled")
    gate_mod = importlib.import_module(
        "signnet_basisnet_tpu_torch.ops.gatedgcn_gate")
    flat_mod = importlib.import_module(
        "signnet_basisnet_tpu_torch.ops.spmm_flat")
    stamp_mod = importlib.import_module(
        "signnet_basisnet_tpu_torch.ops.timer_stamp")
    from signnet_basisnet_tpu_torch import bench, bench_ops
    from signnet_basisnet_tpu_torch.ops.spmm_tiled import (
        _launch, _tile_mask, edge_in_range, spmm_tiled, spmm_tiled_plain)
    from signnet_basisnet_tpu_torch.train_zinc import net_params, run
    from signnet_basisnet_tpu_torch.utils import nan_filled_empty
    from signnet_basisnet_tpu_torch.utils.profiling import (
        device_kernel_counts, device_kernels)
    from signnet_basisnet_tpu_torch.training import (adam, build_steps,
                                                     capture_train_step,
                                                     load_config,
                                                     make_zinc_predict)
    from signnet_basisnet_tpu_torch.training.train import CAPTURE_WARMUP
    from signnet_basisnet_tpu_torch.utils import profiling
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    os.makedirs(OUT_DIR, exist_ok=True)
    record = {}

    # ---------------------------------------------------------------- 0
    with Phase("0 card and build"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        record["card"] = smi
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}", flush=True)
        _build_all([spmm_mod, attn, gate_mod, flat_mod, stamp_mod])
        instances = {}
        for name, info in _nvcc.build_info.items():
            print(f"{name}: nvcc {info['seconds']:.1f} s -> "
                  f"{os.path.relpath(info['path'], ROOT)}", flush=True)
            for label, regs, st, ld in _ptxas_summary(info["ptxas"]):
                print(f"  ptxas: {label}: {regs} registers, {st} bytes "
                      f"spill stores, {ld} bytes spill loads", flush=True)
                instances[label] = (regs, st, ld)
        record["nvcc_seconds"] = {k: v["seconds"]
                                  for k, v in _nvcc.build_info.items()}
        record["ptxas"] = instances
        # K1 (types x vector widths x lanes per row x directions), K2 and
        # K3 (types x layouts), K4 (types), K5 (types x vector widths x
        # lanes per row): every instance named, none spilling
        prefixes = {"K1": ("spmm_tiled_kernel<",),
                    "K2": ("attn_fwd_kernel<", "attn_fwd_vec_kernel<"),
                    "K3": ("attn_bwd_kernel<", "attn_bwd_vec_kernel<"),
                    "K4": ("gate_kernel<",),
                    "K5": ("spmm_flat_kernel<",)}
        expected = {"K1": 48, "K2": 4, "K3": 4, "K4": 2, "K5": 8}
        found = {k: sorted(i for i in instances if i.startswith(p))
                 for k, p in prefixes.items()}
        if {k: len(v) for k, v in found.items()} != expected:
            raise AssertionError(f"expected {expected} instances in the "
                                 f"ptxas report, found {found}")
        spilled = {i: instances[i] for v in found.values() for i in v
                   if instances[i][1] or instances[i][2]}
        if spilled:
            raise AssertionError(f"K1-K5 instances spill: {spilled}")

    # ---------------------------------------------------------------- 1
    with Phase("1 kernel vs plain"):
        gs = synthetic_zinc(512, 0, 0, seed=0)["train"]
        add_lap_pe(gs, 8)
        nb, eb, gc = choose_budgets(gs, 128, tile=256)
        arrays = pack_batches(gs, nb, eb, gc, k=8, tile=256)[0]
        gb = from_arrays(arrays).to(dev)
        bn = 256
        n_tiles = gb.extras["tile_starts"].shape[0]
        print(f"main-path batch: N={nb} ({n_tiles} tiles of {bn}), E={eb}, "
              f"{gc} graph slots, {int(arrays['edge_mask'].sum())} real "
              "edges", flush=True)
        args = (gb.senders, gb.receivers, gb.edge_mask,
                gb.extras["tile_starts"], gb.extras["tile_ends"])
        csr = batch_csr(gb)
        gen = torch.Generator(device=dev).manual_seed(0)
        max_err = 0.0
        # f32: fixed-order f32 sums on both sides, 1e-5; bf16: both round an
        # f32 sum once, so at most one bf16 ulp apart (2**-8 relative)
        tols = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -7, 1e-3)}

        def check(name, got, ref, dtype):
            nonlocal max_err
            rtol, atol = tols[dtype]
            err = (got.float() - ref.float()).abs()
            bad = ~(err <= atol + rtol * ref.float().abs())  # NaN is bad
            max_err = _worst(max_err, float(err.max()))
            print(f"  {name}: max_abs_err {float(err.max()):.3e} "
                  f"(tol {atol:g} + {rtol:g}*|ref|)", flush=True)
            if bool(bad.any()):
                raise AssertionError(f"{name}: kernel disagrees with its plain "
                                     f"version at {int(bad.sum())} entries")

        # every F a path launches K1 with (GIN 16, 95, 1520; the GatedGCN
        # phi 1088; the GIN LapPE layers 122; the masked GatedGCN phi 74 and
        # 74 * 67 = 4958, which
        # takes the one-element loads; the GAT and PNA phis 896 and 1120;
        # bench_ops 128), 256 and 512 (32 and 64 lanes per row): each picks
        # its own variant
        for feat in K1_FEATS + (256, 512):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(nb, feat, device=dev, generator=gen).to(dtype)
                variant = spmm_mod.kernel_variant(feat, dtype, True, bn)
                for transpose in (False, True):
                    got = _launch(x, *args, csr, bn, transpose)
                    ref = spmm_tiled_plain(x, *args, bn, transpose=transpose)
                    check(f"F={feat} {str(dtype)[6:]} (vec, group) {variant} "
                          f"{'transposed' if transpose else 'forward'}",
                          got, ref, dtype)
        # autograd through the wrapper (forward + transposed kernel)
        x = torch.randn(nb, 95, device=dev, generator=gen, requires_grad=True)
        c = torch.randn(nb, 95, device=dev, generator=gen)
        (spmm_tiled(x, *args, nb, bn, csr) * c).sum().backward()
        xr = x.detach().clone().requires_grad_(True)
        (spmm_tiled_plain(xr, *args, bn) * c).sum().backward()
        check("autograd dx F=95 f32", x.grad, xr.grad, torch.float32)
        # a batch with non-tile-local edges: 5% of the real edges get a
        # source in another tile; both versions must drop them
        s_far = gb.senders.clone()
        real = torch.nonzero(gb.edge_mask > 0)[:, 0]
        pick = real[torch.randperm(real.numel(), device=dev,
                                   generator=gen)[:real.numel() // 20]]
        s_far[pick] = (s_far[pick] + bn) % nb
        far_args = (s_far,) + args[1:]
        far_csr = edge_csr(s_far, gb.receivers, nb)
        kept = _tile_mask(*far_args[:2], *far_args[3:], bn)
        assert int((~kept & (gb.edge_mask > 0)).sum()) == pick.numel()
        for feat, transpose in itertools.product((1520, 95), (False, True)):
            x = torch.randn(nb, feat, device=dev, generator=gen)
            got = _launch(x, *far_args, far_csr, bn, transpose)
            ref = spmm_tiled_plain(x, *far_args, bn, transpose=transpose)
            drop = spmm_tiled_plain(x, s_far, gb.receivers,
                                    gb.edge_mask * kept, *args[3:], bn,
                                    transpose=transpose)
            check(f"non-local edges F={feat} "
                  f"{'transposed' if transpose else 'forward'}",
                  got, ref, torch.float32)
            check("  ... same as with them removed", got, drop,
                  torch.float32)

        # times in f32 at every F a path launches K1 with, forward and
        # transposed, cold (L2 flushed before each launch, as the main path
        # finds x) and warm; torch.sparse.mm on a CSR matrix of the counted
        # edges as the yardstick at each of them.  The bound of this
        # batch's work: x read only at the rows that counted edges reach
        # (forward: their sources; transposed: their destinations), the
        # output written at every row once, and the index arrays the kernel
        # reads once each (forward: senders, weights, dst_ptr; transposed:
        # src_order, receivers, weights, src_ptr; both: the tile ranges);
        # 2 flops per counted edge and feature
        flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
        ok = _tile_mask(gb.senders, gb.receivers, *args[3:], bn)
        counted = ok & (gb.edge_mask != 0)
        n_counted = int(counted.sum())
        rows_read = {False: int(torch.unique(gb.senders[counted]).numel()),
                     True: int(torch.unique(gb.receivers[counted]).numel())}
        n_index = {False: 2 * eb + nb + 1, True: 3 * eb + nb + 1}
        rows, cols = gb.receivers.long()[ok], gb.senders.long()[ok]
        a_csr = torch.sparse_coo_tensor(
            torch.stack([rows, cols]), gb.edge_mask[ok], (nb, nb),
            check_invariants=True).coalesce().to_sparse_csr()
        k1_times = {}
        for feat in K1_FEATS:
            x = torch.randn(nb, feat, device=dev, generator=gen)
            t = {"variant": spmm_mod.kernel_variant(feat, x.dtype, True, bn)}
            for transpose in (False, True):
                fn = lambda: _launch(x, *args, csr, bn, transpose)
                d = "transposed" if transpose else "forward"
                t[f"{d}_cold_ms"] = _cuda_time_ms(fn, flush=flush)
                t[f"{d}_warm_ms"] = _cuda_time_ms(fn)
                t[f"{d}_profiler_us"] = _profiled_kernel_us(
                    fn, "spmm_tiled_kernel")
                bytes_moved = ((rows_read[transpose] + nb) * feat * 4
                               + (n_index[transpose] + 2 * n_tiles) * 4)
                t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
                t_ops = 2 * n_counted * feat / PEAK_F32_FLOP_PER_S * 1e3
                t[f"{d}_bound_ms"] = max(t_bytes, t_ops)
                t[f"{d}_bound_by"] = ("bytes" if t_bytes >= t_ops
                                      else "operations")
                t[f"{d}_bytes"] = bytes_moved
            lib = torch.sparse.mm(a_csr, x)
            check(f"library torch.sparse.mm F={feat} vs plain (yardstick)",
                  lib, spmm_tiled_plain(x, *args, bn), torch.float32)
            t["library_ms"] = _cuda_time_ms(
                lambda: torch.sparse.mm(a_csr, x), flush=flush)
            t["plain_ms"] = _cuda_time_ms(
                lambda: spmm_tiled_plain(x, *args, bn), flush=flush)
            print(f"spmm_tiled F={feat} f32 (vec, group) {t['variant']}: "
                  + "; ".join(
                      f"{d} {t[f'{d}_cold_ms'] * 1e3:.2f} us cold, "
                      f"{t[f'{d}_warm_ms'] * 1e3:.2f} us warm "
                      f"(profiler {t[f'{d}_profiler_us']} us), bound "
                      f"{t[f'{d}_bound_ms'] * 1e3:.2f} us by "
                      f"{t[f'{d}_bound_by']} ({t[f'{d}_bytes'] / 1e6:.2f} "
                      f"MB), cold / bound "
                      f"{t[f'{d}_cold_ms'] / t[f'{d}_bound_ms']:.2f}"
                      for d in ("forward", "transposed"))
                  + f"; library_ms {t['library_ms'] * 1e3:.2f} us "
                    "(torch.sparse.mm, CSR)"
                  + f"; plain_ms {t['plain_ms'] * 1e3:.2f} us", flush=True)
            k1_times[feat] = t
        print(f"  {n_counted} counted edges; x read at {rows_read[False]} "
              f"(forward) and {rows_read[True]} (transposed) of {nb} rows",
              flush=True)
        # yardsticks of the timer and the card: the timer's floor (a
        # one-element add_) and a plain copy of x at F = 1520 (read and
        # write 21.8 MB each), cold and warm
        one = torch.zeros(1, device=dev)
        x = torch.randn(nb, 1520, device=dev, generator=gen)
        for name, fn in (("floor", lambda: one.add_(1.0)),
                         ("copy_1520", lambda: x.clone())):
            record[f"{name}_ms"] = {"cold": _cuda_time_ms(fn, flush=flush),
                                    "warm": _cuda_time_ms(fn)}
        print(f"  yardsticks: a one-element add_ "
              f"{record['floor_ms']['cold'] * 1e3:.2f} us cold, "
              f"{record['floor_ms']['warm'] * 1e3:.2f} us warm (the "
              f"timer's floor); x.clone() of [{nb}, 1520] f32 "
              f"({2 * x.numel() * 4 / 1e6:.1f} MB moved) "
              f"{record['copy_1520_ms']['cold'] * 1e3:.2f} us cold, "
              f"{record['copy_1520_ms']['warm'] * 1e3:.2f} us warm",
              flush=True)
        # cross-check of the event times: the profiler's device time of the
        # kernel itself (CUPTI), warm L2, back to back
        x = torch.randn(nb, 1520, device=dev, generator=gen)
        prof_us = _profiled_kernel_us(
            lambda: _launch(x, *args, csr, bn, False), "spmm_tiled_kernel")
        print(f"  profiler: spmm_tiled_kernel F=1520 {prof_us} us per launch "
              "(warm L2)", flush=True)
        t = k1_times[1520]
        record.update(kernel_profiler_us_warm=prof_us, k1_times=k1_times)
        kern = dict(name="spmm_tiled", route="cuda",
                    source="signnet_basisnet_tpu_torch/ops/csrc/spmm_tiled.cu",
                    replaces="signnet_basisnet_tpu/ops/pallas_spmm.py:245",
                    launches=None, max_abs_err=max_err,
                    ms=t["forward_cold_ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["forward_bound_ms"],
                    bound_by=t["forward_bound_by"],
                    library_ms=t["library_ms"])
        del x, flush, a_csr, lib

    with Phase("1b attention kernels (K2, K3) vs plain"):
        tiled = attn.edge_softmax_attention_tiled
        plain = attn.edge_softmax_attention_plain
        # K2's output: f32, 1e-5 (f32 sums in other orders); bf16, one
        # bf16 ulp (2**-7 relative) + 1e-3.  K3 at its launch, against
        # `edge_attention_bwd_plain` from the same ghat and c: f32 results
        # from either input type, 1e-4 relative + 1e-5 of the tensor's
        # largest magnitude (at least 1e-5), since both subtract c from
        # sums of that magnitude and lose a digit to the cancellation.  The
        # whole autograd path (K2, the glue, K3) against autograd through
        # the plain version, in f32, to the same
        errs = {"K2": 0.0, "K3": 0.0}
        f32_tol, bf16_tol = (1e-5, 1e-5), (2 ** -7, 1e-3)
        grad_tol = (1e-4, None)

        def attn_check(kname, name, got, ref, tol):
            rtol, atol = tol
            ref = ref.detach().float()
            if atol is None:
                atol = 1e-5 * max(1.0, float(ref.abs().max()))
            err = (got.detach().float() - ref).abs()
            errs[kname] = _worst(errs[kname], float(err.max()))
            print(f"  {name}: max_abs_err {float(err.max()):.3e} "
                  f"(tol {atol:g} + {rtol:g}*|ref|)", flush=True)
            if bool((~(err <= atol + rtol * ref.abs())).any()):  # NaN is bad
                raise AssertionError(f"{name}: kernel disagrees with its "
                                     "plain version")

        def attn_inputs(H, D, dtype):
            # Q scaled by 3: about a tenth of the scores lie beyond +-5,
            # where the clamp passes no gradient
            mk = lambda *shape: torch.randn(*shape, device=dev,
                                            generator=gen)
            qkve = [mk(nb, H, D) * 3, mk(nb, H, D), mk(nb, H, D),
                    mk(eb, H, D)]
            return [t.to(dtype).requires_grad_(True) for t in qkve]

        def fwd_bwd(fn, qkve, g):
            out = fn(*qkve)
            return [out] + list(torch.autograd.grad(out, qkve,
                                                    g.to(out.dtype)))

        names = ("dQ", "dK", "dV", "dE1")

        def attn_compare(tag, edge_args, edge_csr_, H, D, dtype, autograd):
            qkve = attn_inputs(H, D, dtype)
            g = torch.randn(nb, H, D, device=dev, generator=gen)
            Q, K, V, E1 = (t.detach() for t in qkve)
            # K2 allocates out and den without filling them and must write
            # every row: each entry starts as NaN
            with nan_filled_empty():
                out, den = attn._launch_fwd(Q, K, V, E1, edge_args[0],
                                            edge_args[2], *edge_args[3:],
                                            edge_csr_[0], bn)
            attn_check("K2", f"K2 {tag} out", out,
                       plain(Q, K, V, E1, *edge_args, bn),
                       f32_tol if dtype == torch.float32 else bf16_tol)
            attn_check("K2", f"K2 {tag} den", den,
                       attn.edge_softmax_den_plain(Q, K, E1, *edge_args, bn),
                       f32_tol)
            ghat = g / (den[:, :, None] + 1e-6)
            c = (out.float() * ghat).sum(-1)
            # K3 allocates dE1 without zeroing it and must write every
            # slot: leave NaNs in the memory the allocator hands it next
            torch.full(E1.shape, float("nan"), device=dev)
            with nan_filled_empty():
                got = attn._launch_bwd(Q, K, V, E1, ghat, c, *edge_args,
                                       edge_csr_, bn)
            want = attn.edge_attention_bwd_plain(Q, K, V, E1, ghat, c,
                                                 *edge_args, bn)
            for nm, a, b in zip(names, got, want):
                attn_check("K3", f"K3 {tag} {nm}", a, b, grad_tol)
            if autograd:
                got = fwd_bwd(lambda *a: tiled(*a, *edge_args, bn, edge_csr_),
                              qkve, g)
                ref = fwd_bwd(lambda *a: plain(*a, *edge_args, bn), qkve, g)
                for nm, a, b in zip(("out",) + names, got, ref):
                    attn_check("K3" if nm != "out" else "K2",
                               f"autograd {tag} {nm}", a, b, grad_tol)

        for H, D in ((8, 8), (8, 10), (8, 7)):
            for dtype in (torch.float32, torch.bfloat16):
                layout = ("vector" if attn.bwd_variant(H, D, True)
                          else "general")
                attn_compare(f"H={H} D={D} {str(dtype)[6:]} (K2/K3 {layout})",
                             args, csr, H, D, dtype,
                             autograd=dtype == torch.float32)
        # the batch with non-tile-local edges of phase 1: dropped by both
        attn_compare("non-local edges H=8 D=8 float32 (K2/K3 vector)",
                     far_args, far_csr, 8, 8, torch.float32, autograd=True)
        # the general layout on that batch too, in both types
        for dtype in (torch.float32, torch.bfloat16):
            attn_compare(f"non-local edges H=8 D=10 {str(dtype)[6:]} "
                         "(K2/K3 general)", far_args, far_csr, 8, 10, dtype,
                         autograd=False)

        # times at the slice's shapes: H = 8 heads of D = 8, f32
        H, D = 8, 8
        F = H * D
        Q, K, V, E1 = (t.detach() for t in attn_inputs(H, D, torch.float32))
        flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
        fwd_args = (Q, K, V, E1, gb.senders, gb.edge_mask, *args[3:],
                    csr[0], bn)
        k2_ms = _cuda_time_ms(lambda: attn._launch_fwd(*fwd_args),
                              flush=flush)
        out, den = attn._launch_fwd(*fwd_args)
        g = torch.randn(nb, H, D, device=dev, generator=gen)
        ghat = g / (den[:, :, None] + 1e-6)
        c = (out * ghat).sum(-1)
        bwd_args = (Q, K, V, E1, ghat, c, gb.senders, gb.receivers,
                    gb.edge_mask, *args[3:], csr, bn)
        k3_ms = _cuda_time_ms(lambda: attn._launch_bwd(*bwd_args),
                              flush=flush)
        warm = {"K2": _cuda_time_ms(lambda: attn._launch_fwd(*fwd_args)),
                "K3": _cuda_time_ms(lambda: attn._launch_bwd(*bwd_args))}
        print(f"  warm (CUDA events, L2 not flushed): K2 "
              f"{warm['K2'] * 1e3:.2f} us, K3 {warm['K3'] * 1e3:.2f} us "
              f"(K2/K3 layout: {'vector' if attn.bwd_variant(H, D, True) else 'general'})",
              flush=True)
        record.update(attention_warm_ms=warm)
        # the same launches on the batch without its padding edges (weight
        # 0, all on its last node and last in the edge arrays, so that one
        # row's warp walks them 32 at a time): how much of each kernel's
        # time that row's tail takes
        n_real = int((gb.edge_mask != 0).sum())
        assert bool((gb.edge_mask[:n_real] != 0).all())
        cut = [a[:n_real].contiguous() for a in (gb.senders, gb.receivers,
                                                 gb.edge_mask, E1)]
        lims = [torch.clamp(a, max=n_real) for a in args[3:]]
        csr_cut = edge_csr(cut[0], cut[1], nb)
        k2_cut_ms = _cuda_time_ms(lambda: attn._launch_fwd(
            Q, K, V, cut[3], cut[0], cut[2], *lims, csr_cut[0], bn),
            flush=flush)
        k3_cut_ms = _cuda_time_ms(lambda: attn._launch_bwd(
            Q, K, V, cut[3], ghat, c, *cut[:3], *lims, csr_cut, bn),
            flush=flush)
        k2_cut_warm_ms = _cuda_time_ms(lambda: attn._launch_fwd(
            Q, K, V, cut[3], cut[0], cut[2], *lims, csr_cut[0], bn))
        print(f"  without the {eb - n_real} padding edges: K2 "
              f"{k2_cut_ms:.4f} ms cold, {k2_cut_warm_ms:.4f} ms warm; K3 "
              f"{k3_cut_ms:.4f} ms cold", flush=True)
        record.update(attention_no_padding_ms={"K2": k2_cut_ms,
                                               "K2_warm": k2_cut_warm_ms,
                                               "K3": k3_cut_ms})
        k2_plain_ms = _cuda_time_ms(lambda: plain(Q, K, V, E1, *args, bn),
                                    flush=flush)
        k3_plain_ms = _cuda_time_ms(
            lambda: attn.edge_attention_bwd_plain(
                Q, K, V, E1, ghat, c, *args, bn), flush=flush)
        # bounds of this batch's work.  Bytes: each input read once where
        # the counted edges need it (Q at the rows they reach as
        # destinations, K and V as sources, E1 and ghat/c per counted edge
        # and destination row), each output written once at every row or
        # edge slot, and the index arrays each kernel reads.  Operations
        # (f32, outside the tensor cores), per counted edge: K2 the F
        # products K*Q*E1 (2 each), their per-head sums, the weighted V sum
        # (2 each) and ~5 per head for clamp, exp and den; K3 both passes'
        # recomputed scores and V.ghat sums (6 F) and their four gradient
        # products (7 F), ~12 per head
        ok = _tile_mask(gb.senders, gb.receivers, *args[3:], bn) & (
            gb.edge_mask != 0)
        n_counted = int(ok.sum())
        dst_rows = int(torch.unique(gb.receivers[ok]).numel())
        src_rows = int(torch.unique(gb.senders[ok]).numel())
        fb = 4

        def attn_bounds_at(H, F):
            k2_bytes = ((dst_rows + 2 * src_rows + n_counted) * F * fb
                        + nb * F * fb + nb * H * 4
                        + (2 * eb + nb + 1 + 2 * n_tiles) * 4)
            k2_ops = n_counted * (5 * F + 5 * H) + nb * F
            k3_bytes = ((dst_rows + 2 * src_rows + n_counted) * F * fb
                        + dst_rows * (F + H) * 4 + 3 * nb * F * 4
                        + eb * F * 4 + (4 * eb + 2 * (nb + 1) + 2 * n_tiles)
                        * 4)
            k3_ops = n_counted * (20 * F + 12 * H) + nb * F
            out = {}
            for kname, nbytes, ops_ in (("K2", k2_bytes, k2_ops),
                                        ("K3", k3_bytes, k3_ops)):
                t_b = nbytes / PEAK_BYTES_PER_S * 1e3
                t_o = ops_ / PEAK_F32_FLOP_PER_S * 1e3
                out[kname] = dict(
                    bound_ms=max(t_b, t_o),
                    bound_by="bytes" if t_b >= t_o else "operations",
                    bytes=nbytes, ops=ops_)
            return out

        attn_bounds = attn_bounds_at(H, F)
        for kname, k_ms, p_ms in (("K2", k2_ms, k2_plain_ms),
                                  ("K3", k3_ms, k3_plain_ms)):
            b = attn_bounds[kname]
            print(f"{kname} H=8 D=8 f32: kernel_ms {k_ms:.4f}, plain_ms "
                  f"{p_ms:.4f}, bound {b['bound_ms'] * 1e3:.2f} us by "
                  f"{b['bound_by']} ({b['bytes'] / 1e6:.2f} MB, "
                  f"{b['ops'] / 1e6:.2f} MFLOP; {n_counted} counted edges, "
                  f"{dst_rows} destination and {src_rows} source rows); "
                  f"kernel / bound {k_ms / b['bound_ms']:.2f}", flush=True)
        prof = {kname: _profiled_kernel_us(fn, kn) for kname, fn, kn in (
            # "attn_fwd" names both K2 layouts (attn_fwd_kernel and
            # attn_fwd_vec_kernel)
            ("K2", lambda: attn._launch_fwd(*fwd_args), "attn_fwd"),
            # "attn_bwd" names both K3 layouts (attn_bwd_kernel and
            # attn_bwd_vec_kernel)
            ("K3", lambda: attn._launch_bwd(*bwd_args), "attn_bwd"))}
        print(f"  profiler (warm L2): {prof} us per launch", flush=True)
        record.update(attention_profiler_us_warm=prof,
                      attention_bounds=attn_bounds)
        src = "signnet_basisnet_tpu_torch/ops/csrc/edge_attention.cu"
        tpu_src = "signnet_basisnet_tpu/ops/pallas_attention.py"
        kern2 = dict(name="edge_attention_fwd", route="cuda", source=src,
                     replaces=f"{tpu_src}:177",
                     launches=None, max_abs_err=errs["K2"], ms=k2_ms,
                     plain_ms=k2_plain_ms,
                     bound_ms=attn_bounds["K2"]["bound_ms"],
                     bound_by=attn_bounds["K2"]["bound_by"], library_ms=None)
        kern3 = dict(name="edge_attention_bwd", route="cuda", source=src,
                     replaces=f"{tpu_src}:385",
                     launches=None, max_abs_err=errs["K3"], ms=k3_ms,
                     plain_ms=k3_plain_ms,
                     bound_ms=attn_bounds["K3"]["bound_ms"],
                     bound_by=attn_bounds["K3"]["bound_by"], library_ms=None)
        # the general layout at the other head widths a path runs: D = 7
        # (masked Transformer) and 10 (LapPE Transformer), cold, with
        # their plain versions and bounds
        attn_times = {}
        for D in (7, 10):
            Qd, Kd, Vd, Ed = (t.detach() for t in attn_inputs(
                H, D, torch.float32))
            fa = (Qd, Kd, Vd, Ed, gb.senders, gb.edge_mask, *args[3:],
                  csr[0], bn)
            od, dd = attn._launch_fwd(*fa)
            gd = torch.randn(nb, H, D, device=dev, generator=gen)
            gh = gd / (dd[:, :, None] + 1e-6)
            cd = (od * gh).sum(-1)
            ba = (Qd, Kd, Vd, Ed, gh, cd, gb.senders, gb.receivers,
                  gb.edge_mask, *args[3:], csr, bn)
            b = attn_bounds_at(H, H * D)
            t = {"K2": dict(cold_ms=_cuda_time_ms(
                    lambda: attn._launch_fwd(*fa), flush=flush),
                    plain_ms=_cuda_time_ms(lambda: plain(
                        Qd, Kd, Vd, Ed, *args, bn), flush=flush),
                    **b["K2"]),
                 "K3": dict(cold_ms=_cuda_time_ms(
                     lambda: attn._launch_bwd(*ba), flush=flush),
                     plain_ms=_cuda_time_ms(
                         lambda: attn.edge_attention_bwd_plain(
                             Qd, Kd, Vd, Ed, gh, cd, *args, bn),
                         flush=flush), **b["K3"])}
            for kname, v in t.items():
                print(f"{kname} H={H} D={D} f32 (general layout): kernel_ms "
                      f"{v['cold_ms']:.4f} cold, plain_ms "
                      f"{v['plain_ms']:.4f}, bound "
                      f"{v['bound_ms'] * 1e3:.2f} us by {v['bound_by']} "
                      f"({v['bytes'] / 1e6:.2f} MB); kernel / bound "
                      f"{v['cold_ms'] / v['bound_ms']:.2f}", flush=True)
            attn_times[D] = t
        record["attention_times_general"] = attn_times
        del flush

    with Phase("1c GatedGCN gate kernel (K4) vs plain"):
        gate = gate_mod.gatedgcn_gate_tiled
        gate_plain = gate_mod.gatedgcn_gate_plain
        # agg and e_new at every row and edge slot, the padding slots
        # included: f32, 1e-5 (f32 sums in other orders); bf16, one bf16
        # ulp (2**-7 relative) + 1e-3.  The autograd path (K4, then the plain
        # backward, the JAX `_gate_bwd`) against autograd through the plain
        # version, f32, to K3's tolerance (both divide by the gate sums and
        # subtract c = agg * ghat)
        errs["K4"] = 0.0

        def gate_inputs(F, dtype):
            mk = lambda rows: torch.randn(rows, F, device=dev, generator=gen)
            return [mk(nb).to(dtype), mk(nb).to(dtype), mk(nb).to(dtype),
                    mk(eb).to(dtype)]

        def gate_compare(tag, edge_args, edge_csr_, F, dtype):
            feats = gate_inputs(F, dtype)
            # K4 allocates agg and e_new without filling them and must
            # write every row and slot: each entry starts as NaN
            with nan_filled_empty():
                got = gate_mod._launch(*feats, *edge_args, edge_csr_[0], bn)
            want = gate_plain(*feats, *edge_args, bn)
            for nm, a, b in zip(("agg", "e_new"), got, want):
                if a.dtype != dtype:
                    raise AssertionError(f"K4 {tag} {nm}: type {a.dtype}")
                attn_check("K4", f"K4 {tag} {nm}", a, b,
                           f32_tol if dtype == torch.float32 else bf16_tol)
            return feats, got

        n_real = int((gb.edge_mask != 0).sum())
        assert bool((gb.edge_mask[:n_real] != 0).all())
        # F = 68, 77, 70, 67 in one pass of the warp's lanes (96
        # features); 128 in two
        for F in (68, 77, 70, 67, 128):
            for dtype in (torch.float32, torch.bfloat16):
                feats, (agg, e_new) = gate_compare(
                    f"F={F} {str(dtype)[6:]}", args, csr, F, dtype)
                # the padding slots (weight 0, on the last node) hold their
                # e_new, not zeros
                pad_ref = (feats[1].float()[gb.senders[n_real:].long()]
                           + feats[2].float()[gb.receivers[n_real:].long()]
                           + feats[3].float()[n_real:])
                attn_check("K4", f"K4 F={F} {str(dtype)[6:]} e_new at the "
                           f"{eb - n_real} padding slots", e_new[n_real:],
                           pad_ref.to(dtype), f32_tol
                           if dtype == torch.float32 else bf16_tol)
        feats = [t.requires_grad_(True)
                 for t in gate_inputs(68, torch.float32)]
        c1 = torch.randn(nb, 68, device=dev, generator=gen)
        c2 = torch.randn(eb, 68, device=dev, generator=gen)

        def gate_fwd_bwd(fn):
            agg, e_new = fn(*feats)
            return [agg, e_new] + list(torch.autograd.grad(
                (agg * c1).sum() + (e_new * c2).sum(), feats))

        got = gate_fwd_bwd(lambda *f: gate(*f, *args, nb, bn, csr))
        want = gate_fwd_bwd(lambda *f: gate_plain(*f, *args, bn))
        for nm, a, b in zip(("agg", "e_new", "dBh", "dDh", "dEh", "dCe"),
                            got, want):
            attn_check("K4", f"K4 autograd F=68 float32 {nm}", a, b,
                       grad_tol)
        # the batch with non-tile-local edges of phase 1: counted fully by
        # K4 and the plain version, as by the reference
        for F in (68, 128):  # one pass and two
            feats, got = gate_compare(f"non-local edges F={F} float32",
                                      far_args, far_csr, F, torch.float32)
            ref = gate_mod.gatedgcn_gate_reference(*feats, *far_args[:3], nb)
            for nm, a, b in zip(("agg", "e_new"), got, ref):
                attn_check("K4", f"K4 non-local edges F={F} {nm} vs "
                           "reference", a, b, f32_tol)

        # times at the slice's shapes: F = 68, f32, with and without the
        # batch's padding edges (weight 0, all on its last node)
        F = 68
        feats = [t.detach() for t in gate_inputs(F, torch.float32)]
        flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
        k4_args = (*feats, *args, csr[0], bn)
        k4_ms = _cuda_time_ms(lambda: gate_mod._launch(*k4_args),
                              flush=flush)
        k4_warm_ms = _cuda_time_ms(lambda: gate_mod._launch(*k4_args))
        cut = [a[:n_real].contiguous() for a in (gb.senders, gb.receivers,
                                                 gb.edge_mask, feats[3])]
        lims = [torch.clamp(a, max=n_real) for a in args[3:]]
        csr_cut = edge_csr(cut[0], cut[1], nb)
        k4_cut = lambda: gate_mod._launch(*feats[:3], cut[3], *cut[:3],
                                          *lims, csr_cut[0], bn)
        k4_cut_ms = _cuda_time_ms(k4_cut, flush=flush)
        k4_cut_warm_ms = _cuda_time_ms(k4_cut)
        k4_plain_ms = _cuda_time_ms(lambda: gate_plain(*feats, *args, bn),
                                    flush=flush)
        # the backward every train step runs after K4, in plain torch
        g_agg, g_e = (torch.randn(t.shape, device=dev, generator=gen)
                      for t in (feats[0], feats[3]))
        k4_bwd_ms = _cuda_time_ms(lambda: gate_mod.gatedgcn_gate_bwd_plain(
            *feats, *args[:3], g_agg, g_e, nb), flush=flush)
        # bound of this batch's work.  Bytes: Bh read at the rows the
        # counted edges (in range, weight != 0) reach as sources, Dh at the
        # sources of every in-range edge, Eh at their destinations, Ce read
        # and e_new written at every in-range slot (e_new at every slot),
        # agg written at every row, and the index arrays (senders,
        # receivers, weights, dst_ptr, the tile ranges).  Operations (f32,
        # outside the tensor cores): 2 adds per in-range slot and feature
        # for e_new, ~8 per counted slot and feature for the gate (sigmoid
        # as negate, exp, add, divide; the weight; the product with Bh; the
        # two sums), 2 per row and feature for agg
        in_rng = edge_in_range(gb.receivers, *args[3:], bn)
        counted = in_rng & (gb.edge_mask != 0)
        n_in, n_counted = int(in_rng.sum()), int(counted.sum())
        rows = {k: int(torch.unique(v).numel()) for k, v in (
            ("Bh", gb.senders[counted]), ("Dh", gb.senders[in_rng]),
            ("Eh", gb.receivers[in_rng]))}

        def k4_bound_at(F):
            nbytes = ((sum(rows.values()) + n_in + eb + nb) * F * 4
                      + (3 * eb + nb + 1 + 2 * n_tiles) * 4)
            ops_ = (2 * n_in + 8 * n_counted + 2 * nb) * F
            t_b = nbytes / PEAK_BYTES_PER_S * 1e3
            t_o = ops_ / PEAK_F32_FLOP_PER_S * 1e3
            return dict(bound_ms=max(t_b, t_o),
                        bound_by="bytes" if t_b >= t_o else "operations",
                        bytes=nbytes, ops=ops_, rows=rows,
                        in_range_slots=n_in, counted_edges=n_counted)

        k4_bound = k4_bound_at(F)
        k4_bytes, k4_ops = k4_bound["bytes"], k4_bound["ops"]
        prof_us = _profiled_kernel_us(lambda: gate_mod._launch(*k4_args),
                                      "gate_kernel")
        print(f"K4 F=68 f32: kernel_ms "
              f"{k4_ms:.4f} cold, {k4_warm_ms:.4f} warm (without the "
              f"{eb - n_real} padding edges {k4_cut_ms:.4f} cold, "
              f"{k4_cut_warm_ms:.4f} warm), plain_ms "
              f"{k4_plain_ms:.4f}, bound {k4_bound['bound_ms'] * 1e3:.2f} us "
              f"by {k4_bound['bound_by']} ({k4_bytes / 1e6:.2f} MB, "
              f"{k4_ops / 1e6:.2f} MFLOP; {n_in} in-range slots, "
              f"{n_counted} counted edges, rows read {rows}); kernel / bound "
              f"{k4_ms / k4_bound['bound_ms']:.2f}; profiler (warm L2) "
              f"{prof_us} us per launch; its plain backward "
              f"(gatedgcn_gate_bwd_plain) {k4_bwd_ms:.4f} ms", flush=True)
        record.update(gate_no_padding_ms=k4_cut_ms, gate_warm_ms=k4_warm_ms,
                      gate_no_padding_warm_ms=k4_cut_warm_ms,
                      gate_bound=k4_bound,
                      gate_profiler_us_warm=prof_us, gate_bwd_ms=k4_bwd_ms)
        # the other widths a path runs K4 at: cold and warm, its plain
        # version, the bound and the profiler's device time
        k4_times = {}
        for F in K4_FEATS[1:]:
            fe = [t.detach() for t in gate_inputs(F, torch.float32)]
            fn = lambda: gate_mod._launch(*fe, *args, csr[0], bn)
            b = k4_bound_at(F)
            t = dict(cold_ms=_cuda_time_ms(fn, flush=flush),
                     warm_ms=_cuda_time_ms(fn),
                     plain_ms=_cuda_time_ms(lambda: gate_plain(*fe, *args,
                                                               bn),
                                            flush=flush),
                     profiler_us=_profiled_kernel_us(fn, "gate_kernel"),
                     bound_ms=b["bound_ms"], bound_by=b["bound_by"])
            print(f"K4 F={F} f32: kernel_ms {t['cold_ms']:.4f} cold, "
                  f"{t['warm_ms']:.4f} warm (profiler {t['profiler_us']} "
                  f"us), plain_ms {t['plain_ms']:.4f}, bound "
                  f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']}; kernel "
                  f"/ bound {t['cold_ms'] / t['bound_ms']:.2f}", flush=True)
            k4_times[F] = t
        record["k4_times"] = k4_times
        kern4 = dict(name="gatedgcn_gate_fwd", route="cuda",
                     source="signnet_basisnet_tpu_torch/ops/csrc/"
                            "gatedgcn_gate.cu",
                     replaces="signnet_basisnet_tpu/ops/pallas_gatedgcn.py:143",
                     launches=None, max_abs_err=errs["K4"], ms=k4_ms,
                     plain_ms=k4_plain_ms, bound_ms=k4_bound["bound_ms"],
                     bound_by=k4_bound["bound_by"], library_ms=None)
        del flush, feats

    with Phase("1d flat SpMM kernel (K5) vs plain"):
        # bench_ops' flat problem (bench_ops.py:36-77): N, E, D = 3072,
        # 6912, 128, sources anywhere on the node axis, 90 % of the edges of
        # weight 1, padded to 1024 with weight-0 edges (node 0 to the last
        # receiver), 256-node tile ranges over the padded receivers.  Every
        # call as a user makes it (spmm_flat: one launch, no pointers made),
        # its output over NaN-filled memory.  f32: fixed-order f32 sums on
        # both sides, 1e-5; bf16: both round an f32 sum once, one bf16 ulp
        # (2**-7 relative) + 1e-3
        flat = flat_mod.spmm_flat
        errs["K5"] = 0.0
        fN, fE, fD = bench_ops.N, bench_ops.E, bench_ops.D

        def flat_problem(n, d, seed=0):
            p = bench_ops.flat_problem(n, fE, d, seed)
            return (torch.from_numpy(p["x"]).to(dev),
                    [torch.from_numpy(p[k]).to(dev)
                     for k in ("sp", "rp", "wp", "st", "en")])

        def flat_compare(tag, x, fargs, n, dtype, long_rows=False):
            with nan_filled_empty():
                got = flat(x, *fargs, n, bn)
            want = flat_mod.spmm_flat_plain(x, *fargs, n, bn)
            if got.dtype != dtype or got.shape != want.shape:
                raise AssertionError(f"K5 {tag}: {got.dtype} "
                                     f"{tuple(got.shape)}")
            tol = f32_tol if dtype == torch.float32 else bf16_tol
            tag = (f"K5 {tag} (vec, group) "
                   f"{flat_mod.kernel_variant(x.shape[1], dtype, True)}")
            if long_rows:
                # rows of up to 2400 counted edges, summed in f32 in
                # another order than the plain version's: 1e-5 of the sum
                # of their terms' magnitudes more (a missing or doubled
                # edge moves a row by a whole term)
                mag = flat_mod.spmm_flat_plain(
                    x.float().abs(), fargs[0], fargs[1], fargs[2].abs(),
                    *fargs[3:], n, bn)
                err = (got.float() - want.float()).abs()
                errs["K5"] = _worst(errs["K5"], float(err.max()))
                print(f"  {tag}: max_abs_err {float(err.max()):.3e} (tol "
                      f"{tol[1]:g} + {tol[0]:g}*|ref| + 1e-5*sum|terms|)",
                      flush=True)
                if bool((~(err <= tol[1] + tol[0] * want.float().abs()
                           + 1e-5 * mag)).any()):
                    raise AssertionError(f"{tag}: kernel disagrees with its "
                                         "plain version")
            else:
                attn_check("K5", tag, got, want, tol)
            # rows with no counted edge: zeros
            counted = edge_in_range(fargs[1], *fargs[3:], bn) & (fargs[2]
                                                                 != 0)
            empty = torch.ones(n, dtype=torch.bool, device=dev)
            empty[fargs[1][counted].long()] = False
            if bool(got[empty].any()):
                raise AssertionError(f"K5 {tag}: a row with no counted edge "
                                     "is not zero")
            return int(empty.sum())

        # bench_ops' shape, D = 95 (one element a load), N = 300 (not a
        # multiple of 256), and the shapes that take every other instance:
        # two passes of the row (D = 256 f32, 130, 512 bf16) and 16 lanes a
        # row (D = 64 and 33; bf16 D = 128)
        reached = set()
        for n, d in ((fN, fD), (fN, 95), (300, fD), (fN, 256), (300, 130),
                     (300, 512), (fN, 64), (fN, 33)):
            x, fargs = flat_problem(n, d)
            for dtype in (torch.float32, torch.bfloat16):
                flat_compare(f"N={n} D={d} {str(dtype)[6:]}", x.to(dtype),
                             fargs, n, dtype)
                vec, group = flat_mod.kernel_variant(d, dtype, True)
                per_pass = group * flat_mod._VECS_PER_LANE[vec]
                reached.add((dtype, vec, group))
                reached.add((dtype, vec, "passes", -(-d // vec) > per_pass))
        want = {(dt, v, g) for dt, vs in ((torch.float32, (1, 4)),
                                          (torch.bfloat16, (1, 8)))
                for v in vs for g in flat_mod._GROUPS}
        want |= {(dt, v, "passes", True) for dt, v, _ in want}
        if not want <= reached:
            raise AssertionError(f"K5 checks miss instances or multi-pass "
                                 f"rows: {sorted(map(str, want - reached))}")
        # narrowed tile ranges (in-range and out-of-range edges share rows),
        # a tile with no edge, and long runs of equal receivers on both
        # sides of a tile boundary (3000 and 2000 edges on rows 255 and 256
        # of 600, tile 0's range reaching 700 slots into row 256's run):
        # the kernel's probe rounds and several chunks
        x, fargs = flat_problem(fN, fD, seed=2)
        st_n = fargs[3] + 5
        narrow = fargs[:3] + [st_n, torch.maximum(fargs[4] - 7, st_n)]
        en_e = fargs[4].clone()
        en_e[3] = fargs[3][3]
        g = np.random.default_rng(7)
        r_b = np.sort(np.concatenate([g.integers(0, 600, 3000),
                                      np.full(3000, 255), np.full(2000, 256)]
                                     ).astype(np.int32))
        w_b = ((g.random(len(r_b)) + 0.5)
               * (g.random(len(r_b)) < 0.8)).astype(np.float32)
        s_b = g.integers(0, 600, len(r_b)).astype(np.int32)
        s_b, r_b, w_b = flat_mod.pad_edges_to(s_b, r_b, w_b, 1024)
        st_b, en_b = flat_mod.tile_edge_ranges(r_b, 600, bn)
        en_b = en_b.copy()
        en_b[0] += 700
        boundary = [torch.from_numpy(a).to(dev)
                    for a in (s_b, r_b, w_b, st_b, en_b)]
        x_b = torch.from_numpy(g.normal(size=(600, fD)).astype(np.float32)
                               ).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            t = str(dtype)[6:]
            n_empty = flat_compare(f"narrowed ranges {t}", x.to(dtype),
                                   narrow, fN, dtype)
            flat_compare(f"tile 3 empty {t}", x.to(dtype),
                         fargs[:4] + [en_e], fN, dtype)
            flat_compare(f"long runs across a tile boundary {t}",
                         x_b.to(dtype), boundary, 600, dtype, long_rows=True)
        print(f"  K5 narrowed ranges: {n_empty} rows with no counted edge",
              flush=True)
        # a non-finite row of x, read by the weight-0 padding edges (their
        # source is node 0) and by one counted edge made to read it: only
        # that edge's destination row may be non-finite
        x, fargs = flat_problem(fN, fD, seed=1)
        s_nf = fargs[0].clone()
        w_f, r_f = fargs[2], fargs[1]
        e0 = int(torch.nonzero((w_f != 0) & (r_f != r_f[-1]))[0, 0])
        s_nf[e0] = 0
        nf_args = [s_nf] + fargs[1:]
        x[0] = float("inf")
        got = flat(x, *nf_args, fN, bn)
        hit = torch.zeros(fN, dtype=torch.bool, device=dev)
        hit[r_f[(s_nf == 0) & (w_f != 0)].long()] = True
        bad = ~torch.isfinite(got).all(1)
        n_pad_reads = int(((s_nf == 0) & (w_f == 0)).sum())
        print(f"  K5 non-finite x[0]: read by {int(hit.sum())} counted "
              f"edges' rows and {n_pad_reads} weight-0 edges; non-finite "
              f"output rows {int(bad.sum())}", flush=True)
        if not n_pad_reads or bool(hit[r_f[-1]]):
            raise AssertionError("K5 non-finite check: no weight-0 edge "
                                 "alone reads the row")
        if not torch.equal(bad, hit):
            raise AssertionError("K5 spread a non-finite row beyond the "
                                 "counted edges that read it")
        attn_check("K5", "K5 non-finite x[0], the other rows", got[~hit],
                   flat_mod.spmm_flat_plain(x, *nf_args, fN, bn)[~hit],
                   f32_tol)

        # one call on the card is one device kernel: no pointers are made
        x, fargs = flat_problem(fN, fD)
        k5 = lambda: flat(x, *fargs, fN, bn)
        dev_kernels = device_kernels(k5, 10)
        print(f"  K5 device kernels over 10 calls: {dev_kernels}", flush=True)
        if (len(dev_kernels) != 1 or sum(dev_kernels.values()) != 10
                or "spmm_flat_kernel" not in next(iter(dev_kernels))):
            raise AssertionError("K5: a spmm_flat call is not one device "
                                 "kernel")

        # times at bench_ops' shape, f32: the call as a user makes it cold
        # and warm and the profiler's time per launch, the plain version,
        # the gather + index_add_ reference and torch.sparse.mm on a CSR
        # matrix of the counted edges
        s_f, r_f, w_f, st_f, en_f = fargs
        flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
        k5_ms = _cuda_time_ms(k5, flush=flush)
        k5_warm_ms = _cuda_time_ms(k5)
        k5_plain_ms = _cuda_time_ms(
            lambda: flat_mod.spmm_flat_plain(x, *fargs, fN, bn), flush=flush)
        k5_index_add_ms = _cuda_time_ms(
            lambda: flat_mod.spmm_reference(x, s_f, r_f, w_f, fN),
            flush=flush)
        counted = edge_in_range(r_f, st_f, en_f, bn) & (w_f != 0)
        a_csr = torch.sparse_coo_tensor(
            torch.stack([r_f.long()[counted], s_f.long()[counted]]),
            w_f[counted], (fN, fN), check_invariants=True
        ).coalesce().to_sparse_csr()
        check("K5 library torch.sparse.mm vs plain (yardstick)",
              torch.sparse.mm(a_csr, x),
              flat_mod.spmm_flat_plain(x, *fargs, fN, bn), torch.float32)
        k5_library_ms = _cuda_time_ms(lambda: torch.sparse.mm(a_csr, x),
                                      flush=flush)
        # bound of the call's work: x read at the rows the counted edges
        # name, the output written at every row, the senders, receivers
        # and weights of every slot and the tile ranges read once; 2 flops
        # per counted edge and feature (f32, no tensor cores)
        n_counted = int(counted.sum())
        rows_read = int(torch.unique(s_f[counted]).numel())
        dst_rows = int(torch.unique(r_f[counted]).numel())
        e_pad = s_f.shape[0]
        k5_bytes = ((rows_read + fN) * fD * 4 + e_pad * 12
                    + 2 * st_f.shape[0] * 4)
        k5_ops = 2 * n_counted * fD
        t_b = k5_bytes / PEAK_BYTES_PER_S * 1e3
        t_o = k5_ops / PEAK_F32_FLOP_PER_S * 1e3
        k5_bound = dict(bound_ms=max(t_b, t_o),
                        bound_by="bytes" if t_b >= t_o else "operations",
                        bytes=k5_bytes, ops=k5_ops, counted_edges=n_counted,
                        rows_read=rows_read, dst_rows=dst_rows)
        prof_us = _profiled_kernel_us(k5, "spmm_flat_kernel")
        print(f"K5 N={fN} D={fD} f32, {e_pad} edge slots, (vec, group) "
              f"{flat_mod.kernel_variant(fD, x.dtype, True)}: the call "
              f"(one launch) {k5_ms:.4f} ms cold, {k5_warm_ms:.4f} warm; "
              f"plain_ms {k5_plain_ms:.4f}; index_add_ reference "
              f"{k5_index_add_ms:.4f}; library_ms {k5_library_ms:.4f} "
              f"(torch.sparse.mm, CSR); bound "
              f"{k5_bound['bound_ms'] * 1e3:.2f} us by {k5_bound['bound_by']} "
              f"({k5_bytes / 1e6:.2f} MB, {k5_ops / 1e6:.2f} MFLOP; "
              f"{n_counted} counted edges reading {rows_read} source rows "
              f"into {dst_rows} destination rows); cold / bound "
              f"{k5_ms / k5_bound['bound_ms']:.2f}; profiler (warm L2) "
              f"{prof_us} us per launch", flush=True)
        record.update(flat_bound=k5_bound, flat_warm_ms=k5_warm_ms,
                      flat_index_add_ms=k5_index_add_ms,
                      flat_profiler_us_warm=prof_us,
                      flat_device_kernels=dev_kernels)
        kern5 = dict(name="spmm_flat", route="cuda",
                     source="signnet_basisnet_tpu_torch/ops/csrc/"
                            "spmm_flat.cu",
                     replaces="signnet_basisnet_tpu/ops/pallas_spmm.py:146",
                     launches=None, max_abs_err=errs["K5"], ms=k5_ms,
                     plain_ms=k5_plain_ms, bound_ms=k5_bound["bound_ms"],
                     bound_by=k5_bound["bound_by"], library_ms=k5_library_ms)
        del flush, a_csr

    with Phase("1e timer stamp kernel vs CUDA events"):
        # the device spans' stamps (ops/timer_stamp.py) around a spin of
        # ~10 ms read that spin within 2 % of CUDA events around the same
        # stamps, eagerly and as kernel nodes of a graph whose every replay
        # writes its own times
        stamps = torch.zeros(2, dtype=torch.int64, device=dev)

        def spin():
            stamp_mod.timer_stamp(stamps, 0)
            torch.cuda._sleep(20_000_000)
            stamp_mod.timer_stamp(stamps, 1)

        def stamped_ms(fn):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b), (stamps[1] - stamps[0]).item() * 1e-6

        spin_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(spin_graph):
            spin()
        reads = [("eager", *stamped_ms(spin))]
        starts = []
        for i in range(2):
            reads.append((f"replay {i}", *stamped_ms(spin_graph.replay)))
            starts.append(stamps[0].item())
        for tag, events_ms, stamp_ms in reads:
            print(f"  {tag}: stamps {stamp_ms:.4f} ms, CUDA events "
                  f"{events_ms:.4f} ms", flush=True)
            if not 0.98 * events_ms <= stamp_ms <= events_ms:
                raise AssertionError(f"1e {tag}: stamps {stamp_ms} ms, "
                                     f"events {events_ms} ms")
        if not starts[1] > starts[0] + 5_000_000:
            raise AssertionError(f"1e: the second replay wrote no stamps of "
                                 f"its own {starts}")
        record["timer_stamp_vs_events_ms"] = reads
        del spin_graph

    # ---------------------------------------------------------------- 2
    def trainer_cfg(extra):
        return load_config(CONFIG, [
            "data.agg_backend", "pallas_tile", "data.synth_train", "512",
            "data.synth_eval", "128", "train.print_epoch_interval", "1",
            "out_dir", OUT_DIR] + extra)

    with Phase("2a full-width step, card vs CPU"):
        # one train step from the same weights through K1 (24 BatchNorm'd
        # GIN layers), on the card and on the CPU
        cfg = trainer_cfg([])
        m = cfg.model
        net = dict(hidden_dim=m.hidden_dim, out_dim=m.out_dim,
                   n_layers=m.n_layers, pos_enc_dim=m.pos_enc_dim,
                   lap_method=m.lap_method, sign_inv_layers=m.sign_inv_layers,
                   phi_out_dim=m.phi_out_dim, pe_aggregate=m.pe_aggregate,
                   seed=cfg.train.seed)
        seg.set_agg_backend("pallas_tile")
        card_step, record["gin_card_vs_cpu"] = _check_step_card_vs_cpu(
            "GIN", net, arrays, lambda model: build_steps(
                model, make_zinc_predict(model, "sign_inv"),
                adam(model.parameters()))[0])

    with Phase("2b warm step, f32 and bf16 interleaved"):
        # the warm step on one fixed batch (no input pipeline), f32 and
        # bf16 compute taking turns window by window;
        # median and spread over the windows, then where each one's device
        # time goes (torch.profiler); 3 windows (not 5), as 4b
        bf16_model = gnn_model("GIN", **net).to(dev)
        bf16_step, _ = build_steps(
            bf16_model, make_zinc_predict(bf16_model, "sign_inv",
                                          compute_dtype=torch.bfloat16),
            adam(bf16_model.parameters()))
        f32_step, batch = card_step
        ms = _interleaved_ms({"f32": f32_step, "bf16": bf16_step}, batch,
                             repeats=3)
        for name, v in ms.items():
            print(f"  warm {name} step (host clock, {len(v)} windows of 10 "
                  f"steps): median {float(np.median(v)):.2f} ms, min "
                  f"{min(v):.2f}, max {max(v):.2f}; windows "
                  f"{[round(t, 2) for t in v]}", flush=True)
            record[f"warm_{name}_step_ms"] = v
        for name, step in (("f32", f32_step), ("bf16", bf16_step)):
            prof = _profile_steps(step, batch, ["spmm_tiled_kernel"])
            print(f"  profiler, {name}: {prof}", flush=True)
            record[f"warm_{name}_step_profile"] = prof
        del bf16_model, bf16_step, f32_step, card_step

    with Phase("2 main path f32 (train_zinc, pallas_tile)"):
        cfg = trainer_cfg(["train.epochs", "2", "name", "f32"])
        # one forward launch per GIN layer (16 base + 8 phi = 24), one
        # transposed launch per layer but phi layer 0, whose input is the
        # eigenvector stack and needs no gradient: 47 per train step
        per_eval = cfg.model.n_layers + cfg.model.sign_inv_layers
        per_train = 2 * per_eval - 1
        _reset_counts()
        res = run(cfg, device="cuda", log=lambda s: print("  " + s,
                                                          flush=True))
        torch.cuda.synchronize()
        launches = spmm_tiled.launches
        if (tiled.launches_fwd or tiled.launches_bwd or gate.launches
                or flat.launches):
            raise AssertionError("the GIN path launched K2/K3/K4/K5")
        expect = per_train * res.train_steps + per_eval * res.eval_steps
        print(f"  spmm_tiled launches {launches}, expected {per_train} x "
              f"{res.train_steps} train steps + {per_eval} x "
              f"{res.eval_steps} eval steps = {expect}", flush=True)
        if launches != expect:
            raise AssertionError(f"the main path did not launch K1 "
                                 f"{per_train} times per train step and "
                                 f"{per_eval} per eval step")
        hist = res.history
        if (res.epochs_run != 2 or not all(
                np.isfinite([h["train_loss"], h["val_mae"]]).all()
                for h in hist) or not np.isfinite(res.test_mae)):
            raise AssertionError(f"non-finite or missing metrics: {hist}")
        step_ms = hist[-1]["train_time"] / hist[-1]["train_steps"] * 1e3
        print(f"  step time (epoch 2, {hist[-1]['train_steps']} steps, "
              f"host clock to the last loss on the host): {step_ms:.2f} ms; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} "
              "MiB", flush=True)
        kern["launches"] = launches
        record.update(f32_step_ms=step_ms, f32_train_steps=res.train_steps,
                      f32_eval_steps=res.eval_steps, f32_history=hist)

    # ---------------------------------------------------------------- 3
    with Phase("3 main path bf16 (train.compute_dtype bfloat16)"):
        cfg = trainer_cfg(["train.epochs", "2", "train.compute_dtype",
                           "bfloat16", "data.synth_train", "384",
                           "name", "bf16"])
        _reset_counts()
        res = run(cfg, device="cuda", log=lambda s: print("  " + s,
                                                          flush=True))
        torch.cuda.synchronize()
        expect = per_train * res.train_steps + per_eval * res.eval_steps
        print(f"  spmm_tiled launches {spmm_tiled.launches}, expected "
              f"{expect}", flush=True)
        if spmm_tiled.launches != expect:
            raise AssertionError("bf16 path: wrong K1 launch count")
        if (tiled.launches_fwd or tiled.launches_bwd or gate.launches
                or flat.launches):
            raise AssertionError("the GIN path launched K2/K3/K4/K5")
        h = res.history[-1]
        if not np.isfinite([h["train_loss"], h["val_mae"], res.test_mae]).all():
            raise AssertionError(f"bf16: non-finite metrics {res.history}")
        step_ms = h["train_time"] / h["train_steps"] * 1e3
        print(f"  bf16 step time (epoch 2, {h['train_steps']} steps, host "
              f"clock to the last loss on the host): {step_ms:.2f} ms",
              flush=True)
        record.update(bf16_step_ms=step_ms, bf16_history=res.history)

    # ---------------------------------------------------------------- 4
    def transformer_cfg(extra):
        return load_config(TRANSFORMER_CONFIG, [
            "data.synth_train", "512", "data.synth_eval", "128",
            "train.print_epoch_interval", "1", "out_dir", OUT_DIR] + extra)

    with Phase("4a Transformer full-width step, card vs CPU"):
        # the shipped config: tile_dense, so the phi's aggregations are
        # block-adjacency matmuls and every attention goes through K2/K3
        cfg = transformer_cfg([])
        m = cfg.model
        k = m.pos_enc_dim
        gs_t = synthetic_zinc(512, 0, 0, seed=0)["train"]
        add_lap_pe(gs_t, k)
        arrays_t = pack_batches(gs_t, nb, eb, gc, k=k, tile=256)[0]
        tnet = dict(hidden_dim=m.hidden_dim, out_dim=m.out_dim,
                    n_layers=m.n_layers, num_heads=m.num_heads,
                    layer_norm=m.layer_norm, pos_enc_dim=k,
                    lap_method=m.lap_method,
                    sign_inv_layers=m.sign_inv_layers,
                    phi_out_dim=m.phi_out_dim, pe_aggregate=m.pe_aggregate,
                    seed=cfg.train.seed)
        seg.set_agg_backend(cfg.data.agg_backend)
        (t_step, t_batch), info = _check_step_card_vs_cpu(
            "Transformer", tnet, arrays_t, lambda model: build_steps(
                model, make_zinc_predict(model, m.lap_method),
                adam(model.parameters()))[0],
            plain_on_card=_attention_plain_on_card, floor_cpu_error=True)
        record["transformer_card_vs_cpu"] = info

    with Phase("4b Transformer warm step, f32 and bf16 interleaved"):
        bf16_model = gnn_model("Transformer", **tnet).to(dev)
        bf16_step, _ = build_steps(
            bf16_model, make_zinc_predict(bf16_model, m.lap_method,
                                          compute_dtype=torch.bfloat16),
            adam(bf16_model.parameters()))
        # 3 windows (not 5): the whole run stays under 950 s with phase 16
        ms = _interleaved_ms({"f32": t_step, "bf16": bf16_step}, t_batch,
                             repeats=3)
        for name, v in ms.items():
            print(f"  warm Transformer {name} step (host clock, {len(v)} "
                  f"windows of 10 steps): median {float(np.median(v)):.2f} "
                  f"ms, min {min(v):.2f}, max {max(v):.2f}; windows "
                  f"{[round(t, 2) for t in v]}", flush=True)
            record[f"transformer_warm_{name}_step_ms"] = v
        for name, step in (("f32", t_step), ("bf16", bf16_step)):
            prof = _profile_steps(step, t_batch, ["attn_fwd", "attn_bwd"])
            print(f"  profiler, Transformer {name}: {prof}", flush=True)
            record[f"transformer_warm_{name}_step_profile"] = prof
        del bf16_model, bf16_step, t_step, t_batch

    layers = cfg.model.n_layers
    for name, extra in (("f32", ["data.synth_train", "512"]),
                        ("bf16", ["train.compute_dtype", "bfloat16",
                                  "data.synth_train", "384"])):
        with Phase(f"4c Transformer main path {name} (train_zinc, "
                   f"{cfg.data.agg_backend})"):
            tcfg = transformer_cfg(extra + ["train.epochs", "2", "name",
                                            f"transformer_{name}"])
            _reset_counts()
            res = run(tcfg, device="cuda", log=lambda s: print("  " + s,
                                                               flush=True))
            torch.cuda.synchronize()
            # one K2 per layer per forward, one K3 per layer per backward
            want = (layers * (res.train_steps + res.eval_steps),
                    layers * res.train_steps, 0, 0)
            got = (tiled.launches_fwd, tiled.launches_bwd,
                   spmm_tiled.launches, gate.launches)
            print(f"  K2 launches {got[0]}, K3 launches {got[1]}, K1 "
                  f"launches {got[2]}, K4 launches {got[3]}; expected "
                  f"{want} for {res.train_steps} train and "
                  f"{res.eval_steps} eval steps", flush=True)
            if got != want:
                raise AssertionError(f"the Transformer path did not launch "
                                     f"{layers} K2 and K3 per train step, "
                                     f"{layers} K2 per eval step, no K1 "
                                     "and no K4")
            h = res.history[-1]
            if (res.epochs_run != 2 or not all(
                    np.isfinite([r["train_loss"], r["val_mae"]]).all()
                    for r in res.history) or not np.isfinite(res.test_mae)):
                raise AssertionError(f"non-finite or missing metrics: "
                                     f"{res.history}")
            step_ms = h["train_time"] / h["train_steps"] * 1e3
            print(f"  Transformer {name} step time (epoch 2, "
                  f"{h['train_steps']} steps, host clock to the last loss "
                  f"on the host): {step_ms:.2f} ms", flush=True)
            record[f"transformer_{name}_step_ms"] = step_ms
            record[f"transformer_{name}_history"] = res.history
            if name == "f32":
                kern2["launches"], kern3["launches"] = got[:2]

    # ---------------------------------------------------------------- 5
    def gatedgcn_cfg(extra):
        return load_config(GATEDGCN_CONFIG, [
            "data.tile", "256", "data.agg_backend", "pallas_tile",
            "data.synth_train", "512", "data.synth_eval", "128",
            "train.print_epoch_interval", "1", "out_dir", OUT_DIR] + extra)

    with Phase("5a GatedGCN full-width step, card vs CPU"):
        # GatedGCNNet 16x68 through K4, its GINDeepSigns phi (8 layers over
        # the [N, 16, 68] stack) through K1, on the phase-1 batch (k = 8)
        cfg = gatedgcn_cfg([])
        m = cfg.model
        gnet = dict(hidden_dim=m.hidden_dim, out_dim=m.out_dim,
                    n_layers=m.n_layers, residual=m.residual,
                    batch_norm=m.batch_norm, readout=m.readout,
                    pos_enc_dim=m.pos_enc_dim, lap_method=m.lap_method,
                    sign_inv_layers=m.sign_inv_layers,
                    phi_out_dim=m.phi_out_dim, pe_aggregate=m.pe_aggregate,
                    seed=cfg.train.seed)
        seg.set_agg_backend(cfg.data.agg_backend)
        (g_step, g_batch), record["gatedgcn_card_vs_cpu"] = (
            _check_step_card_vs_cpu(
                "GatedGCN", gnet, arrays, lambda model: build_steps(
                    model, make_zinc_predict(model, m.lap_method),
                    adam(model.parameters()))[0],
                plain_on_card=_gate_plain_on_card))

    with Phase("5b GatedGCN warm step, f32 and bf16 interleaved"):
        bf16_model = gnn_model("GatedGCN", **gnet).to(dev)
        bf16_step, _ = build_steps(
            bf16_model, make_zinc_predict(bf16_model, m.lap_method,
                                          compute_dtype=torch.bfloat16),
            adam(bf16_model.parameters()))
        # 3 windows (not 5), as 4b
        ms = _interleaved_ms({"f32": g_step, "bf16": bf16_step}, g_batch,
                             repeats=3)
        for name, v in ms.items():
            print(f"  warm GatedGCN {name} step (host clock, {len(v)} "
                  f"windows of 10 steps): median {float(np.median(v)):.2f} "
                  f"ms, min {min(v):.2f}, max {max(v):.2f}; windows "
                  f"{[round(t, 2) for t in v]}", flush=True)
            record[f"gatedgcn_warm_{name}_step_ms"] = v
        for name, step in (("f32", g_step), ("bf16", bf16_step)):
            prof = _profile_steps(step, g_batch, ["gate_kernel",
                                                  "spmm_tiled_kernel"])
            print(f"  profiler, GatedGCN {name}: {prof}", flush=True)
            record[f"gatedgcn_warm_{name}_step_profile"] = prof
        del bf16_model, bf16_step, g_step, g_batch

    # per train step one K4 per layer (forward only: the backward is plain
    # torch) and the phi's K1, one per layer forward and one per layer but
    # the first backward (its input, the eigenvector stack, needs no
    # gradient); per eval step the forwards alone
    k4_step = cfg.model.n_layers
    k1_train = 2 * cfg.model.sign_inv_layers - 1
    k1_eval = cfg.model.sign_inv_layers
    for name, extra in (("f32", ["data.synth_train", "512"]),
                        ("bf16", ["train.compute_dtype", "bfloat16",
                                  "data.synth_train", "384"])):
        with Phase(f"5c GatedGCN main path {name} (train_zinc, "
                   "pallas_tile)"):
            gcfg = gatedgcn_cfg(extra + ["train.epochs", "2", "name",
                                         f"gatedgcn_{name}"])
            _reset_counts()
            res = run(gcfg, device="cuda", log=lambda s: print("  " + s,
                                                               flush=True))
            torch.cuda.synchronize()
            want = (k4_step * (res.train_steps + res.eval_steps),
                    k1_train * res.train_steps + k1_eval * res.eval_steps,
                    0, 0)
            got = (gate.launches, spmm_tiled.launches, tiled.launches_fwd,
                   tiled.launches_bwd)
            print(f"  K4 launches {got[0]}, K1 launches {got[1]}, K2/K3 "
                  f"launches {got[2:]}; expected {want} for "
                  f"{res.train_steps} train and {res.eval_steps} eval "
                  "steps", flush=True)
            if got != want:
                raise AssertionError(
                    f"the GatedGCN path did not launch {k4_step} K4 per "
                    f"train and eval step, {k1_train} K1 per train step, "
                    f"{k1_eval} per eval step, no K2/K3")
            h = res.history[-1]
            if (res.epochs_run != 2 or not all(
                    np.isfinite([r["train_loss"], r["val_mae"]]).all()
                    for r in res.history) or not np.isfinite(res.test_mae)):
                raise AssertionError(f"non-finite or missing metrics: "
                                     f"{res.history}")
            step_ms = h["train_time"] / h["train_steps"] * 1e3
            print(f"  GatedGCN {name} step time (epoch 2, "
                  f"{h['train_steps']} steps, host clock to the last loss "
                  f"on the host): {step_ms:.2f} ms", flush=True)
            record[f"gatedgcn_{name}_step_ms"] = step_ms
            record[f"gatedgcn_{name}_history"] = res.history
            if name == "f32":
                kern4["launches"] = got[0]

    # ---------------------------------------------------------------- 6
    with Phase("6 bench_ops (the port's per-kernel benchmark) and --packer"):
        # the entry point K5 runs on: every count to 0 just before it, read
        # just after.  Each section's kernels must have launched once per
        # call the script made; the train steps (no direct kernel call) at
        # the per-step counts of phases 2-5 (here with SignNet k = 8 for
        # all three nets, so the Transformer's phi runs K1 under
        # pallas_tile: 8 forward and 7 transposed), and nothing under xla
        _reset_counts()
        res = bench_ops.main([])
        torch.cuda.synchronize()
        counts = bench_ops.launch_counts()
        per_step = {
            "GIN_pallas_tile": {"spmm_tiled": 47},
            "Transformer_pallas_tile": {"edge_attention_fwd": 10,
                                        "edge_attention_bwd": 10,
                                        "spmm_tiled": 15},
            "GatedGCN_pallas_tile": {"gatedgcn_gate_fwd": 16,
                                     "spmm_tiled": 15}}
        steps = res["train_steps"]
        want = dict.fromkeys(counts, 0)
        for run_name, n_steps in steps["steps"].items():
            got_ps = steps["launches_per_step"][run_name]
            if got_ps != per_step.get(run_name, {}):
                raise AssertionError(f"bench_ops {run_name}: launches per "
                                     f"step {got_ps}, expected "
                                     f"{per_step.get(run_name, {})}")
            for k, v in got_ps.items():
                want[k] += int(v * n_steps)
        for name in ("flat_spmm", "tiled_spmm", "attention", "gatedgcn"):
            sec = res[name]
            for k, v in sec["calls"].items():
                want[k] += v
            if sec["launches"] != {k: sec["calls"].get(k, 0)
                                   for k in counts}:
                raise AssertionError(f"bench_ops {name}: launches "
                                     f"{sec['launches']} for calls "
                                     f"{sec['calls']}")
            for key, v in sec["max_err"].items():
                print(f"  bench_ops {name} {key}: max_err "
                      f"{v['max_err']:.3e} (tol {v['atol']:.3g} + "
                      f"{v['rtol']:g}*|ref|, |ref| <= {v['ref_max']:.3g})",
                      flush=True)
                if not (v["ok"] and v["max_err"]
                        <= v["atol"] + v["rtol"] * v["ref_max"]):
                    raise AssertionError(f"bench_ops {name} {key}: beyond "
                                         "its tolerance")
        print(f"  launches over the run {counts}; calls and steps of the "
              f"script {want}", flush=True)
        if counts != want or not counts["spmm_flat"]:
            raise AssertionError("bench_ops: launch counters differ from "
                                 "the calls the script made")
        packer = bench_ops.main(["--packer"])["packer"]
        record.update(bench_ops=res, bench_ops_packer=packer)
        kern5["launches"] = counts["spmm_flat"]

    # ---------------------------------------------------------------- 7
    # the train step captured in a CUDA graph against the eager step, at
    # full width, from one init, over 2 batches of one set of budgets
    # copied in turn into the graph's static batch.  Both steps take the
    # capturable Adam (LR a device tensor), so they differ only in the
    # capture.  A replay's launches are the step's `launches`, the
    # wrappers' counters over its capture (they count each capture once
    # and no replay); with the device spans on, the step is captured twice
    # (with and without its stamps) and the replays run both.
    card = record["card"]
    gs16 = synthetic_zinc(512, 0, 0, seed=0)["train"]
    add_lap_pe(gs16, 16)
    two = {k: [from_arrays(a).to(dev) for a in pack_batches(
        g, nb, eb, gc, k=k, tile=256)[:2]] for k, g in ((8, gs), (16, gs16))}
    capture_paths = [
        ("GIN f32", "GIN", net, "pallas_tile", None, 8,
         {"spmm_tiled_kernel": 47}),
        ("GIN bf16", "GIN", net, "pallas_tile", torch.bfloat16, 8,
         {"spmm_tiled_kernel": 47}),
        ("Transformer f32", "Transformer", tnet, "tile_dense", None, 16,
         {"attn_fwd": 10, "attn_bwd": 10}),
        ("GatedGCN f32", "GatedGCN", gnet, "pallas_tile", None, 8,
         {"gate_kernel": 16, "spmm_tiled_kernel": 15}),
    ]
    counters = {"spmm_tiled_kernel": lambda: spmm_tiled.launches,
                "attn_fwd": lambda: tiled.launches_fwd,
                "attn_bwd": lambda: tiled.launches_bwd,
                "gate_kernel": lambda: gate.launches}
    # the kernel names above as `capture_train_step`'s `launches` has them
    k_of = {"spmm_tiled_kernel": "K1", "attn_fwd": "K2", "attn_bwd": "K3",
            "gate_kernel": "K4"}
    record["captured"] = {}
    for label, name, kw, backend, cdt, k, per_step in capture_paths:
        gbs = two[k]
        seg.set_agg_backend(backend)

        def make(capturable):
            model = gnn_model(name, **kw).to(dev)
            opt = adam(model.parameters(), capturable=capturable)
            predict = make_zinc_predict(model, "sign_inv",
                                        compute_dtype=cdt)
            return model, opt, predict

        with Phase(f"7a {label}: captured step vs eager step"), \
                _deterministic():
            runs = {}
            for run_name in ("eager", "eager_again", "captured"):
                model, opt, predict = make(True)
                if run_name == "captured":
                    _reset_counts()
                    step = capture_train_step(model, predict, opt, gbs[0])
                    torch.cuda.synchronize()
                    at_capture = {n: c() for n, c in counters.items()}
                    # the eager warm-up steps and each capture, each once
                    runs_once = CAPTURE_WARMUP + (
                        1 if step.spans is None else 2)
                    want = {n: runs_once * per_step.get(n, 0)
                            for n in counters}
                    if at_capture != want:
                        raise AssertionError(f"{label}: wrapper counts over "
                                             f"warm-up and capture "
                                             f"{at_capture}, expected {want}")
                    _reset_counts()
                else:
                    step = build_steps(model, predict, opt)[0]
                losses = [float(step(gbs[i % 2], 1e-3)["loss"])
                          for i in range(5)]
                runs[run_name] = (losses, _train_state_tensors(model, opt),
                                  step)
            if any(c() for c in counters.values()):
                raise AssertionError(f"{label}: a replay moved a wrapper "
                                     "counter")
            le, se, eager = runs["eager"]
            lc, sc, captured = runs["captured"]
            print(f"  losses eager {le}\n  losses captured {lc}",
                  flush=True)
            # with deterministic algorithms the eager spread is expected to
            # be 0, and the bar is the f32 one (the ratio without the spread
            # is printed for the record)
            la, sa = runs["eager_again"][:2]
            (worst, at), worst_plain, worst_l, spread_l, spread_t = (
                _captured_vs_eager(le, la, lc, se, sa, sc))
            print(f"  {len(se)} tensors (parameters, buffers, Adam state); "
                  f"worst error / bar {worst:.3e} at {at} (without the "
                  f"eager spread {worst_plain[0]:.3e} at {worst_plain[1]}); "
                  f"loss error beyond its bar {worst_l:.3e}; eager "
                  f"run-to-run spread: loss {spread_l:.3e}, largest tensor "
                  f"{spread_t:.3e}", flush=True)
            if not (worst_l <= 0 and worst <= 1):
                raise AssertionError(f"{label}: the captured step departs "
                                     "from the eager step")
            # the eager step's launches by the wrappers' counters, a
            # replay's by the captured step's `launches`; the profiler's
            # count of the eager step is printed beside them
            _reset_counts()
            eager(gbs[1], 1e-3)
            torch.cuda.synchronize()
            ce = {n: counters[n]() for n in per_step}
            cc = {n: captured.launches[k_of[n]] for n in per_step}
            ce_prof = device_kernel_counts(lambda: eager(gbs[1], 1e-3),
                                           per_step)
            print(f"  launches per step: eager (counters) {ce}, replay "
                  f"(step.launches) {cc}; eager (profiler) {ce_prof}; "
                  f"{captured.replays} replays", flush=True)
            for n, v in per_step.items():
                if not ce[n] == cc[n] == v:
                    raise AssertionError(f"{label}: {n} launches per step "
                                         f"eager {ce[n]}, replay {cc[n]}, "
                                         f"expected {v}")
            if captured.replays != 5:
                raise AssertionError(f"{label}: step.replays "
                                     f"{captured.replays}, 5 calls")
            rec = dict(losses_eager=le, losses_captured=lc,
                       losses_eager_again=la, worst_vs_bar=worst,
                       worst_at=at, worst_without_spread=worst_plain,
                       kernels_eager=ce, kernels_replay=cc,
                       kernels_eager_profiler=ce_prof)

        with Phase(f"7b {label}: eager vs captured step time"):
            # both anew, outside deterministic mode (which makes index_add_
            # a sorted index_put_ and fills every new tensor): the eager
            # step as train_zinc runs it (a float LR) and a capture of it
            del runs, eager, captured
            model, opt, predict = make(False)
            plain_eager = build_steps(model, predict, opt)[0]
            cmodel, copt, cpredict = make(True)
            captured = capture_train_step(cmodel, cpredict, copt, gbs[0])
            cc = {n: captured.launches[k_of[n]] for n in per_step}
            n_params = len(list(cmodel.parameters()))
            print(f"  a replay's launches (step.launches): {cc}; {n_params} "
                  "parameter tensors"
                  + (", each cast to bf16 in the forward and its gradient "
                     "back to f32, in the eager step and in the replay"
                     if cdt is not None else ""), flush=True)
            for n, v in per_step.items():
                if cc[n] != v:
                    raise AssertionError(f"{label}: {n} launches per "
                                         f"replay {cc[n]}, expected {v}")
            profiling.COUNTERS.reset()
            ms = bench.interleaved_ms({"eager": plain_eager,
                                       "captured": captured}, gbs,
                                      repeats=3)
            for n, v in ms.items():
                print(f"  {n} (host clock, {len(v)} windows of 10 steps, "
                      f"{card}): median {float(np.median(v)):.2f} ms, min "
                      f"{min(v):.2f}, max {max(v):.2f}", flush=True)
            rec["step_ms"] = {n: bench.spread(v) for n, v in ms.items()}
            # the last device-span sample of the timed replays: every
            # region within its step, the step against the replays' median
            torch.cuda.synchronize()
            captured.spans.sample()
            last = profiling.COUNTERS.values("step.regions")[-1]
            med = float(np.median(ms["captured"]))
            print(f"  device spans of a sampled replay (ms): {last}; step / "
                  f"median replay {last['step'] / med:.3f}", flush=True)
            if not all(0 < v <= last["step"] for v in last.values()):
                raise AssertionError(f"{label}: device spans {last}")
            rec["device_spans"] = dict(last, step_over_median=last["step"]
                                       / med)
            for n, step in (("eager", plain_eager), ("captured", captured)):
                prof = _profile_steps(step, gbs[0], list(per_step))
                print(f"  profiler, {n}: {prof}", flush=True)
                rec[f"profile_{n}"] = prof
        rec.update(kernels_replay_timed=cc, parameter_tensors=n_params)
        record["captured"][label] = rec
        del captured, plain_eager, model, opt, cmodel, copt
        seg.set_agg_backend("xla")
        torch.cuda.empty_cache()
    gp = record["captured"]["GatedGCN f32"].get("profile_captured")
    if isinstance(gp, dict):
        # K4's plain backward (phase 1c, cold) for its 16 layers against the
        # captured GatedGCN step's device time
        share = 16 * k4_bwd_ms * 1e3 / gp["device_us_per_step"]
        print(f"K4 plain backward: 16 x {k4_bwd_ms * 1e3:.1f} us = "
              f"{16 * k4_bwd_ms:.2f} ms, {share:.1%} of the captured "
              f"GatedGCN step's device time", flush=True)
        record["k4_bwd_share_of_captured_step"] = share

    # ---------------------------------------------------------------- 8
    with Phase("8 the benches: bench --mode auto, bench_roofline"):
        # the port's bench.py and bench_roofline.py entry points, each in
        # its own process, as a user runs them; bench with 2 windows of
        # each mode's eager and captured steps (not 5) and bench_roofline
        # with loops of 10 replays (not 30): the run's time
        for mod, argv, limit in (("bench", ["--mode", "auto", "--trace",
                                            os.path.join(OUT_DIR, "trace"),
                                            "--windows", "2"], 420),
                                 ("bench_roofline", ["--reps", "10"], 300)):
            proc = subprocess.run(
                [sys.executable, "-m", f"signnet_basisnet_tpu_torch.{mod}",
                 *argv], capture_output=True, text=True, timeout=limit)
            with open(os.path.join(OUT_DIR, f"{mod}.log"), "w") as f:
                f.write(proc.stdout + "\n--- stderr\n" + proc.stderr)
            lines = proc.stdout.strip().splitlines()
            for line in lines[:-1]:
                print(f"  {mod}: {line}", flush=True)
            for line in proc.stderr.strip().splitlines()[-4:]:
                print(f"  {mod} (stderr): {line}", flush=True)
            if proc.returncode != 0 or not lines:
                raise AssertionError(f"{mod} exited {proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
            out = json.loads(lines[-1])
            record[mod] = out
            print(f"  {mod} last line: " + json.dumps(
                {k: v for k, v in out.items() if not isinstance(v, dict)}),
                flush=True)
        b = record["bench"]
        if not (b["value"] > 0 and b["unit"] == "edges/s"
                and b["mode"] in bench.CAPTURED and b["vs_baseline"] > 0
                and b["device"] == card):
            raise AssertionError(f"bench: unexpected last line {b}")
        mfu = {k: v for k, v in record["bench_roofline"].items()
               if k.startswith("mfu_")}
        if not mfu or not all(0 < v <= 100 for v in mfu.values()):
            raise AssertionError(f"bench_roofline: shares {mfu}")

    # ---------------------------------------------------------------- 9
    with Phase("9 checkpoint and resume on the card (train_zinc)"):
        ck_dir = os.path.join(OUT_DIR, "checkpoints")
        shutil.rmtree(ck_dir, ignore_errors=True)
        first = run(trainer_cfg(["train.epochs", "2", "name", "ckpt",
                                 "train.checkpoint_dir", ck_dir]),
                    device="cuda", log=lambda s: print("  " + s, flush=True))
        saved = torch.load(os.path.join(ck_dir, "epoch_1.pt"),
                           map_location="cpu", weights_only=True)
        logs = []
        resumed = run(trainer_cfg(["train.epochs", "3", "name", "ckpt",
                                   "train.checkpoint_dir", ck_dir,
                                   "train.resume", "true"]),
                      device="cuda", log=lambda s: (logs.append(s),
                                                    print("  " + s,
                                                          flush=True)))
        hist = resumed.history
        print(f"  saved epoch {saved['epoch']} lr {saved['lr']:.3e}; the "
              f"resumed run's epochs {[h['epoch'] for h in hist]}",
              flush=True)
        if not (saved["epoch"] == 1 == first.history[-1]["epoch"]
                and saved["lr"] == first.history[-1]["lr"]
                and [h["epoch"] for h in hist] == [2]
                and any("resumed from checkpoint epoch 1" in m for m in logs)
                and resumed.epochs_run == 3
                and np.isfinite([hist[0]["train_loss"], hist[0]["val_mae"],
                                 resumed.test_mae]).all()
                and sorted(os.listdir(ck_dir)) == ["epoch_1.pt",
                                                   "epoch_2.pt"]):
            raise AssertionError(f"resume did not continue from epoch 1 at "
                                 f"its LR: {first.history} -> {hist}")
        record.update(resume_first=first.history, resume_after=hist)

    # --------------------------------------------------------------- 10
    def masked_cfg(path, extra):
        return load_config(path, [
            "data.synth_train", "384", "data.synth_eval", "128",
            "train.print_epoch_interval", "1", "out_dir", OUT_DIR] + extra)

    gmcfg = masked_cfg(MASKED_GATEDGCN_CONFIG,
                       ["data.agg_backend", "pallas_tile"])
    tmcfg = masked_cfg(MASKED_TRANSFORMER_CONFIG, [])
    k_full = gmcfg.model.pos_enc_dim
    with Phase("10a masked GatedGCN full-width step, card vs CPU"):
        # full-EVD batches packed at k = 37, the phase-1 budgets; the phi's
        # first layer aggregates 2k = 74 channels of width 1, the other
        # seven 74 of 67 (F = 4958), all through K1
        gs_m = synthetic_zinc(512, 0, 0, seed=0)["train"]
        add_full_evd(gs_m, normalization=gmcfg.data.evd_normalization)
        arrays_m = pack_batches(gs_m, nb, eb, gc, k=k_full, tile=256)[0]
        print(f"  masked batch: {int(arrays_m['graph_mask'].sum())} graphs, "
              f"eigvecs {arrays_m['eigvecs'].shape}, largest graph "
              f"{int(arrays_m['n_node'].max())} nodes", flush=True)

        seg.set_agg_backend(gmcfg.data.agg_backend)
        torch.cuda.reset_peak_memory_stats()
        # the CPU's typical error as a floor, as for the Transformer (4a):
        # each f32 run flips pre-ReLU signs that lie within float noise of
        # 0 (printed), and one such flip in a GatedGCN layer's bn_h puts
        # that layer's A and B gradients an order of magnitude beyond the
        # CPU's f32 error: on the kernel path, and in some runs on the
        # card's plain path (no kernels) too
        # 4 of the net's 16 layers (the phi whole): the CPU's f64 step at
        # full depth costs more than the run's time allows beside phases
        # 16 and 17
        _, record["masked_gatedgcn_card_vs_cpu"] = _check_step_card_vs_cpu(
            "GatedGCN", dict(net_params(gmcfg, None), n_layers=4), arrays_m,
            lambda model: build_steps(
                model, make_zinc_predict(model, "sign_inv"),
                adam(model.parameters()))[0],
            plain_on_card=_gate_plain_on_card, floor_cpu_error=True,
            relu_inputs=lambda n: (n.endswith(("bn_h", "bn_e")) or (
                n.startswith("sign_inv_net") and n.endswith("lin_0"))))
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        print(f"  peak memory over the phase's card runs (f32, plain f32 "
              f"and plain f64 steps): {peak:.0f} MiB", flush=True)
        record["masked_gatedgcn_step_peak_mib"] = peak

    with Phase("10b masked Transformer full-width step, card vs CPU"):
        seg.set_agg_backend(tmcfg.data.agg_backend)
        _, record["masked_transformer_card_vs_cpu"] = (
            _check_step_card_vs_cpu(
                "Transformer", net_params(tmcfg, None), arrays_m,
                lambda model: build_steps(
                    model, make_zinc_predict(model, "sign_inv"),
                    adam(model.parameters()))[0],
                plain_on_card=_attention_plain_on_card,
                floor_cpu_error=True))

    from signnet_basisnet_tpu_torch.models import conv as conv_mod

    @contextlib.contextmanager
    def k1_widths():
        """The row widths of the forward K1 calls on the card while the
        block runs."""
        seen = []
        wrapped = conv_mod.spmm_tiled

        def spy(x, *a, **kw):
            if x.is_cuda:
                seen.append(x.shape[1])
            return wrapped(x, *a, **kw)

        conv_mod.spmm_tiled = spy
        try:
            yield seen
        finally:
            conv_mod.spmm_tiled = wrapped

    def run_path(tag, cfg, want_per_step, widths=None):
        """train_zinc.run of `cfg` with every counter at 0 just before it,
        read just after: each kernel's launches against want_per_step
        (kernel -> (per train step, per eval step)), the forward K1 widths
        against `widths` (width -> per forward), finite metrics; the
        step time of the last epoch (host clock) and peak memory."""
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with k1_widths() as seen:
            res = run(cfg, device="cuda", log=lambda s: print("  " + s,
                                                              flush=True))
        torch.cuda.synchronize()
        got = {"K1": spmm_tiled.launches, "K2": tiled.launches_fwd,
               "K3": tiled.launches_bwd, "K4": gate.launches,
               "K5": flat.launches}
        want = {k: 0 for k in got}
        for k, (tr, ev) in want_per_step.items():
            want[k] = tr * res.train_steps + ev * res.eval_steps
        print(f"  launches {got}; expected {want} for {res.train_steps} "
              f"train and {res.eval_steps} eval steps (per train, eval step: "
              f"{ {k: want_per_step.get(k, (0, 0)) for k in got} })",
              flush=True)
        if got != want:
            raise AssertionError(f"{tag}: launches {got}, expected {want}")
        if widths is not None:
            fwd = res.train_steps + res.eval_steps
            want_w = {f: n * fwd for f, n in widths.items()}
            got_w = {f: seen.count(f) for f in set(seen)}
            print(f"  forward K1 widths {got_w}, expected {want_w}",
                  flush=True)
            if got_w != want_w:
                raise AssertionError(f"{tag}: K1 widths {got_w}")
        h = res.history[-1]
        if (not all(np.isfinite([r["train_loss"], r["val_mae"]]).all()
                    for r in res.history)
                or not np.isfinite([res.val_mae, res.test_mae]).all()):
            raise AssertionError(f"{tag}: non-finite metrics {res.history}")
        if cfg.model.lap_method == "sign_flip":
            print(f"  eval flips drawn {res.eval_flip_draws} for "
                  f"{res.eval_steps} eval batches", flush=True)
            if res.eval_flip_draws != res.eval_steps:
                raise AssertionError(f"{tag}: eval generator drew "
                                     f"{res.eval_flip_draws} times")
        step_ms = h["train_time"] / h["train_steps"] * 1e3
        eval_ms = h["eval_time"] / max(h["eval_steps"], 1) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        print(f"  {tag} step time (epoch {h['epoch'] + 1}, "
              f"{h['train_steps']} steps, host clock to the last loss on "
              f"the host): {step_ms:.2f} ms; eval step {eval_ms:.2f} ms "
              f"({h['eval_steps']} steps); peak memory {peak:.0f} MiB; "
              f"val_mae {res.val_mae:.4f} test_mae {res.test_mae:.4f}",
              flush=True)
        record[f"{tag}_run"] = dict(
            step_ms=step_ms, eval_ms=eval_ms, peak_mib=peak, launches=got,
            train_steps=res.train_steps, eval_steps=res.eval_steps,
            val_mae=res.val_mae, test_mae=res.test_mae,
            history=res.history)
        return res

    # the masked GatedGCN: as the GatedGCN SignNet path, 16 K4 a step, the
    # phi's K1 8 forward (1 at F = 74, 7 at 4958) and 7 transposed
    gm_layers, gm_phi = gmcfg.model.n_layers, gmcfg.model.sign_inv_layers
    gm_widths = {2 * k_full: 1,
                 2 * k_full * gmcfg.model.hidden_dim: gm_phi - 1}
    tm_layers = tmcfg.model.n_layers
    for tag, cfg, want in (
            ("masked_gatedgcn_f32", gmcfg,
             {"K4": (gm_layers, gm_layers),
              "K1": (2 * gm_phi - 1, gm_phi)}),
            ("masked_gatedgcn_bf16", masked_cfg(
                MASKED_GATEDGCN_CONFIG, ["data.agg_backend", "pallas_tile",
                                         "train.compute_dtype",
                                         "bfloat16"]),
             {"K4": (gm_layers, gm_layers),
              "K1": (2 * gm_phi - 1, gm_phi)}),
            ("masked_transformer_f32", tmcfg,
             {"K2": (tm_layers, tm_layers), "K3": (tm_layers, 0)})):
        with Phase(f"10c {tag} (train_zinc, {cfg.data.agg_backend})"):
            cfg.train.epochs = 2
            cfg.name = tag
            run_path(tag, cfg, want,
                     gm_widths if "gatedgcn" in tag else {})

    # --------------------------------------------------------------- 11
    tiled_over = ["data.tile", "256", "data.agg_backend", "pallas_tile"]
    for name, extra, want, widths in (
            ("gatedgcn_zinc_lappe", tiled_over, {"K4": (16, 16)}, {}),
            ("gatedgcn_zinc_lappe_abs", tiled_over, {"K4": (16, 16)}, {}),
            ("gatedgcn_zinc_lappe_canonical", tiled_over, {"K4": (16, 16)},
             {}),
            ("gin_zinc_lappe", tiled_over, {"K1": (32, 16)}, {122: 16}),
            ("transformer_zinc_lappe",
             ["data.tile", "256", "data.agg_backend", "tile_dense"],
             {"K2": (8, 8), "K3": (8, 0)}, {}),
            ("gin_zinc_rwpe_lspe", tiled_over, {"K1": (32, 16)}, {95: 16}),
            ("gatedgcn_zinc_rwpe_lspe", tiled_over, {}, {})):
        with Phase(f"11 {name} (train_zinc, published widths)"):
            cfg = load_config(os.path.join("configs", f"{name}.json"),
                              extra + [
                "data.synth_train", "256", "data.synth_eval", "128",
                "train.epochs", "2", "train.print_epoch_interval", "1",
                "out_dir", OUT_DIR, "name", name])
            run_path(name, cfg, want, widths)
            if name == "transformer_zinc_lappe":
                d = cfg.model.hidden_dim // cfg.model.num_heads
                print(f"  attention head width D = {d}", flush=True)
                if d != 10:
                    raise AssertionError(f"D = {d}")

    # --------------------------------------------------------------- 12
    def pna_gat_cfg(name, extra):
        return load_config(os.path.join("configs", f"{name}.json"), extra + [
            "data.synth_train", "256", "data.synth_eval", "128",
            "train.epochs", "2", "train.print_epoch_interval", "1",
            "out_dir", OUT_DIR, "name", name])

    def phi_k1(cfg):
        """K1 under the GIN phi: (per train step, per eval step) and the
        forward widths (2k at layer 1, 2k x hidden at the other layers)."""
        m = cfg.model
        k, phi = m.pos_enc_dim, m.sign_inv_layers
        return (2 * phi - 1, phi), {2 * k: 1, 2 * k * m.hidden_dim: phi - 1}

    # PNA's avg_d_log from a train split as train_zinc takes it
    gs_pna = synthetic_zinc(512, 0, 0, seed=0)["train"]
    for label, path in (("12a PNA", PNA_CONFIG), ("12b GAT", GAT_CONFIG)):
        with Phase(f"{label} full-width step, card vs CPU (pallas_tile)"):
            # the phase-1 batch (k = 8, 128 graphs in 256-node tiles); the
            # PNA and GAT layers run no kernel, the GIN phi runs K1
            cfg = pna_gat_cfg(os.path.splitext(os.path.basename(path))[0],
                              tiled_over)
            m = cfg.model
            (per_train, _), want_w = phi_k1(cfg)
            seg.set_agg_backend(cfg.data.agg_backend)
            _reset_counts()
            with k1_widths() as seen:
                # 8 of the net's layers (the phi whole): the CPU's f64
                # step at full depth costs more than the run allows
                card_step, info = _check_step_card_vs_cpu(
                    m.model, dict(net_params(cfg, gs_pna), n_layers=8),
                    arrays,
                    lambda model: build_steps(
                        model, make_zinc_predict(model, m.lap_method),
                        adam(model.parameters()))[0],
                    plain_on_card=_gate_plain_on_card, floor_cpu_error=True,
                    bn_state=True)
            got = {"K1": spmm_tiled.launches, "K2": tiled.launches_fwd,
                   "K3": tiled.launches_bwd, "K4": gate.launches,
                   "K5": flat.launches}
            got_w = {f: seen.count(f) for f in set(seen)}
            want = {"K1": per_train, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
            print(f"  launches over the card's train step {got}, expected "
                  f"{want}; forward K1 widths {got_w}, expected {want_w}",
                  flush=True)
            if got != want or got_w != want_w:
                raise AssertionError(f"{label}: launches {got}, widths "
                                     f"{got_w}")
            held = info["worst_vs_pr4_bar"][0] <= 1
            print(f"  phase 5a's bar (10x the CPU's f32 error) "
                  f"{'holds' if held else 'does not hold'}: worst "
                  f"{info['worst_vs_pr4_bar'][0]:.3f} at "
                  f"{info['worst_vs_pr4_bar'][1]}; phase 4a's bar (with the "
                  f"CPU's median error as a floor, the card's plain f64 step "
                  f"within 1e-9) {info['worst'][0]:.3f}", flush=True)
            info["bar_5a_holds"] = held
            record[f"{m.model.lower()}_card_vs_cpu"] = info
            # where the eager step's device time goes (the layers' segment
            # ops, BN, the phi's K1), warm, on the same batch
            prof = _profile_steps(*card_step, ["spmm_tiled_kernel"])
            print(f"  profiler, {m.model} f32 eager step: {prof}",
                  flush=True)
            record[f"{m.model.lower()}_warm_f32_step_profile"] = prof
            del card_step

    over_none, masked_peak = [], record["masked_gatedgcn_f32_run"]["peak_mib"]
    for name, extra in (("pna_zinc_nope", over_none),
                        ("pna_zinc_lappe", over_none),
                        ("pna_zinc_signinv_gin", tiled_over),
                        ("pna_zinc_signinv_masked", over_none),
                        ("gat_zinc_nope", over_none),
                        ("gat_zinc_lappe", over_none),
                        ("gat_zinc_signinv_gin", tiled_over)):
        with Phase(f"12c {name} (train_zinc, published widths)"):
            cfg = pna_gat_cfg(name, extra)
            if cfg.data.agg_backend == "pallas_tile":
                per_step, widths = phi_k1(cfg)
                want = {"K1": per_step}
            else:
                want, widths = {}, {}
            run_path(name, cfg, want, widths)
            if name == "pna_zinc_signinv_masked":
                peak = record[f"{name}_run"]["peak_mib"]
                print(f"  peak memory {peak:.0f} MiB against the masked "
                      f"GatedGCN's {masked_peak:.0f} MiB (phase 10c)",
                      flush=True)

    # --------------------------------------------------------------- 13
    _phase_13(record, dev, _reset_counts, _counts)

    # --------------------------------------------------------------- 14
    _phase_14(record, _reset_counts, _counts)

    # --------------------------------------------------------------- 15
    _phase_15(record, dev, _reset_counts, _counts, run_path, arrays)

    # ----------------------------------------------------------- 16, 17
    _phase_17(record, _phase_16(record))

    kernels = [kern, kern2, kern3, kern4, kern5]
    record["kernels"] = kernels
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=float)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
