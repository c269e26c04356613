"""Benchmark: edges/s on the card of the flagship ZINC SignNet + GIN train
step, eager and captured in a CUDA graph.

Counterpart of the JAX package's bench.py, run from the repository root:

    python -m signnet_basisnet_tpu_torch.bench [--mode M] [--trace DIR]
        [--windows 5]

`--mode` takes the place of the JAX script's BENCH_MODE (default `auto`).
The step, the batches and the timing are the JAX script's: GINNet 16x95
with GINDeepSigns k = 8 (an 8-layer GIN phi, phi_out 4), Adam, 4 synthetic
128-graph batches from seed 0 cycled over the steps, `WARMUP` steps, then
the best of 3 timed loops of `STEPS` steps, each ended by a fetch of the
last loss's value.  Edges are the batches' real (unmasked) edges.

- `flat`: the eager step on flat batches, `xla` aggregation (gather +
  index_add_).  It is the baseline: `vs_baseline` is the chosen mode's
  edges/s over `flat`'s, measured in the same call on the same card.
- `onehot`: the same with the one-hot sum backend (graph/segment.py).
- `scan`, `bf16`, `tile`, `tile_bf16`, `tile_dense`, `tile_dense_bf16`:
  the train step captured once in a CUDA graph
  (`training.capture_train_step`) and replayed, each replay after a copy of
  the next batch into the graph's static batch: the counterpart of the JAX
  modes that run the whole loop on the device as one `lax.scan`.  `tile*`
  pack the batches in 256-node tiles; `tile` and `tile_bf16` aggregate
  through the tile-local SpMM kernel (K1), `tile_dense*` through the block
  adjacency; `*bf16` compute in bf16 with f32 master weights.  For each,
  the eager step of the same mode and the captured one also run in
  `--windows` interleaved windows of 10 steps (host clock, ms per step:
  median, min, max).
- `auto`: `flat` and the six captured modes; reports the fastest captured
  mode.  Each mode's edges/s goes to stderr.
- `dense`: the eager step on dense block batches (graph/dense.py: each
  128-graph batch as [128, 40, 40] adjacency blocks, `dense_batch_np(...,
  128, 40, k=8)`), the same model and weights' seed: aggregation is a
  batched einsum and no kernel runs, as in the JAX script's
  `bench_tpu_dense`.  Its edges are the adjacency's ones.  As in the JAX
  script, `auto` leaves it out.

A mode that fails fails the run: nothing is caught.  The last line of
stdout is one JSON object with the JAX script's keys (`metric`, `value`,
`unit`, `vs_baseline`, `mode`, ...) plus `device`, the card's name and
power limit from nvidia-smi.  `torch_cpu_fresh_eps` is the JAX script's
torch-on-CPU scatter baseline (`bench_torch_cpu`, copied here), run fresh
on the host's CPU and only reported.  f32 matmuls run in full f32.
It measures the card: without one it raises.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from .data import add_lap_pe, choose_budgets, pack_batches, synthetic_zinc
from .graph import dense_batch_np, dense_from_arrays, from_arrays
from .graph import segment as seg
from .models import gnn_model
from .training import (adam, build_steps, capture_train_step,
                       make_zinc_predict)
from .utils.profiling import (Throughput, card_label, log_memory, timed,
                              trace)

STEPS = 30
WARMUP = 5
BATCH_GRAPHS = 128
HIDDEN = 95
N_LAYERS = 16
K = 8
SIGN_INV_LAYERS = 8
PHI_OUT = 4
NUM_BATCHES = 4
SEED = 0
TILE = 256  # tile-local layout: the node tile of K1 and the block adjacency
DENSE_MAX_NODES = 40  # dense mode's blocks: ZINC graphs have <= 38 nodes
LR = 1e-3
NET = dict(hidden_dim=HIDDEN, out_dim=HIDDEN, n_layers=N_LAYERS,
           pos_enc_dim=K, lap_method="sign_inv",
           sign_inv_layers=SIGN_INV_LAYERS, phi_out_dim=PHI_OUT,
           batch_norm=True, dropout=0.0)
METRIC = "edges_per_s_per_chip_zinc_signnet_gin_train"

# captured modes: (tile, aggregation backend, compute dtype)
CAPTURED = {
    "scan": (None, "xla", None),
    "bf16": (None, "xla", torch.bfloat16),
    "tile": (TILE, "pallas_tile", None),
    "tile_bf16": (TILE, "pallas_tile", torch.bfloat16),
    "tile_dense": (TILE, "tile_dense", None),
    "tile_dense_bf16": (TILE, "tile_dense", torch.bfloat16),
}
# eager modes on flat batches: the sum backend
EAGER = {"flat": "xla", "onehot": "onehot"}
MODES = ("auto", *EAGER, *CAPTURED, "dense")


def build_batches(num_batches=NUM_BATCHES, tile=None,
                  batch_graphs=BATCH_GRAPHS, k=K):
    """The JAX script's batches: `num_batches` x `batch_graphs` synthetic
    ZINC graphs from seed 0 with k Laplacian eigenvectors, packed to one
    set of budgets (numpy arrays)."""
    train = synthetic_zinc(num_train=batch_graphs * num_batches, num_val=8,
                           num_test=8, seed=SEED)["train"]
    add_lap_pe(train, k)
    nb, eb, gc = choose_budgets(train, batch_graphs, tile=tile)
    return pack_batches(train, nb, eb, gc, k=k, tile=tile)


def build_dense_batches(num_batches=NUM_BATCHES, batch_graphs=BATCH_GRAPHS,
                        k=K, max_nodes=DENSE_MAX_NODES):
    """The JAX script's dense batches: the same graphs as `build_batches`',
    each chunk of `batch_graphs` packed in [batch_graphs, max_nodes, ...]
    blocks (numpy arrays)."""
    train = synthetic_zinc(num_train=batch_graphs * num_batches, num_val=8,
                           num_test=8, seed=SEED)["train"]
    add_lap_pe(train, k)
    return [dense_batch_np(train[i * batch_graphs:(i + 1) * batch_graphs],
                           batch_graphs, max_nodes, k=k)
            for i in range(num_batches)]


@contextlib.contextmanager
def backends(agg="xla", sums="xla"):
    """The aggregation and sum backends while the block runs."""
    saved = seg.get_agg_backend(), seg.get_sum_backend()
    seg.set_agg_backend(agg)
    seg.set_sum_backend(sums)
    try:
        yield
    finally:
        seg.set_agg_backend(saved[0])
        seg.set_sum_backend(saved[1])


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _model_and_predict(net, device, compute_dtype):
    model = gnn_model("GIN", **net).to(device)
    return model, make_zinc_predict(model, net["lap_method"],
                                    compute_dtype=compute_dtype)


def eager_step(net, device, compute_dtype=None):
    """The eager train step of a fresh model (float LR Adam)."""
    model, predict = _model_and_predict(net, device, compute_dtype)
    return build_steps(model, predict, adam(model.parameters()))[0]


def captured_step(net, batch, compute_dtype=None):
    """The train step of a fresh model captured on `batch` (on the card)."""
    model, predict = _model_and_predict(net, batch.senders.device,
                                        compute_dtype)
    opt = adam(model.parameters(), capturable=True)
    return capture_train_step(model, predict, opt, batch)


def time_steps(step, gbs, host_gbs, steps=STEPS, warmup=WARMUP):
    """edges/s of `step` over the batches cycled: `warmup` steps, then the
    best of 3 loops of `steps`, each timed to a fetch of its last loss's
    value (the barrier: it cannot return before the chained steps ran).
    `host_gbs` are the same batches on the host, for counting real edges
    without touching the card inside the loop."""
    n = len(gbs)
    for i in range(warmup):
        m = step(gbs[i % n], LR)
    float(m["loss"])
    best = None
    for _ in range(3):
        with timed() as t:
            for i in range(steps):
                m = step(gbs[i % n], LR)
            float(m["loss"])
        tp = Throughput()
        for i in range(steps):
            tp.add(host_gbs[i % n], t["seconds"] / steps)
        if best is None or tp.edges_per_s > best.edges_per_s:
            best = tp
    return best.summary()


def interleaved_ms(steps, gbs, repeats=5, window=10):
    """Host-clock ms per step of each named step function, the batches
    cycled: `repeats` windows of `window` steps each, the functions taking
    turns window by window so that a slow spell of the shared host falls on
    all of them alike.  Each window ends in a synchronize."""
    dev = gbs[0].senders.device
    n = len(gbs)
    for step in steps.values():
        for i in range(2):
            step(gbs[i % n], LR)
    _sync(dev)
    ms = {name: [] for name in steps}
    for _ in range(repeats):
        for name, step in steps.items():
            with timed() as t:
                for i in range(window):
                    step(gbs[i % n], LR)
                _sync(dev)
            ms[name].append(t["seconds"] / window * 1e3)
    return ms


def spread(v):
    return dict(median=float(np.median(v)), min=float(min(v)),
                max=float(max(v)), windows=[float(x) for x in v])


def bench_eager(batches, device, sum_backend="xla", net=NET, steps=STEPS,
                warmup=WARMUP):
    """The eager step on `batches` (flat, xla aggregation): summary of the
    best timed loop (edges_per_s, step_ms, ...)."""
    with backends("xla", sum_backend):
        host = [from_arrays(a) for a in batches]
        gbs = [gb.to(device) for gb in host]
        return time_steps(eager_step(net, device), gbs, host, steps, warmup)


def bench_dense(batches, device, net=NET, steps=STEPS, warmup=WARMUP):
    """The eager step on dense `batches`: summary of the best timed loop
    (edges_per_s, step_ms, ...)."""
    host = [dense_from_arrays(a) for a in batches]
    gbs = [gb.to(device) for gb in host]
    return time_steps(eager_step(net, device), gbs, host, steps, warmup)


def bench_captured(batches, device, agg_backend="xla", compute_dtype=None,
                   trace_dir=None, windows=5):
    """One captured mode: the best timed loop of the captured step, then
    the eager and the captured step of the mode in interleaved windows."""
    with backends(agg_backend, "xla"):
        host = [from_arrays(a) for a in batches]
        gbs = [gb.to(device) for gb in host]
        step = captured_step(NET, gbs[0], compute_dtype)
        rec = time_steps(step, gbs, host)
        eager = eager_step(NET, device, compute_dtype)
        ms = interleaved_ms({"eager": eager, "captured": step}, gbs,
                            repeats=windows)
        rec["step_ms_windows"] = {k: spread(v) for k, v in ms.items()}
        edges = float(np.mean([b["edge_mask"].sum() for b in batches]))
        rec["eager_edges_per_s"] = (
            edges / rec["step_ms_windows"]["eager"]["median"] * 1e3)
        if trace_dir:
            with trace(trace_dir):
                for i in range(3):
                    eager(gbs[i % len(gbs)], LR)
                    step(gbs[i % len(gbs)], LR)
                _sync(device)
    return rec


def bench_torch_cpu(batches, steps=4):
    """The JAX script's baseline, copied: the same GIN + SignNet
    architecture with index_select + index_add message passing in torch on
    the CPU (PyG-style), edges/s over `steps` steps of the first batch."""
    import torch.nn as nn

    b = batches[0]
    senders = torch.tensor(np.asarray(b["senders"]), dtype=torch.long)
    receivers = torch.tensor(np.asarray(b["receivers"]), dtype=torch.long)
    emask = torch.tensor(np.asarray(b["edge_mask"]))[:, None]
    x_feat = torch.tensor(np.asarray(b["node_feat"]), dtype=torch.long)
    pe = torch.tensor(np.asarray(b["eigvecs"]))
    gid = torch.tensor(np.asarray(b["graph_id"]), dtype=torch.long)
    y = torch.tensor(np.asarray(b["y"]))
    N = x_feat.shape[0]
    G = y.shape[0]

    def agg(x):
        msg = x.index_select(0, senders) * emask
        out = torch.zeros_like(x)
        return out.index_add(0, receivers, msg)

    class MLP2(nn.Module):
        def __init__(s, i, h, o):
            super().__init__()
            s.l1, s.l2 = nn.Linear(i, h), nn.Linear(h, o)
            s.bn = nn.BatchNorm1d(h)

        def forward(s, x):
            shp = x.shape
            h = torch.relu(s.l1(x))
            h = s.bn(h.reshape(-1, h.shape[-1])).reshape(*shp[:-1], -1)
            return s.l2(h)

    class Net(nn.Module):
        def __init__(s):
            super().__init__()
            s.emb = nn.Embedding(28, HIDDEN)
            s.pe_lin = nn.Linear(K, HIDDEN)
            s.phi = nn.ModuleList([
                MLP2(1 if i == 0 else HIDDEN, HIDDEN,
                     PHI_OUT if i == SIGN_INV_LAYERS - 1 else HIDDEN)
                for i in range(SIGN_INV_LAYERS)])
            rho = []
            d = PHI_OUT * K
            for i in range(SIGN_INV_LAYERS - 1):
                rho += [nn.Linear(d, HIDDEN), nn.ReLU()]
                d = HIDDEN
            rho.append(nn.Linear(d, K))
            s.rho = nn.Sequential(*rho)
            s.convs = nn.ModuleList([MLP2(HIDDEN, HIDDEN, HIDDEN)
                                     for _ in range(N_LAYERS)])
            s.head = nn.Linear(HIDDEN, 1)

        def forward(s, pe):
            v = pe.unsqueeze(-1)
            a, bneg = v, -v
            for lin in s.phi:
                a = lin(agg(a.reshape(N, -1)).reshape(N, K, -1))
                bneg = lin(agg(bneg.reshape(N, -1)).reshape(N, K, -1))
            p = s.rho((a + bneg).reshape(N, -1))
            h = s.emb(x_feat) + s.pe_lin(p)
            for conv in s.convs:
                h = conv(h + agg(h))
            hg = torch.zeros(G, HIDDEN).index_add(0, gid, h)
            return s.head(hg)

    net = Net()
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    edges = float(np.asarray(b["edge_mask"]).sum())
    loss = (net(pe)[:, 0] - y[:, 0]).abs().mean()
    loss.backward(); opt.step(); opt.zero_grad()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = (net(pe)[:, 0] - y[:, 0]).abs().mean()
        loss.backward(); opt.step(); opt.zero_grad()
    return edges * steps / (time.perf_counter() - t0)


def pack_ms_per_batch():
    """Host ms to pack one 128-graph batch in tiles with the numpy packer
    (median of 3 packings of the bench's graphs)."""
    train = synthetic_zinc(num_train=BATCH_GRAPHS * NUM_BATCHES,
                           num_val=8, num_test=8, seed=SEED)["train"]
    add_lap_pe(train, K)
    nb, eb, gc = choose_budgets(train, BATCH_GRAPHS, tile=TILE)
    ms = []
    for _ in range(3):
        with timed() as t:
            out = pack_batches(train, nb, eb, gc, k=K, tile=TILE)
        ms.append(t["seconds"] / len(out) * 1e3)
    return float(np.median(ms))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="auto", choices=MODES)
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler trace of 3 eager and 3 "
                         "captured steps of each captured mode into DIR")
    ap.add_argument("--windows", type=int, default=5,
                    help="interleaved windows of 10 eager and 10 captured "
                         "steps per captured mode")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: bench measures the card")
    dev = torch.device("cuda")
    say = lambda msg: print(msg, file=sys.stderr, flush=True)
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        flat = build_batches()
        tiled = None
        runs = {"flat": bench_eager(flat, dev)}
        if args.mode == "onehot":
            runs["onehot"] = bench_eager(flat, dev, sum_backend="onehot")
        if args.mode == "dense":
            runs["dense"] = bench_dense(build_dense_batches(), dev)
            print(f"dense: eager step {runs['dense']['step_ms']:.2f} ms "
                  f"(host clock, best of 3 loops of {STEPS})", flush=True)
        todo = (list(CAPTURED) if args.mode == "auto"
                else [args.mode] if args.mode in CAPTURED else [])
        for mode in todo:
            tile, agg, dtype = CAPTURED[mode]
            if tile is not None and tiled is None:
                tiled = build_batches(tile=TILE)
            runs[mode] = bench_captured(
                tiled if tile else flat, dev, agg, dtype,
                trace_dir=(os.path.join(args.trace, mode) if args.trace
                           else None), windows=args.windows)
            log_memory(say, dev, prefix=f"# {mode} ")
        eps = {k: v["edges_per_s"] for k, v in runs.items()}
        say("# " + " ".join(f"{k}={v:.0f}" for k, v in eps.items())
            + " edges/s")
        chosen = (max(todo, key=eps.get) if args.mode == "auto"
                  else args.mode)
        for mode in todo:
            w = runs[mode]["step_ms_windows"]
            print(f"{mode}: step ms over {args.windows} interleaved "
                  f"windows of 10 "
                  f"(host clock): eager median {w['eager']['median']:.2f} "
                  f"(min {w['eager']['min']:.2f}, max "
                  f"{w['eager']['max']:.2f}), captured median "
                  f"{w['captured']['median']:.2f} (min "
                  f"{w['captured']['min']:.2f}, max "
                  f"{w['captured']['max']:.2f})", flush=True)
        pack_ms = pack_ms_per_batch()
        fresh = bench_torch_cpu(flat)
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
    line = {
        "metric": METRIC,
        "value": round(eps[chosen], 1),
        "unit": "edges/s",
        "vs_baseline": round(eps[chosen] / eps["flat"], 3),
        "mode": chosen,
        "baseline": "flat (eager step, xla aggregation), this call",
        "flat_eager_eps": round(eps["flat"], 1),
        "modes": runs,
        "numpy_pack_ms_per_batch": round(pack_ms, 3),
        "torch_cpu_fresh_eps": round(fresh, 1),
        "device": card_label(),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
