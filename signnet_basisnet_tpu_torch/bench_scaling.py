"""Scaling of the parallel paths: the port of the root bench_scaling.py.

    python -m signnet_basisnet_tpu_torch.bench_scaling [--reps 10]
        [--device cpu]

- Data parallelism, weak scaling (parallel/data_parallel.py): the
  SignNetGNN train step (32 wide, 4-layer SignNet, 8 GINE layers, 2 rho
  layers) with a fixed microbatch of 15 graphs (512 nodes, 2048 edges) on
  each rank, at world sizes 1, 2, 4 and 8: ms a step and microbatches a
  second.
- Model parallelism, strong scaling (parallel/mp_halo.py): one fixed
  global batch of 60 graphs (GatedGCNNet 32 wide, 8 layers, a 4-layer
  SignNet phi) over mp = 1, 2, 4 and 8 shards; mp 1 is the single-device
  step.  The halo
  H (rows a rank sends each peer), the rows and bytes one exchange of the
  32-wide node features moves a rank, and ms a step.
- GSPMD (parallel/gspmd.py), weak scaling as the JAX script runs it: the
  DP net's step, unchanged, on `make_global(world)` (world microbatches'
  graphs in one batch) with its node and edge axes sharded over a ("dp",
  "mp") mesh of dp = world: ms a step and microbatches a second.

Ranks are processes that `parallel.mesh.spawn_ranks` starts, one a rank;
a world of each size starts once and runs the three sections in turn.
Where the host has a card for every rank they talk over NCCL, and the
world size measures scaling; a world of up to two ranks a card shares the
cards over gloo, and then measures the overhead of the parallel step
(collectives through host memory, ranks taking turns on one card), not
scaling: such lines say "overhead, ranks share a card".  Larger worlds are
skipped.  The run is on the card(s) unless `--device cpu` is given; then
worlds of up to two ranks run over gloo on the CPU, at the same sizes.
Prints one line a measurement and, last, one JSON object with every time,
the device and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .graph import batch_np, from_arrays
from .models import SignNetGNN, gnn_model
from .parallel import (build_dp_steps, build_gspmd_steps, build_mp_steps,
                       device_arrays_mp, make_mesh, partition_batch_mp,
                       shard_arrays_mp)
from .parallel.mesh import spawn_ranks
from .spectral import full_evd_np
from .training import (adam, build_steps, make_module_predict,
                       make_zinc_predict)
from .utils import card_label, card_or_cpu

GRAPHS_PER_MICRO = 15
MICRO_NODES, MICRO_EDGES = 512, 2048
MP_GRAPHS = 4                      # the mp batch: 4 microbatches' graphs
LR = 1e-3


def make_graphs(seed: int, count: int):
    """Molecule-like random graphs (about 3 edges a node) with their full
    EVD, as the JAX script makes them."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(count):
        n = int(rng.integers(9, 30))
        A = np.triu((rng.random((n, n)) < 3.0 / n).astype(int), 1)
        A = A + A.T
        s, r = np.nonzero(A)
        vals, vecs = full_evd_np(s, r, n)
        graphs.append(dict(senders=s, receivers=r,
                           node_feat=rng.integers(0, 28, n),
                           edge_feat=rng.integers(0, 4, len(s)),
                           y=np.array([float(rng.normal())], np.float32),
                           eigvals=vals, eigvecs=vecs))
    return graphs


def make_micro(seed: int):
    return batch_np(make_graphs(seed, GRAPHS_PER_MICRO),
                    num_nodes=MICRO_NODES, num_edges=MICRO_EDGES,
                    num_graphs=GRAPHS_PER_MICRO + 1, k=8)


def make_global(dp: int):
    """dp microbatches' graphs in one padded batch of dp times the
    budgets."""
    graphs = []
    for i in range(dp):
        graphs += make_graphs(i, GRAPHS_PER_MICRO)
    return batch_np(graphs, num_nodes=MICRO_NODES * dp,
                    num_edges=MICRO_EDGES * dp,
                    num_graphs=GRAPHS_PER_MICRO * dp + dp, k=8)


def _ms_per_step(step, reps: int, device) -> float:
    """Host-clock ms of one call of `step`, after one warm call, over
    `reps` calls ending in a synchronize."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    step()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def _mp_net():
    return gnn_model("GatedGCN", hidden_dim=32, out_dim=32, n_layers=8,
                     pos_enc_dim=8, lap_method="sign_inv", sign_inv_layers=4,
                     phi_out_dim=4, batch_norm=True, dropout=0.0)


def _dp_net():
    return SignNetGNN(n_hid=32, n_out=1, nl_signnet=4, nl_gnn=8, nl_rho=2)


def dp_rank(rank, dev, reps):
    """One rank of the weak-scaling DP run: ms a step on its fixed
    microbatch."""
    model = _dp_net().to(dev)
    stack = [from_arrays(make_micro(rank)).to(dev)]
    train, _ = build_dp_steps(model, make_module_predict(model),
                              adam(model.parameters()))
    return _ms_per_step(lambda: train(stack, LR, 0), reps, dev)


def gspmd_rank(rank, dev, reps):
    """One rank of the weak-scaling GSPMD run: ms a step on the global
    batch of the world's microbatches, sharded over "dp"."""
    world = torch.distributed.get_world_size()
    model = _dp_net().to(dev)
    gb = from_arrays(make_global(world)).to(dev)
    train, _ = build_gspmd_steps(model, make_module_predict(model),
                                 adam(model.parameters()),
                                 make_mesh(dp=world, mp=1,
                                           device_type=dev.type), gb,
                                 axis="dp")
    return _ms_per_step(lambda: train(gb, LR), reps, dev)


def mp_rank(rank, dev, reps):
    """One rank of the strong-scaling mp run on the fixed global batch."""
    net = _mp_net().to(dev)
    mp = torch.distributed.get_world_size()
    parts = partition_batch_mp(make_global(MP_GRAPHS), mp)
    arrs = shard_arrays_mp(device_arrays_mp(parts), rank, dev)
    train, _ = build_mp_steps(net, make_zinc_predict(net, "sign_inv"),
                              adam(net.parameters()))
    ms = _ms_per_step(lambda: train(arrs, LR), reps, dev)
    return {"ms": ms, "halo": parts["halo"], "shard_n": parts["shard_n"]}


def _mp_single(dev, reps):
    net = _mp_net().to(dev)
    gb = from_arrays(make_global(MP_GRAPHS)).to(dev)
    train, _ = build_steps(net, make_zinc_predict(net, "sign_inv"),
                           adam(net.parameters()))
    return _ms_per_step(lambda: train(gb, LR), reps, dev)


WORLDS = (1, 2, 4, 8)
SECTIONS = {"dp": dp_rank, "gspmd": gspmd_rank, "mp_halo": mp_rank}


def world_rank(rank, dev, reps, sections):
    """One rank of a world: each named section's run in turn, so that a
    world starts once for all of them."""
    return [SECTIONS[name](rank, dev, reps) for name in sections]


def _plan(world: int, device: torch.device):
    """(backend, label) of a world, or None where it is skipped: over two
    ranks a card, or over two CPU ranks."""
    if device.type == "cpu":
        return ("gloo", "CPU ranks") if world <= 2 else None
    cards = torch.cuda.device_count()
    if world <= cards:
        return "nccl", "scaling, a card a rank"
    if world <= 2 * cards:
        return "gloo", "overhead, ranks share a card"
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = card_or_cpu(args.device)
    card = card_label() if device.type == "cuda" else "cpu"
    print(f"device: {card}", flush=True)
    results = {"device": card, "dp": {}, "gspmd": {}, "mp_halo": {}}

    # mp 1 is the single-device step, in this process
    ms = _mp_single(device, args.reps)
    results["mp_halo"][1] = {"ms": ms}
    print(f"mp 1 (single device): {ms:8.2f} ms/step", flush=True)
    for w in WORLDS:
        sections = ["dp", "gspmd"] + (["mp_halo"] if w > 1 else [])
        plan = _plan(w, device)
        if plan is None:
            for name in sections:
                print(f"{'mp' if name == 'mp_halo' else name + ' world'} "
                      f"{w}: skipped (too many ranks)", flush=True)
            continue
        backend, label = plan
        runs = spawn_ranks(world_rank, w, (args.reps, sections),
                           device=device.type, backend=backend)
        for i, name in enumerate(sections):
            res = [r[i] for r in runs]
            if name != "mp_halo":
                ms = max(res)
                results[name][w] = {"ms": ms, "backend": backend,
                                    "label": label}
                print(f"{name} world {w} ({backend}, {label}): {ms:8.2f} "
                      f"ms/step ({w / ms * 1e3:.2f} microbatches/s)",
                      flush=True)
                continue
            H, shard_n = res[0]["halo"], res[0]["shard_n"]
            rows = w * H
            ms = max(r["ms"] for r in res)
            results["mp_halo"][w] = {
                "ms": ms, "backend": backend, "label": label, "halo": H,
                "shard_n": shard_n, "rows_per_exchange": rows,
                "bytes_per_exchange": rows * 32 * 4}
            print(f"mp {w} ({backend}, {label}): halo H = {H} rows a pair, "
                  f"{rows} rows ({rows * 32 * 4} bytes of 32-wide f32) an "
                  f"exchange a rank, {100 * rows / (shard_n * w):.1f} % of "
                  f"N; {ms:8.2f} ms/step (strong scaling, fixed global "
                  f"batch)", flush=True)

    for name in ("dp", "gspmd"):
        runs = results[name]
        if 1 in runs:
            print(f"{name} weak-scaling efficiency vs world 1: " + "  ".join(
                f"{w}: {runs[1]['ms'] / v['ms'] * 100:5.1f}% ({v['label']})"
                for w, v in sorted(runs.items())), flush=True)
    mh = results["mp_halo"]
    if 1 in mh:
        print("mp strong-scaling efficiency (speedup / mp): " + "  ".join(
            f"{m}: {mh[1]['ms'] / (v['ms'] * m) * 100:5.1f}%"
            for m, v in sorted(mh.items())), flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
