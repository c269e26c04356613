"""Command-line entry point: Alchemy 12-target regression with the SignNet
PE (the Alchemy workload).

    python -m signnet_basisnet_tpu_torch.train_alchemy [--device cpu] \
        [--seeds 5] [--epochs 1000] [...]

Port of signnet_basisnet_tpu/train_alchemy.py, with its arguments and
`--device` (`cuda` unless `cpu` is given; without a card it raises): the
seed loop (a seed whose results JSON exists under `--out_dir` is skipped),
y standardised with the train split's statistics, all n eigenpairs of
L = D - A per graph, SignNetGNN (hidden 108, an 8-layer masked GIN phi, an
8-layer set-transformer rho, 16 GINE layers, 12 targets), Adam (decoupled
weight decay), L1 loss, plateau LR (factor 0.5, patience 5) with the
min-lr stop, the test MAE at the best-val epoch (`best_val_test`), and per
seed checkpoints under `--ckpt_dir/s<seed>` with `--resume`.  The per-target
test MAE and logMAE (the mean of the per-target logs) are those of the
final state.  The real `alchemy_full` TUDataset with its `*_al_10.index`
splits is read from `--data_dir` where it exists, else the synthetic
stand-in.  Batches are packed untiled, as the JAX trainer packs them, so no
kernel runs: the phi's aggregation is the flat gather + index_add_.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .data import (add_full_evd, choose_budgets, code_columns,
                   iterate_graphbatches, load_alchemy, pack_batches,
                   standardize_targets)
from .graph import from_arrays
from .models import SignNetGNN
from .training import (Checkpointer, adam, build_steps, count_params, fit,
                       make_module_predict)
from .training import metrics as M
from .utils import card_or_cpu


def _seed_json(args, seed):
    return (os.path.join(args.out_dir, f"alchemy_s{seed}.json")
            if args.out_dir else None)


@torch.no_grad()
def per_target_mae(model, batches) -> np.ndarray:
    """The [12] test MAE per target of `model` in eval mode."""
    model.eval()
    sums, cnt = None, 0.0
    for gb in batches:
        n = gb.graph_mask.sum()
        s = M.masked_l1_per_target(model(gb), gb.y, gb.graph_mask) * n
        sums = s if sums is None else sums + s
        cnt += float(n)
    return sums.cpu().numpy() / max(cnt, 1.0)


def run(args, log=print):
    device = card_or_cpu(args.device)
    splits, real = load_alchemy(args.data_dir,
                                synth_sizes=(args.synth_train,
                                             args.synth_eval,
                                             args.synth_eval))
    log(f"dataset: Alchemy ({'real' if real else 'synthetic'})")
    standardize_targets(splits)
    for graphs in splits.values():
        add_full_evd(graphs, normalization=None)

    nb, eb, gcnt = choose_budgets(splits["train"], args.batch_size)
    mk = lambda graphs: [from_arrays(a).to(device) for a in pack_batches(
        graphs, nb, eb, gcnt, shuffle=False, seed=0)]
    val_b = mk(splits["val"])
    test_b = mk(splits["test"])

    results = []
    for seed in range(args.seed0, args.seeds):
        sj = _seed_json(args, seed)
        if sj and os.path.exists(sj):
            with open(sj) as f:
                d = json.load(f)
            log(f"seed {seed}: already done (MAE {d['test_mae']:.4f}), skip")
            results.append((d["test_mae"], d["logmae"]))
            continue
        model = SignNetGNN(
            n_hid=args.hidden, n_out=12, nl_signnet=args.nl_signnet,
            nl_gnn=args.nl_gnn, nl_rho=args.nl_rho, gnn_type="GINEConv",
            phi_gnn_type=args.phi_gnn_type, node_vocab=args.node_vocab,
            edge_vocab=args.edge_vocab,
            node_code_dims=code_columns(splits["train"], "node_feat"),
            edge_code_dims=code_columns(splits["train"], "edge_feat"),
            seed=seed).to(device)
        if seed == 0:
            log(f"params: {count_params(model)}")
        optimizer = adam(model.parameters(), args.weight_decay)
        train_step, eval_step = build_steps(model, make_module_predict(model),
                                            optimizer)
        ckpt = (Checkpointer(os.path.join(args.ckpt_dir, f"s{seed}"))
                if args.ckpt_dir else None)
        res = fit(train_step, eval_step,
                  train_batches_fn=lambda ep, seed=seed: iterate_graphbatches(
                      splits["train"], nb, eb, gcnt, shuffle=True,
                      seed=seed * 10000 + ep, prefetch=4, device=device),
                  val_batches_fn=lambda: val_b,
                  test_batches_fn=lambda: test_b,
                  epochs=args.epochs, init_lr=args.lr,
                  lr_reduce_factor=0.5, lr_schedule_patience=5, min_lr=1e-6,
                  max_time_hours=args.max_time_hours,
                  log_every=args.log_every, logger=log, checkpointer=ckpt,
                  resume=args.resume, model=model, optimizer=optimizer,
                  best_val_test=True)
        mae_t = per_target_mae(model, test_b)
        logmae = float(np.log(np.maximum(mae_t, 1e-12)).mean())
        log(f"seed {seed}: test MAE {res.test_mae:.4f} "
            f"logMAE {logmae:.4f} (epochs {res.epochs_run})")
        log("  per-target MAE: " + " ".join(f"{v:.4f}" for v in mae_t))
        if sj:
            os.makedirs(args.out_dir, exist_ok=True)
            with open(sj, "w") as f:
                json.dump(dict(seed=seed, test_mae=float(res.test_mae),
                               logmae=logmae,
                               per_target_mae=[float(v) for v in mae_t],
                               val_mae=float(res.val_mae),
                               best_val_mae=float(res.best_val_mae),
                               epochs=res.epochs_run,
                               wall_time=res.wall_time, device=str(device),
                               history=res.history), f, indent=2)
        results.append((res.test_mae, logmae))
    arr = np.array(results)
    log(f"FINAL over {len(results)} seeds: MAE {arr[:, 0].mean():.4f} "
        f"+- {arr[:, 0].std():.4f}; logMAE {arr[:, 1].mean():.4f}")
    return arr


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data_dir", default="data/alchemy")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--weight_decay", type=float, default=1e-5)
    ap.add_argument("--hidden", type=int, default=108)
    ap.add_argument("--nl_signnet", type=int, default=8)
    ap.add_argument("--nl_gnn", type=int, default=16)
    ap.add_argument("--nl_rho", type=int, default=8)
    ap.add_argument("--phi_gnn_type", default="MaskedGINConv",
                    choices=["MaskedGINConv", "MaskedGINEConv"])
    ap.add_argument("--node_vocab", type=int, default=10)
    ap.add_argument("--edge_vocab", type=int, default=10)
    ap.add_argument("--synth_train", type=int, default=10000)
    ap.add_argument("--synth_eval", type=int, default=1000)
    ap.add_argument("--max_time_hours", type=float, default=12.0)
    ap.add_argument("--log_every", type=int, default=5)
    ap.add_argument("--seed0", type=int, default=0,
                    help="first seed (retries skip completed seeds)")
    ap.add_argument("--out_dir", default=None,
                    help="write per-seed results JSON here")
    ap.add_argument("--ckpt_dir", default=None,
                    help="per-seed checkpoint dirs under this root")
    ap.add_argument("--resume", action="store_true",
                    help="resume each seed from its latest checkpoint")
    return ap


if __name__ == "__main__":
    run(build_parser().parse_args())
