"""Command-line entry point: GINE + SignNet on ZINC over all eigenvectors
(the GINESignNetPyG workload).

    python -m signnet_basisnet_tpu_torch.train_zinc_gine [--device cpu] \
        [--epochs 310] [...]

Port of signnet_basisnet_tpu/train_zinc_gine.py, with its arguments and
`--device` (`cuda` unless `cpu` is given; without a card it raises):
SignNetGNN with GINE layers (hidden 110, 6 layers), an 8-layer masked GIN
(or GINE) phi and a 1-layer set-transformer rho over all n eigenpairs of
L = D - A per graph (masked per graph), eigenvalues ignored; Adam, L1
loss, StepLR (halved every `--lr_step` epochs); the share of train graphs
whose eigenvalues are all distinct (rounded to 5 decimals) logged at the
start; the test MAE at the best-val epoch reported.  With `--ckpt_dir` the
train state (the model, Adam, the dropout generator) and best_val /
best_test are saved after every epoch; `--resume` restarts after the
latest, replaying StepLR to that epoch.  `--out_dir` gets
`zinc_gine_s<seed>.json` (with each epoch's record).  The real ZINC
pickles are read from `--data_dir` where they exist (the `.index`
subsets), else the synthetic stand-in.  Batches are packed untiled, as
the JAX trainer packs them, so no kernel runs.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .data import (add_full_evd, choose_budgets, code_columns,
                   iterate_graphbatches, load_zinc, pack_batches)
from .graph import from_arrays
from .models import SignNetGNN
from .spectral import round_eigvals
from .training import (Checkpointer, StepLR, adam, build_steps,
                       count_params, evaluate, load_train_state,
                       make_module_predict, train_state)
from .utils import card_or_cpu


def distinct_eig_stats(graphs) -> float:
    """Share of graphs whose eigenvalues, rounded to 5 decimals, are all
    distinct."""
    distinct = 0
    for g in graphs:
        vals = round_eigvals(np.asarray(g["eigvals"]), 5)
        if len(np.unique(vals)) == len(vals):
            distinct += 1
    return distinct / max(len(graphs), 1)


def run(args, log=print):
    device = card_or_cpu(args.device)
    splits, real = load_zinc(args.data_dir, subset=True,
                             synth_sizes=(args.synth_train, args.synth_eval,
                                          args.synth_eval))
    log(f"dataset: ZINC ({'real' if real else 'synthetic'})")
    for graphs in splits.values():
        add_full_evd(graphs, normalization=None)
    log(f"distinct-eigval fraction (train): "
        f"{distinct_eig_stats(splits['train']):.3f}")

    nb, eb, gcnt = choose_budgets(splits["train"], args.batch_size)
    mk = lambda graphs: [from_arrays(a).to(device) for a in pack_batches(
        graphs, nb, eb, gcnt, shuffle=False, seed=0)]
    val_b = mk(splits["val"])
    test_b = mk(splits["test"])

    model = SignNetGNN(
        n_hid=args.hidden, n_out=1, nl_signnet=args.nl_signnet,
        nl_gnn=args.nl_gnn, nl_rho=1, ignore_eigval=True,
        gnn_type="GINEConv", phi_gnn_type=args.phi_gnn_type, node_vocab=28,
        edge_vocab=4, node_code_dims=code_columns(splits["train"], "node_feat"),
        edge_code_dims=code_columns(splits["train"], "edge_feat"),
        seed=args.seed).to(device)
    log(f"params: {count_params(model)}")
    optimizer = adam(model.parameters(), args.weight_decay)
    train_step, eval_step = build_steps(model, make_module_predict(model),
                                        optimizer)

    sched = StepLR(step_size=args.lr_step, gamma=0.5, lr=args.lr)
    best_val, best_test = float("inf"), float("nan")
    start_epoch = 0
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume and ckpt is not None and ckpt.latest_step() is not None:
        last = ckpt.latest_step()
        state = ckpt.restore(last)
        load_train_state(model, optimizer, state)
        best_val = float(state["best_val"])
        best_test = float(state["best_test"])
        start_epoch = last + 1
        # StepLR is a function of the epoch index: replay it
        for _ in range(start_epoch):
            sched.step()
        log(f"resumed from checkpoint epoch {last} "
            f"(lr {sched.lr:.2e} best_val {best_val:.4f})")
    history = []
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        ms = [train_step(gb, sched.lr) for gb in iterate_graphbatches(
            splits["train"], nb, eb, gcnt, shuffle=True,
            seed=args.seed * 1000 + epoch, prefetch=4, device=device)]
        losses = (torch.stack([m["loss"] for m in ms]).cpu().numpy()
                  if ms else np.zeros(0))
        train_time = time.time() - t0
        train_loss = float(losses.sum()) / max(len(ms), 1)
        sched.step()
        te = time.time()
        val = evaluate(eval_step, val_b)
        eval_steps = val["steps"]
        if val["mae"] < best_val:
            best_val = val["mae"]
            test = evaluate(eval_step, test_b)
            best_test = test["mae"]
            eval_steps += test["steps"]
        rec = dict(epoch=epoch, lr=sched.lr, train_loss=train_loss,
                   val_mae=val["mae"], best_val=best_val,
                   best_test=best_test, time=time.time() - t0,
                   train_time=train_time, train_steps=len(ms),
                   eval_time=time.time() - te, eval_steps=eval_steps)
        history.append(rec)
        if epoch % args.log_every == 0:
            log(f"epoch {epoch} lr {sched.lr:.2e} train {train_loss:.4f} "
                f"val {val['mae']:.4f} best_test {best_test:.4f} "
                f"({rec['time']:.1f}s)")
        if ckpt is not None:
            state = train_state(model, optimizer, sched.lr, epoch)
            state.update(best_val=best_val, best_test=best_test)
            ckpt.save(epoch, state)
    log(f"FINAL: best_val {best_val:.4f} test-at-best-val {best_test:.4f}")
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir,
                               f"zinc_gine_s{args.seed}.json"), "w") as f:
            json.dump(dict(seed=args.seed, best_val=best_val,
                           test_at_best_val=best_test, epochs=args.epochs,
                           device=str(device), history=history), f,
                      indent=2)
    return best_test


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data_dir", default="data/zinc")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=310)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lr_step", type=int, default=300)
    ap.add_argument("--weight_decay", type=float, default=0.0)
    ap.add_argument("--hidden", type=int, default=110)
    ap.add_argument("--nl_signnet", type=int, default=8)
    ap.add_argument("--nl_gnn", type=int, default=6)
    ap.add_argument("--phi_gnn_type", default="MaskedGINConv",
                    choices=["MaskedGINConv", "MaskedGINEConv"])
    ap.add_argument("--synth_train", type=int, default=10000)
    ap.add_argument("--synth_eval", type=int, default=1000)
    ap.add_argument("--log_every", type=int, default=5)
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out_dir", default=None)
    return ap


if __name__ == "__main__":
    run(build_parser().parse_args())
