"""Command-line entry point: ZINC graph regression on one device.

    python -m signnet_basisnet_tpu_torch.train_zinc \
        --config configs/gin_zinc_signinv_gin.json [--device cpu] [key value ...]

Port of the single-device path of signnet_basisnet_tpu/train_zinc.py: PE
preprocessing -> model -> Adam + plateau LR -> epoch loop with val/test eval.
The JAX package's configs are read as they are.  The run is on `cuda` unless
`--device cpu` is given.  The nets are the five ZINC nets, GIN, GatedGCN,
GAT, PNA (its `model.extra` aggregators, scalers and pre/posttrans depths,
`model.towers`, `model.gru`, `model.no_towers`, and the train split's
degree statistics) and Transformer, with the PE paths of the JAX
train_zinc: the fixed-k SignNet (`sign_inv_net gin` or `gat`) and the
masked all-eigenvector one (`masked_gin`, on `data.pe_mode full_evd`), the sign baselines (`lap_method` sign_flip, abs_val,
canonical, canonical_ref), the random-walk PE (`data.pe_mode rwpe`) and
LSPE (`model.use_lspe`, GIN and GatedGCN only, ignored for the other nets
as the JAX train_zinc ignores it) with the Laplacian-eigvec loss
(`model.use_lapeig_loss`, only with LSPE).  The shipped `*_rwpe_lspe`
configs pair `pe_init rand_walk` with `pe_mode lap_pe`, so their nets
embed the Laplacian eigenvectors as their random-walk PE: kept as the JAX
train_zinc runs them.  Under `sign_flip` the eval batches flip too unless
`model.eval_sign_flip` is false.  The aggregation backend is the config's
(`data.agg_backend`): with `pallas_tile` on a tiled batch (`data.tile`)
the GIN layers and the GIN SignNet phi run the tile-local SpMM kernel on
the card and the GatedGCN layers the fused gate kernel (the GatedGCN-LSPE,
GAT and PNA layers and the GAT phi run none: their JAX ops are XLA); with
`pallas_tile` or `tile_dense` the Transformer layers run the fused
attention kernels there.  Their plain versions run only where the tensors
lie on the CPU.  The shipped GatedGCN, PNA and GAT configs but the masked
ones set neither option, nor do the LapPE and LSPE configs: add `data.tile
256 data.agg_backend pallas_tile` (the Transformer's: `data.tile 256
data.agg_backend tile_dense`) to run their kernels.

As in the JAX train_zinc: the real ZINC pickles are read where they exist under
`data.data_dir` (`data.subset` picks the `.index` subsets), else the
synthetic stand-in; `train.checkpoint_dir` saves the train state after
every epoch, keeping the last `train.keep_checkpoints`, and `train.resume`
restarts from the latest one; `model.dropout` and `model.in_feat_dropout`
draw from a generator seeded from `train.seed`, and `train.eval_bn_mode
batch` refuses them; `train.matmul_precision` maps to torch's float32
matmul precision for the run (`MATMUL_PRECISION`).  The steps stay eager
(a captured step is training/train.py: `capture_train_step`).

`model.sign_inv_net transformer` takes the set-transformer phi (over each
graph's nodes padded to `model.max_nodes`); `model.remat true` recomputes
each conv layer's activations in the backward pass (nn/remat.py).

`train.mp N` (N > 1) trains model-parallel as the JAX train_zinc does
(parallel/mp_halo.py: nodes and edges split into N shards, one halo
exchange a layer, parameters replicated), one process a shard:

    torchrun --nproc_per_node N -m signnet_basisnet_tpu_torch.train_zinc \
        --config configs/gin_zinc_signinv_gin.json train.mp N

Every rank packs and partitions the same batches (edge and halo budgets
from every split, with 1.2x edge and 2x halo headroom) and trains on its
shard; rank 0 logs and writes the results and the checkpoints, which
every rank restores.  A shard carries no tile ranges, so no kernel runs
there, as in JAX; `model.use_lapeig_loss` is refused there, as in JAX.

Refused: `train.num_microbatches` > 1, which the JAX train_zinc never
reads (data parallelism runs through parallel.build_dp_steps and
bench_scaling), and `model.full_graph true`, which the JAX train_zinc
cannot run either (it never builds the full graphs; `_refuse_unported`
says why).  The gcn phi raises ValueError in both packages: the JAX one
cannot broadcast its degree column over the [N, 2k, D] stack.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch
import torch.distributed as dist

from .data import (add_full_evd, add_lap_pe, add_rwpe, avg_degree_stats,
                   choose_budgets, iterate_graphbatches, load_zinc,
                   pack_batches)
from .graph import from_arrays
from .graph import segment as seg
from .models import gnn_model
from .parallel import (build_mp_steps, device_arrays_mp, init_distributed,
                       mp_budgets, partition_batch_mp, shard_arrays_mp)
from .training import (Checkpointer, adam, build_steps, count_params, fit,
                       load_config, make_lapeig_loss_fn, make_zinc_predict)
from .utils import RunLogger, card_or_cpu

# train.matmul_precision (the names jax.default_matmul_precision takes, as
# the JAX train_zinc passes them) -> torch.set_float32_matmul_precision: full
# f32; TF32 ("high"); one bf16 pass where a kernel has one (the JAX
# "default" on the TPU), else TF32 ("medium")
MATMUL_PRECISION = {None: "highest", "float32": "highest",
                    "highest": "highest", "tensorfloat32": "high",
                    "high": "high", "bfloat16": "medium",
                    "default": "medium"}


@contextlib.contextmanager
def matmul_precision(name):
    """torch's float32 matmul precision (and cuDNN's TF32 switch) as
    `name` maps in MATMUL_PRECISION while the block runs; the settings
    before it come back afterwards.  Refuses a name with no counterpart."""
    if name not in MATMUL_PRECISION:
        raise NotImplementedError(
            f"train.matmul_precision {name!r} has no torch counterpart "
            f"(known: {sorted(k for k in MATMUL_PRECISION if k)})")
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision(MATMUL_PRECISION[name])
    torch.backends.cudnn.allow_tf32 = MATMUL_PRECISION[name] != "highest"
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def prepare_data(cfg):
    splits, real = load_zinc(cfg.data.data_dir, subset=cfg.data.subset,
                             synthetic_fallback=cfg.data.synthetic_fallback,
                             synth_sizes=(cfg.data.synth_train,
                                          cfg.data.synth_eval,
                                          cfg.data.synth_eval))
    k = cfg.model.pos_enc_dim
    for graphs in splits.values():
        if cfg.data.pe_mode == "lap_pe":
            add_lap_pe(graphs, k)
        elif cfg.data.pe_mode == "full_evd":
            add_full_evd(graphs, normalization=cfg.data.evd_normalization)
        elif cfg.data.pe_mode == "rwpe":
            add_rwpe(graphs, k)
    return splits, real


def _refuse_unported(cfg):
    if cfg.train.num_microbatches > 1:
        raise NotImplementedError(
            "train.num_microbatches: the JAX train_zinc never reads it "
            "(training/config.py:30 declares it and nothing else mentions "
            "it), so it trains one batch a step whatever the value; this "
            "train_zinc adds no path the reference lacks.  Data "
            "parallelism with microbatches runs through "
            "parallel.build_dp_steps (and bench_scaling)")
    if cfg.model.model == "Transformer" and cfg.model.full_graph:
        # TransformerNet(full_graph=True) needs make_full_graph batches
        raise NotImplementedError(
            "model.full_graph: the JAX train_zinc passes full_graph to "
            "the net but never calls data/transforms.py make_full_graph, "
            "so its full-graph attention raises KeyError: 'edge_real' "
            "(JAX train_zinc.py:107-108, models/conv.py:749); this "
            "train_zinc adds no transform the reference lacks.  The "
            "full-graph Transformer runs at module level: TransformerNet(full_graph="
            "True) on batch_np batches of data.transforms.make_full_graph "
            "graphs")
    if cfg.train.eval_bn_mode == "batch" and (
            cfg.model.dropout > 0 or cfg.model.in_feat_dropout > 0):
        # batch-statistics eval runs the forward in training mode, which
        # would draw dropout masks at eval too
        raise ValueError(
            "eval_bn_mode='batch' requires dropout=0 and in_feat_dropout=0 "
            f"(got {cfg.model.dropout}, {cfg.model.in_feat_dropout})")


def uses_lspe(m) -> bool:
    """LSPE is for GIN and GatedGCN (and the Laplacian-eigvec loss only
    with it), as the JAX train_zinc gates them."""
    return m.use_lspe and m.model in ("GIN", "GatedGCN")


def net_params(cfg, train_graphs) -> dict:
    """`gnn_model`'s keyword arguments for `cfg.model`, as the JAX
    train_zinc builds them; PNA's `avg_d_log` comes from `train_graphs`."""
    m = cfg.model
    out = dict(
        hidden_dim=m.hidden_dim, out_dim=m.out_dim, n_layers=m.n_layers,
        readout=m.readout, in_feat_dropout=m.in_feat_dropout,
        dropout=m.dropout, batch_norm=m.batch_norm, residual=m.residual,
        edge_feat=m.edge_feat, pe_init=m.pe_init, lap_method=m.lap_method,
        pos_enc_dim=m.pos_enc_dim, sign_inv_net=m.sign_inv_net,
        sign_inv_layers=m.sign_inv_layers, phi_out_dim=m.phi_out_dim,
        pe_aggregate=m.pe_aggregate, max_nodes=m.max_nodes, remat=m.remat,
        seed=cfg.train.seed)
    if uses_lspe(m):
        out["use_lspe"] = True
    if m.model in ("GAT", "Transformer"):
        out["num_heads"] = m.num_heads
    if m.model == "Transformer":
        out.update(full_graph=m.full_graph, layer_norm=m.layer_norm)
    if m.model == "PNA":
        out.update(avg_d_log=avg_degree_stats(train_graphs)["log"],
                   towers=m.towers, gru=m.gru, no_towers=m.no_towers,
                   **m.extra)
    return out


def run(cfg, device: str = "cuda", log=print):
    """Train and evaluate as the config says; returns the FitResult.  The
    f32 matmul precision is `train.matmul_precision`'s (full f32 unless it
    says otherwise) while the run lasts."""
    _refuse_unported(cfg)
    device = card_or_cpu(device)
    if cfg.train.mp > 1:
        device = _join_mp_world(cfg.train.mp, device)
        if dist.get_rank() != 0:
            log = lambda msg: None
    with matmul_precision(cfg.train.matmul_precision):
        return _run(cfg, device, log)


def _join_mp_world(mp: int, device: torch.device) -> torch.device:
    """This process's rank device in the world of `mp` shards: the
    process group already joined, else torchrun's."""
    if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            f"train.mp {mp} runs one process a shard: torchrun "
            f"--nproc_per_node {mp} -m signnet_basisnet_tpu_torch.train_zinc "
            f"--config ... train.mp {mp}")
    dev = init_distributed(device.type)
    if dist.get_world_size() != mp:
        raise ValueError(f"train.mp {mp} needs a world of {mp} ranks, "
                         f"not {dist.get_world_size()}")
    return dev


def _run(cfg, device, log):
    t0 = time.time()
    splits, real = prepare_data(cfg)
    log(f"dataset: ZINC ({'real' if real else 'synthetic'}) "
        f"train={len(splits['train'])} val={len(splits['val'])} "
        f"test={len(splits['test'])}")
    seg.set_agg_backend(cfg.data.agg_backend)

    tile = cfg.data.tile
    nb, eb, gb_cnt = choose_budgets(splits["train"], cfg.train.batch_size,
                                    slack=cfg.data.batch_slack,
                                    align=cfg.data.batch_align, tile=tile)
    # one K for every batch, full-EVD mode included: pos_enc_dim is the
    # dataset's largest node count there (37 for ZINC)
    k = cfg.model.pos_enc_dim
    make_arrays = lambda graphs, shuffle, seed: pack_batches(
        graphs, nb, eb, gb_cnt, shuffle=shuffle, seed=seed, k=k, tile=tile)
    log(f"batches: {nb} nodes, {eb} edges, {gb_cnt} graph slots"
        + (f", tiles of {tile}" if tile else ""))

    m = cfg.model
    use_lapeig = m.use_lapeig_loss and uses_lspe(m)
    if cfg.train.mp > 1 and use_lapeig:
        raise ValueError("train.mp > 1 does not support use_lapeig_loss")
    model = gnn_model(m.model, **net_params(cfg, splits["train"])).to(device)
    log(f"model: {m.model} params={count_params(model)} device={device}")

    cdtype = (getattr(torch, cfg.train.compute_dtype)
              if cfg.train.compute_dtype else None)
    predict = make_zinc_predict(model, lap_method=m.lap_method,
                                compute_dtype=cdtype, return_p=use_lapeig)
    optimizer = adam(model.parameters(), cfg.train.weight_decay)
    loss = {}
    if use_lapeig:
        loss["loss_fn"] = make_lapeig_loss_fn(m.alpha_loss, m.lambda_loss,
                                              m.pos_enc_dim)
    if cfg.train.mp > 1:
        # model parallel: every rank partitions the same batches and
        # keeps its shard; the budgets cover every split, with headroom
        # for the shuffled epochs and for shifted shard boundaries
        mp, rank = cfg.train.mp, dist.get_rank()
        probe = (make_arrays(splits["val"], False, 0)
                 + make_arrays(splits["test"], False, 0)
                 + make_arrays(splits["train"], True, cfg.train.seed))
        e_sh, H = mp_budgets(probe, mp)
        e_sh = -(-int(e_sh * 1.2) // 8) * 8
        H = -(-int(H * 2) // 8) * 8
        log(f"mp={mp}: edge shard {e_sh}, halo {H} rows/pair "
            f"(vs {nb} nodes — boundary-only exchange)")
        part = lambda arrays: shard_arrays_mp(device_arrays_mp(
            partition_batch_mp(arrays, mp, e_shard=e_sh, halo=H)), rank,
            device)
        val_batches = [part(a) for a in make_arrays(splits["val"], False, 0)]
        test_batches = [part(a)
                        for a in make_arrays(splits["test"], False, 0)]
        train_step, eval_step = build_mp_steps(model, predict, optimizer)
        train_fn = lambda ep: [part(a) for a in make_arrays(
            splits["train"], True, cfg.train.seed + ep)]
    else:
        val_batches, test_batches = (
            [from_arrays(a).to(device) for a in make_arrays(g, False, 0)]
            for g in (splits["val"], splits["test"]))
        train_step, eval_step = build_steps(
            model, predict, optimizer, eval_bn_mode=cfg.train.eval_bn_mode,
            **loss)
        # a background thread packs (and pins) the next batches while the
        # device computes; each is copied to the device without blocking
        train_fn = lambda ep: iterate_graphbatches(
            splits["train"], nb, eb, gb_cnt, shuffle=True,
            seed=cfg.train.seed + ep, k=k, tile=tile, prefetch=4,
            device=device)
    ckpt = None
    if cfg.train.checkpoint_dir:
        ckpt = Checkpointer(cfg.train.checkpoint_dir,
                            cfg.train.keep_checkpoints)
        if cfg.train.mp > 1 and dist.get_rank() != 0:
            # the ranks hold the same state: rank 0 writes it, every rank
            # restores it (before its first step, so before rank 0 can
            # write again)
            ckpt.save = lambda step, state: None

    result = fit(
        train_step, eval_step, train_batches_fn=train_fn,
        val_batches_fn=lambda: val_batches,
        test_batches_fn=lambda: test_batches,
        epochs=cfg.train.epochs, init_lr=cfg.train.init_lr,
        lr_reduce_factor=cfg.train.lr_reduce_factor,
        lr_schedule_patience=cfg.train.lr_schedule_patience,
        min_lr=cfg.train.min_lr, max_time_hours=cfg.train.max_time_hours,
        log_every=cfg.train.print_epoch_interval, logger=log,
        checkpointer=ckpt, resume=cfg.train.resume, model=model,
        optimizer=optimizer,
        eval_flip_rng=(model.eval_flip_rng if m.lap_method == "sign_flip"
                       and m.eval_sign_flip else None))
    log(f"FINAL: test_mae={result.test_mae:.4f} val_mae={result.val_mae:.4f} "
        f"epochs={result.epochs_run} time={(time.time() - t0) / 3600:.2f}h")
    log(f"FINAL_BEST_VAL: test_mae={result.best_val_test_mae:.4f} "
        f"val_mae={result.best_val_mae:.4f}")

    if cfg.out_dir and (cfg.train.mp == 1 or dist.get_rank() == 0):
        os.makedirs(cfg.out_dir, exist_ok=True)
        with open(os.path.join(cfg.out_dir, f"{cfg.name}_results.json"),
                  "w") as f:
            json.dump(dict(test_mae=result.test_mae, val_mae=result.val_mae,
                           best_val_test_mae=result.best_val_test_mae,
                           best_val_mae=result.best_val_mae,
                           epochs=result.epochs_run, device=str(device),
                           config=cfg.to_dict(), history=result.history),
                      f, indent=2)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    # stdout, and with train.log_dir also <log_dir>/<name>.log
    logger = RunLogger(cfg.train.log_dir, cfg.name)
    try:
        run(cfg, device=args.device, log=logger)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
