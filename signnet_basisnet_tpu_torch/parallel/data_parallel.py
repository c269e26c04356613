"""Data-parallel training over a process group.

Port of signnet_basisnet_tpu/parallel/data_parallel.py onto
`torch.distributed`, one process per rank.  Each rank takes a stack of
local microbatches; for each it runs the ordinary forward and backward from
the step's starting BatchNorm statistics, and the gradients, the BN
running statistics, the loss and the MAE are averaged over the
microbatches, then over the ranks with one `all_reduce` per dtype (JAX
`pmean`); one optimizer step follows, the same on every rank.  The BN
statistics are averaged, not copied from rank 0 as DDP's
`broadcast_buffers` would.  Each rank's kernels run as on one device: with
`data.agg_backend pallas_tile` on tiled batches a rank launches K1 (and
K2-K4 for those nets) per microbatch as the single-device step does.

Sign flips and dropout draw from the model's generators, seeded for each
(step seed, rank, microbatch) as the JAX step folds its key by the device
index and then by the microbatch; the bits differ from JAX's.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..nn.dropout import model_rngs
from ..training.metrics import masked_l1
from ..training.optim import set_lr
from ..training.train import _score, _target, l1_graph_loss


def average_over(tensors: Sequence[torch.Tensor],
                 group: Optional[dist.ProcessGroup] = None
                 ) -> List[torch.Tensor]:
    """The mean of each tensor over the group's ranks, in one all_reduce
    per dtype (new tensors, in order)."""
    world = dist.get_world_size(group)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for dtype in {t.dtype for t in tensors}:
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        flat /= world
        for i, part in zip(idx, torch.split(
                flat, [tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def _seed_step_rngs(model: torch.nn.Module, seed: int, rank: int,
                    micro: int, device) -> None:
    """Seed the model's dropout and train-time flip generators from
    (seed, rank, micro); the flips' from a stream of their own, as JAX
    folds 1 into the step key for them."""
    for name, rng in model_rngs(model).items():
        if name == "eval_flip_rng":
            continue
        stream = 1 if name == "flip_rng" else 0
        s = np.random.SeedSequence([seed, rank, micro, stream])
        rng.on(device).manual_seed(int(s.generate_state(1, np.uint64)[0]
                                       >> np.uint64(1)))


def build_dp_steps(model: torch.nn.Module, predict: Callable,
                   optimizer: torch.optim.Optimizer,
                   group: Optional[dist.ProcessGroup] = None,
                   loss_fn: Callable = l1_graph_loss):
    """(train_step(gb_stack, lr, seed) -> metrics, eval_step(gb_stack) ->
    sums) over the ranks of `group` (default: every rank).

    `gb_stack` is this rank's list of microbatches (GraphBatches on its
    device); `seed` the step's seed (JAX: the step's rng key).  The model
    and optimizer are replicated: each rank builds them from the same seed
    and the steps keep them equal.  The eval step runs the net in eval mode
    and sums loss * n, mae * n and n over the microbatches and the ranks.
    """
    group = group or dist.group.WORLD

    def train_step(gb_stack: Sequence, lr: float, seed: int
                   ) -> Dict[str, torch.Tensor]:
        set_lr(optimizer, lr)
        model.train()
        rank = dist.get_rank(group)
        params = list(model.parameters())
        bufs = [b for b in model.buffers() if b.is_floating_point()]
        start = [b.detach().clone() for b in bufs]
        buf_sum = [torch.zeros_like(b) for b in bufs]
        loss_sum = mae_sum = 0.0
        optimizer.zero_grad(set_to_none=True)
        for i, gb in enumerate(gb_stack):
            _seed_step_rngs(model, seed, rank, i, params[0].device)
            with torch.no_grad():
                for b, s in zip(bufs, start):
                    b.copy_(s)
            pred = predict(gb, getattr(model, "flip_rng", None))
            loss = loss_fn(pred, gb)
            loss.backward()    # the grads of the microbatches add up
            score = _score(pred).detach()
            loss_sum = loss_sum + loss.detach()
            mae_sum = mae_sum + masked_l1(score, _target(score, gb),
                                          gb.graph_mask)
            with torch.no_grad():
                for acc, b in zip(buf_sum, bufs):
                    acc += b
        n = len(gb_stack)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        means = average_over([g / n for g in grads] + [b / n for b in buf_sum]
                             + [torch.stack([loss_sum, mae_sum]) / n], group)
        for p, g in zip(params, means):
            p.grad = g
        with torch.no_grad():
            for b, m in zip(bufs, means[len(params):]):
                b.copy_(m)
        optimizer.step()
        loss, mae = means[-1]
        return {"loss": loss, "mae": mae}

    @torch.no_grad()
    def eval_step(gb_stack: Sequence) -> Dict[str, torch.Tensor]:
        model.eval()
        tot = []
        for gb in gb_stack:
            pred = predict(gb, None)
            score = _score(pred)
            n = gb.graph_mask.sum()
            tot.append(torch.stack([loss_fn(pred, gb) * n,
                                    masked_l1(score, _target(score, gb),
                                              gb.graph_mask) * n, n]))
        tot = torch.stack(tot).sum(0)
        dist.all_reduce(tot, group=group)
        return dict(zip(("loss_sum", "mae_sum", "n"), tot))

    return train_step, eval_step
