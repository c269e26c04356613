"""The system under test: the port's ZINC training step, input pipeline and
model, wired as its ZINC trainer (`train_zinc._run`) wires them.  The only
module of the benchmark that imports the program.

- budgets from `data.batcher.choose_budgets` over the training graphs;
- each epoch a fresh `data.batcher.iterate_graphbatches(..., shuffle=True,
  seed=seed + epoch, prefetch=<traffic>, device=<card>)`: the producer
  thread packs the whole epoch, then pins each batch; the loop copies it
  to the card without blocking;
- `models.gnn_model` with `train_zinc.net_params` of the configuration,
  under `training.make_zinc_predict`;
- on the card the step of `training.capture_train_step` with
  `training.adam(..., capturable=True)`; on the CPU, where only the
  benchmark's own tests drive it, the eager step of `training.build_steps`
  (a CUDA graph needs a card).
"""
from __future__ import annotations

from typing import Dict, List

import torch

PROGRAM = "signnet_basisnet_tpu_torch"


def port_config(doc: dict, traffic: dict, seed: int):
    """The program's Config: the configuration file's sections, the
    traffic's batch and the run's seed."""
    from signnet_basisnet_tpu_torch.training.config import load_config
    cfg = load_config()
    for section in ("model", "train", "data"):
        obj = getattr(cfg, section)
        for key, value in doc[section].items():
            if not hasattr(obj, key):
                raise KeyError(f"{section}.{key} is not a setting of "
                               f"{PROGRAM}")
            setattr(obj, key, value)
    cfg.train.batch_size = int(traffic["batch_graphs"])
    cfg.train.seed = seed
    return cfg


class Program:
    def __init__(self, doc: dict, traffic: dict, graphs: List[dict],
                 seed: int, device: torch.device,
                 params: Dict[str, torch.Tensor],
                 buffers: Dict[str, torch.Tensor]):
        from signnet_basisnet_tpu_torch.data import choose_budgets
        from signnet_basisnet_tpu_torch.graph import segment as seg
        from signnet_basisnet_tpu_torch.models import gnn_model
        from signnet_basisnet_tpu_torch.train_zinc import net_params
        from signnet_basisnet_tpu_torch.training import (adam,
                                                         make_zinc_predict)
        cfg = port_config(doc, traffic, seed)
        if cfg.train.compute_dtype or cfg.train.matmul_precision not in (
                None, "float32", "highest"):
            raise NotImplementedError("the benchmark runs f32 steps with "
                                      "TF32 off only")
        self.cfg, self.graphs, self.seed, self.device = (cfg, graphs, seed,
                                                         device)
        self.prefetch = int(traffic["prefetch"])
        seg.set_agg_backend(cfg.data.agg_backend)
        self.slots = choose_budgets(graphs, cfg.train.batch_size,
                                    slack=cfg.data.batch_slack,
                                    align=cfg.data.batch_align,
                                    tile=cfg.data.tile)
        model = gnn_model(cfg.model.model, **net_params(cfg, graphs))
        model = model.to(device)
        _load(model, params, buffers)
        self.model = model
        self.predict = make_zinc_predict(model, cfg.model.lap_method)
        self.opt = adam(model.parameters(), cfg.train.weight_decay,
                        capturable=device.type == "cuda")
        self.lr = cfg.train.init_lr
        self.step = None

    def feed(self, epoch: int):
        from signnet_basisnet_tpu_torch.data import iterate_graphbatches
        c = self.cfg
        return iterate_graphbatches(
            self.graphs, *self.slots, shuffle=True, seed=self.seed + epoch,
            k=c.model.pos_enc_dim, tile=c.data.tile, prefetch=self.prefetch,
            device=self.device)

    def make_step(self, example_batch) -> None:
        from signnet_basisnet_tpu_torch.training import (build_steps,
                                                         capture_train_step)
        if self.device.type == "cuda":
            self.step = capture_train_step(self.model, self.predict,
                                           self.opt, example_batch)
        else:
            self.step = build_steps(self.model, self.predict, self.opt)[0]

    def first_steps(self, batches) -> dict:
        """One step on each of `batches`, through the step the window
        calls: each step's loss, the first gradient of every leaf as Adam
        holds it after one step (its first moment over 1 - beta1), and how
        far every parameter and BatchNorm statistic moved over the steps
        (norms a leaf)."""
        model, opt = self.model, self.opt
        params = dict(model.named_parameters())
        with torch.no_grad():
            p0 = {n: p.detach().clone() for n, p in params.items()}
            b0 = {n: b.clone() for n, b in model.named_buffers()}
        losses = [self.step(batches[0], self.lr)["loss"]]
        beta1 = opt.param_groups[0]["betas"][0]
        with torch.no_grad():
            g1 = {n: (opt.state[p]["exp_avg"] / (1 - beta1)).norm()
                  for n, p in params.items() if p in opt.state}
        losses += [self.step(b, self.lr)["loss"] for b in batches[1:]]
        with torch.no_grad():
            dp = {n: (p - p0[n]).norm() for n, p in params.items()}
            db = {n: (b - b0[n]).norm() for n, b in model.named_buffers()}
        host = lambda d: (dict(zip(d, torch.stack(list(d.values())).tolist()))
                          if d else {})
        return {"losses": torch.stack(losses).tolist(), "grad1": host(g1),
                "params": host(dp), "buffers": host(db)}

    def param_count(self) -> int:
        return sum(p.numel() for p in self.model.parameters())

    def free(self) -> None:
        self.step = self.model = self.opt = self.predict = None


def _load(model, params, buffers) -> None:
    """Copy the run's initial weights into `model` by name; the names and
    shapes must be the reference's."""
    for kind, theirs, mine in (("parameter", params, model.named_parameters()),
                               ("buffer", buffers, model.named_buffers())):
        mine = dict(mine)
        if set(mine) != set(theirs):
            raise ValueError(
                f"{kind}s differ from the reference's: only in the program "
                f"{sorted(set(mine) - set(theirs))[:5]}, only in the "
                f"reference {sorted(set(theirs) - set(mine))[:5]}")
        with torch.no_grad():
            for name, t in mine.items():
                if t.shape != theirs[name].shape:
                    raise ValueError(f"{name}: {tuple(t.shape)} in the "
                                     f"program, {tuple(theirs[name].shape)} "
                                     f"in the reference")
                t.copy_(theirs[name])
