"""Training harness: train/eval steps and the epoch loop.

Port of signnet_basisnet_tpu/training/train.py: `l1_graph_loss`,
`make_zinc_predict` (with `compute_dtype` and `return_p`),
`make_module_predict` (nets called as `model(gb)`: the Alchemy and GINE
nets), `make_lapeig_loss_fn`, `build_steps` (train/eval, `eval_bn_mode`,
a `loss_fn`), `evaluate`, `fit` (with checkpoints and resume,
training/checkpoint.py, the eval-time sign flips and `best_val_test`) and
the k-fold loop (`k_fold_split`, `KFoldResult`, `run_k_fold`).  The model and the
optimizer hold the state that the JAX `TrainState` carries; the LR is a
run-time scalar set before every optimizer step.

Sign flips (lap_method `sign_flip`) draw on the model's device from the
generators the net owns (models/zinc_models.py): every train step from
`model.flip_rng`, as the JAX train step folds a `sign_flip` key out of its
rng; an eval step only when it is given a generator, which `fit` does with
`eval_flip_rng` (the JAX `eval_sign_flip`), one draw per eval batch.

`capture_train_step` is the counterpart of the JAX benchmark's on-device
step loop (`lax.scan` over `train_step`): the whole train step (forward,
backward, Adam) captured once in a CUDA graph and replayed, each replay
after a copy of the next batch into the graph's static batch (as the scan
body indexes its stacked batches) and of the LR into the optimizer's LR
tensor.

Mixed precision follows the JAX package, not `torch.autocast`: with
`compute_dtype` the forward runs on a copy of every parameter cast to that
type and on the batch with every float cast (BatchNorm included), while the
master parameters, the optimizer, the loss and the BN running statistics
stay float32.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models.pe import apply_lap_method
from ..models.zinc_models import lapeig_loss
from ..nn.dropout import Dropout
from ..utils import profiling
from ..utils.profiling import device_memory_stats
from .checkpoint import load_train_state, train_state
from .metrics import masked_l1
from .optim import ReduceLROnPlateau, StepLR, set_lr


def count_params(model: torch.nn.Module) -> int:
    return int(sum(p.numel() for p in model.parameters()))


def _target(pred, gb):
    y = gb.y
    if pred.dim() == 1 and y.dim() == 2:
        y = y[:, 0]
    return y


def l1_graph_loss(pred, gb):
    return masked_l1(pred, _target(pred, gb), gb.graph_mask)


def _score(pred):
    """The [G] scores of a prediction, which may be (scores, p)."""
    return pred[0] if isinstance(pred, tuple) else pred


def make_zinc_predict(model: torch.nn.Module, lap_method: str = "none",
                      compute_dtype: Optional[torch.dtype] = None,
                      return_p: bool = False) -> Callable:
    """predict(gb, flip_rng=None) -> [G] float32 scores, or with
    `return_p` (scores, p) with the LSPE positional channel p in float32:
    PE sign handling, then the net, in `compute_dtype` when given (see the
    module docstring).  Under `sign_flip` the flips are drawn from
    `flip_rng`; without one the signs stay as they are (an eval step
    without eval-time flips)."""
    kwargs = {"return_p": True} if return_p else {}

    def predict(gb, flip_rng=None):
        pos_enc = gb.eigvecs
        if pos_enc is not None and not (lap_method == "sign_flip"
                                        and flip_rng is None):
            pos_enc = apply_lap_method(lap_method, gb, pos_enc, rng=flip_rng)
        if compute_dtype is None:
            return model(gb, pos_enc, **kwargs)
        params = {n: p.to(compute_dtype) for n, p in model.named_parameters()}
        gbc = gb.cast_floats(compute_dtype)
        pe = None if pos_enc is None else pos_enc.to(compute_dtype)
        out = torch.func.functional_call(model, params, (gbc, pe), kwargs)
        if return_p:
            score, p = out
            return score.float(), None if p is None else p.float()
        return out.float()

    return predict


def make_module_predict(model: torch.nn.Module) -> Callable:
    """predict(gb, flip_rng=None) -> model(gb), for nets whose forward
    takes the batch alone (no PE handling, no sign flips)."""

    def predict(gb, flip_rng=None):
        return model(gb)

    return predict


def make_lapeig_loss_fn(alpha: float, lam: float, k: int) -> Callable:
    """loss((scores, p), gb) = L1 + alpha * (tr(p^T L p) + lam *
    sum_g ||P^T P - I||_F^2) / (k * graphs * nodes): the LSPE auxiliary
    loss over the batch's real graphs and nodes."""

    def loss_fn(pred, gb):
        score, p = pred
        tr, ortho = lapeig_loss(gb, p)
        denom = k * gb.graph_mask.sum() * gb.node_mask.sum()
        return (l1_graph_loss(score, gb)
                + alpha * (tr + lam * ortho) / torch.clamp(denom, min=1.0))

    return loss_fn


def build_steps(model: torch.nn.Module, predict: Callable,
                optimizer: torch.optim.Optimizer,
                eval_bn_mode: str = "running",
                loss_fn: Callable = l1_graph_loss):
    """(train_step(gb, lr) -> metrics, eval_step(gb, flip_rng=None) ->
    sums).

    eval_bn_mode: "running" normalises eval batches with the BN running
    statistics (torch `model.eval()`); "batch" with the eval batch's own
    statistics, discarding the running-stat updates.  The loss is
    `loss_fn(pred, gb)`, by default the masked L1 of the ZINC protocol; the
    MAE is the masked L1 of the scores, which the eval step sums apart from
    the loss.  A train step draws its sign flips from `model.flip_rng`
    where the net has one; an eval step from `flip_rng` if given.  Metrics
    stay on the device; `fit`/`evaluate` fetch them once per epoch.

    With `profiling.DEVICE_SPANS` on when the steps are built, a train
    step in every `DeviceSpans.EVERY` records its device spans
    (`_train_body`), and each call first reads such a step's regions into
    `profiling.COUNTERS` once they have arrived (`train_step.spans`, a
    `profiling.DeviceSpans`; None with them off).
    """
    if eval_bn_mode not in ("running", "batch"):
        raise ValueError(eval_bn_mode)

    spans = profiling.DeviceSpans() if profiling.DEVICE_SPANS else None

    def train_step(gb, lr):
        set_lr(optimizer, lr)
        if spans is None:
            return _train_body(model, predict, optimizer, gb, loss_fn)
        spans.sample()
        rec = spans.start(next(model.parameters()).device)
        out = _train_body(model, predict, optimizer, gb, loss_fn, rec)
        if rec is not None:
            spans.finished()
        return out

    @torch.no_grad()
    def eval_step(gb, flip_rng=None):
        if eval_bn_mode == "batch":
            saved = {k: v.clone() for k, v in model.named_buffers()}
            model.train()
            pred = predict(gb, flip_rng)
            for k, v in model.named_buffers():
                v.copy_(saved[k])
        else:
            model.eval()
            pred = predict(gb, flip_rng)
        loss = loss_fn(pred, gb)
        score = _score(pred)
        mae = masked_l1(score, _target(score, gb), gb.graph_mask)
        n = gb.graph_mask.sum()
        return {"loss_sum": loss * n, "mae_sum": mae * n, "n": n}

    train_step.spans = spans
    return train_step, eval_step


def _train_body(model, predict, optimizer, gb, loss_fn=l1_graph_loss,
                spans=None):
    """One train step at the optimizer's current LR: the work a captured
    step replays.  Grads are set to None before the backward, so that
    under capture the backward allocates them in the graph's pool.  With
    `spans` (a `profiling.StepSpans`) the step records its device spans:
    the regions the model marks, `head` closed after the loss, `adam`
    around the optimizer's step, and a stamp at each end of the step."""
    with profiling.recording(spans):
        profiling.stamp("step", True)
        model.train()
        pred = predict(gb, getattr(model, "flip_rng", None))
        loss = profiling.mark("head", False, loss_fn(pred, gb))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        profiling.stamp("adam", True)
        optimizer.step()
        profiling.stamp("adam", False)
        score = _score(pred).detach()
        mae = masked_l1(score, _target(score, gb), gb.graph_mask)
        profiling.stamp("step", False)
    return {"loss": loss.detach(), "mae": mae}


def _step_rngs(model):
    """The generators a train step of `model` draws from: its dropout
    layers' and its sign-flip generator."""
    rngs = {id(m.rng): m.rng for m in model.modules()
            if isinstance(m, Dropout) and m.rate}
    flip = getattr(model, "flip_rng", None)
    if flip is not None:
        rngs[id(flip)] = flip
    return list(rngs.values())


# eager steps run before a capture (the kernels' builds, Adam's state)
CAPTURE_WARMUP = 3


def kernel_launches() -> Dict[str, int]:
    """The kernel wrappers' launch counters, K1-K5 (ops/)."""
    from .. import ops
    attn = ops.edge_softmax_attention_tiled
    return {"K1": ops.spmm_tiled.launches, "K2": attn.launches_fwd,
            "K3": attn.launches_bwd, "K4": ops.gatedgcn_gate_tiled.launches,
            "K5": ops.spmm_flat.launches}


def capture_train_step(model: torch.nn.Module, predict: Callable,
                       optimizer: torch.optim.Optimizer, batch):
    """The train step of `build_steps`, captured in a CUDA graph:
    returns step(gb, lr) -> metrics, which copies `gb` into the graph's
    static batch, fills the optimizer's LR tensor and replays.

    `optimizer` must be `adam(..., capturable=True)` over `model`'s CUDA
    parameters; `batch`, on the card, fixes the padded shapes every later
    batch must have (batches packed to one `choose_budgets`).  The step is
    warmed up eagerly on a side stream `CAPTURE_WARMUP` times, which builds
    the kernels (ops/_nvcc.py) and creates Adam's state, neither of which
    may happen under capture; the model's parameters and buffers, Adam's
    state and the generators the step draws from (dropout's, the sign
    flips') are then put back as they were, so the first replay is the
    first step.  The graph works on the model's own tensors: each replay
    updates the parameters, the BatchNorm running statistics and Adam's
    moments in place, and draws fresh dropout masks and sign flips (the
    model's generators are registered with the graph).  The kernel wrappers'
    launch counters count each capture once and no replay: `step.launches`
    keeps their growth over a capture, K1-K5 a replay launches, and
    `step.replays` counts the calls.  The metrics
    returned are copies of the graph's own output tensors, which the next
    replay overwrites.  `step.model` is the model it trains.  A model
    with `remat` and dropout is refused (NotImplementedError).

    With `profiling.DEVICE_SPANS` on at the capture, the step is captured
    twice: once with its stamps as kernel nodes (the last warm-up step
    makes their buffers), then without them into the same memory pool.
    A call that `step.spans` (a `profiling.DeviceSpans`) picks, one in
    `DeviceSpans.EVERY`, replays the first graph and copies its stamps
    out; the others replay the second, so they pay nothing for the spans.
    Each call first reads such a replay's stamps into `profiling.COUNTERS`
    once they have arrived.  The two graphs never run at once and each
    writes its outputs before the step copies them, so sharing the pool
    is safe; a parameter's `.grad` is the second graph's.
    """
    if getattr(model, "remat", False) and any(
            isinstance(m, Dropout) and m.rate for m in model.modules()):
        raise NotImplementedError(
            "capture_train_step of a remat'd model with dropout: the "
            "recompute must read and set the dropout generator's state "
            "(nn/remat.py), which a CUDA graph capture cannot do; run the "
            "eager step (build_steps)")
    dev = batch.senders.device
    if dev.type != "cuda":
        raise RuntimeError("capture_train_step needs a batch on the card")
    if not all(g.get("capturable") and isinstance(g["lr"], torch.Tensor)
               for g in optimizer.param_groups):
        raise ValueError("capture_train_step needs adam(..., "
                         "capturable=True): an LR tensor on the card")
    static = batch._map(torch.clone)
    tensors = list(model.parameters()) + list(model.buffers())
    with torch.no_grad():
        saved = [t.detach().clone() for t in tensors]
        saved_opt = {p: {k: v.clone() for k, v in st.items()
                         if isinstance(v, torch.Tensor)}
                     for p, st in optimizer.state.items()}
    rngs = _step_rngs(model)
    saved_rngs = [None if r.generator is None else r.generator.get_state()
                  for r in rngs]
    spans = profiling.DeviceSpans(dev) if profiling.DEVICE_SPANS else None
    rec = None if spans is None else spans.recorder
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for i in range(CAPTURE_WARMUP):
            _train_body(model, predict, optimizer, static,
                        spans=rec if i == CAPTURE_WARMUP - 1 else None)
    torch.cuda.current_stream(dev).wait_stream(side)
    with torch.no_grad():
        for t, v in zip(tensors, saved):
            t.copy_(v)
        for p, st in optimizer.state.items():
            for k, v in st.items():
                if isinstance(v, torch.Tensor):
                    if p in saved_opt:
                        v.copy_(saved_opt[p][k])
                    else:  # a fresh Adam: step 0, zero moments
                        v.zero_()
    gens = []
    for r, st in zip(rngs, saved_rngs):
        gen = r.on(dev)  # made by the warm-up if it was not there
        if st is None:
            gen.manual_seed(r.seed)
        else:
            gen.set_state(st)
        gens.append(gen)

    def capture(recorder, pool=None):
        graph = torch.cuda.CUDAGraph()
        for gen in gens:
            graph.register_generator_state(gen)
        optimizer.zero_grad(set_to_none=True)
        with torch.cuda.graph(graph, pool=pool):
            outputs = _train_body(model, predict, optimizer, static,
                                  spans=recorder)
        return graph, outputs

    stamped = None if spans is None else capture(rec)
    launches = kernel_launches()
    plain = capture(None, None if stamped is None else stamped[0].pool())
    launches = {k: v - launches[k] for k, v in kernel_launches().items()}
    return _CapturedStep(model, optimizer, static, plain, stamped, spans,
                         launches)


class _CapturedStep:
    """The step `capture_train_step` returns: step(gb, lr) -> metrics, and
    `model`, `launches`, `replays`, `spans`.  An object rather than a
    closure, so that no reference cycle keeps its graphs and their memory
    pool alive once the caller drops it."""

    def __init__(self, model, optimizer, static, plain, stamped, spans,
                 launches):
        self.model, self.spans, self.launches = model, spans, launches
        self.replays = 0
        self._optimizer, self._static = optimizer, static
        self._plain, self._stamped = plain, stamped

    def __call__(self, gb, lr):
        due = False
        if self.spans is not None:
            self.spans.sample()
            due = self.spans.due()
        if gb is not self._static:
            self._static.copy_(gb, non_blocking=True)
        set_lr(self._optimizer, lr)
        graph, outputs = self._stamped if due else self._plain
        graph.replay()
        self.replays += 1
        if due:
            self.spans.finished()
        return {k: v.clone() for k, v in outputs.items()}


@dataclass
class FitResult:
    history: list
    test_mae: float
    val_mae: float
    epochs_run: int
    wall_time: float
    best_val_mae: float = float("nan")
    best_val_test_mae: float = float("nan")
    train_steps: int = 0
    eval_steps: int = 0
    eval_flip_draws: int = 0


def evaluate(eval_step, batches, flip_rng=None) -> Dict[str, float]:
    """Mean loss/MAE over `batches`, fetched from the device once; with
    `flip_rng` each batch draws its own sign flips from it."""
    outs = [eval_step(gb, flip_rng) for gb in batches]
    tot = {"loss_sum": 0.0, "mae_sum": 0.0, "n": 0.0}
    if outs:
        stacked = {k: torch.stack([o[k].float() for o in outs]).sum().item()
                   for k in tot}
        tot.update(stacked)
    n = max(tot["n"], 1.0)
    return {"loss": tot["loss_sum"] / n, "mae": tot["mae_sum"] / n,
            "steps": len(outs)}


def _peak_mem_mb() -> Optional[float]:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return device_memory_stats("cuda")["peak_mb_in_use"]
    return None


def fit(train_step, eval_step, train_batches_fn, val_batches_fn,
        test_batches_fn=None, *, epochs=1000, init_lr=1e-3,
        lr_reduce_factor=0.5, lr_schedule_patience=25, min_lr=1e-6,
        max_time_hours=12.0, log_every=5, logger=None, checkpointer=None,
        resume: bool = False, model=None, optimizer=None,
        eval_flip_rng=None, best_val_test: bool = False) -> FitResult:
    """Epoch loop with plateau LR, min-lr stop, wall-clock budget and a
    graceful KeyboardInterrupt: the JAX `fit`.  The best epoch is the one
    of least val loss; its val MAE is reported (they differ under an
    auxiliary loss).

    `test_mae` is the final model's test MAE (the ZINC protocol), or with
    `best_val_test` the test MAE at the best-val epoch (the Alchemy
    protocol); `best_val_test_mae` is that one either way.

    With `eval_flip_rng` (the JAX `eval_sign_flip`) every val and test
    batch draws its own sign flips from that generator; `eval_flip_draws`
    counts them.

    With a `checkpointer` (training/checkpoint.py) the train state of
    `model` and `optimizer` (parameters, BatchNorm statistics, Adam's
    state, the LR for the next epoch, the net's generators) is saved
    after every epoch; with `resume` the latest one is restored first and
    the loop starts at the epoch after it, at the restored LR, as the JAX
    `fit` resumes.

    Every `log_every` epochs the log line adds what the program's
    counters saw (`profiling.counters_line`): where the epoch's batches
    came from `iterate_graphbatches`, its first-batch, plan and median
    pack times, its wait in `get()` and the queue's median depth there;
    and the last step sample's region shares.

    Each history record also holds `train_time` (seconds from the epoch's
    start to its last train metric on the host) and `train_steps`, and
    `eval_time` and `eval_steps`: the epoch's val (and test) evaluation,
    its seconds to the metrics on the host.
    """
    sched = ReduceLROnPlateau(factor=lr_reduce_factor,
                              patience=lr_schedule_patience,
                              min_lr=min_lr, lr=init_lr)
    history = []
    t0 = time.time()
    epochs_run = 0
    train_steps = eval_steps = 0
    best_val = float("inf")
    best_val_mae = float("nan")
    best_test = float("nan")
    log = logger or (lambda msg: print(msg, flush=True))
    if checkpointer is not None and (model is None or optimizer is None):
        raise ValueError("checkpoints need the model and the optimizer")
    start_epoch = 0
    if resume and checkpointer is not None:
        last = checkpointer.latest_step()
        if last is not None:
            sched.lr = load_train_state(model, optimizer,
                                        checkpointer.restore(last))
            start_epoch = last + 1
            log(f"resumed from checkpoint epoch {last} (lr {sched.lr:.2e})")

    draws0 = 0 if eval_flip_rng is None else eval_flip_rng.draws
    # the eval steps and their seconds (to the metrics on the host) since
    # the epoch began
    ev = {"steps": 0, "time": 0.0}

    def run_eval(batches):
        nonlocal eval_steps
        t = time.time()
        out = evaluate(eval_step, batches, eval_flip_rng)
        eval_steps += out["steps"]
        ev["steps"] += out["steps"]
        ev["time"] += time.time() - t
        return out

    try:
        for epoch in range(start_epoch, epochs):
            te0 = time.time()
            ev.update(steps=0, time=0.0)
            feed = profiling.COUNTERS.newest_feed
            ms = [train_step(gb, sched.lr) for gb in train_batches_fn(epoch)]
            # the epoch's feed iterator, where its batches came from one
            feed = (profiling.COUNTERS.newest_feed
                    if profiling.COUNTERS.newest_feed != feed else None)
            nb = len(ms)
            train_steps += nb
            losses = (torch.stack([torch.stack([m["loss"], m["mae"]])
                                   for m in ms]).cpu().numpy()
                      if ms else np.zeros((0, 2)))
            train_time = time.time() - te0
            train_loss = float(losses[:, 0].sum()) / max(nb, 1)
            train_mae = float(losses[:, 1].sum()) / max(nb, 1)
            if not np.isfinite(train_loss):
                log(f"ABORT: non-finite train loss at epoch {epoch}; stopping")
                break
            val = run_eval(val_batches_fn())
            if val["loss"] <= best_val:
                best_val = val["loss"]
                best_val_mae = val["mae"]
                if test_batches_fn is not None:
                    best_test = run_eval(test_batches_fn())["mae"]
            lr_now = sched.step(val["loss"])
            epochs_run = epoch + 1
            rec = dict(epoch=epoch, lr=lr_now, train_loss=train_loss,
                       train_mae=train_mae, val_loss=val["loss"],
                       val_mae=val["mae"], time=time.time() - te0,
                       train_time=train_time, train_steps=nb,
                       eval_time=ev["time"], eval_steps=ev["steps"])
            history.append(rec)
            if epoch % log_every == 0:
                mem = _peak_mem_mb()
                mem_s = f" peak_mem {mem:.0f}MB" if mem is not None else ""
                seen = profiling.counters_line(feed)
                log(f"epoch {epoch:4d} lr {lr_now:.2e} "
                    f"train_mae {train_mae:.4f} val_mae {val['mae']:.4f} "
                    f"({rec['time']:.1f}s){mem_s}"
                    + (f" | {seen}" if seen else ""))
            if checkpointer is not None:
                checkpointer.save(epoch, train_state(model, optimizer,
                                                     sched.lr, epoch))
            if sched.converged:
                log("converged: lr <= min_lr")
                break
            if (time.time() - t0) > max_time_hours * 3600:
                log("stopping: max_time reached")
                break
    except KeyboardInterrupt:
        log("interrupted: finishing with final eval")

    val = run_eval(val_batches_fn())
    test = (run_eval(test_batches_fn()) if test_batches_fn
            else {"mae": float("nan")})
    test_mae = best_test if best_val_test else test["mae"]
    return FitResult(history=history, test_mae=test_mae, val_mae=val["mae"],
                     epochs_run=epochs_run, wall_time=time.time() - t0,
                     best_val_mae=best_val_mae, best_val_test_mae=best_test,
                     train_steps=train_steps, eval_steps=eval_steps,
                     eval_flip_draws=(0 if eval_flip_rng is None
                                      else eval_flip_rng.draws - draws0))


# --------------------------------------------------------------- k-fold

def k_fold_split(n: int, k: int = 10, seed: int = 0):
    """Shuffled k-fold index split: a list of (train_idx, test_idx)."""
    rng = np.random.default_rng(seed)
    folds = np.array_split(rng.permutation(n), k)
    return [(np.concatenate([folds[j] for j in range(k) if j != i]),
             folds[i]) for i in range(k)]


@dataclass
class KFoldResult:
    fold_best: list          # best metric per fold
    mean: float
    std: float
    curve_mean: float        # metric at the best epoch of the averaged curve
    curve_std: float
    best_epoch: int


def run_k_fold(graphs, make_steps, make_batches, *, k=10, epochs=100,
               init_lr=1e-3, lr_decay=0.5, lr_patience=50, seed=0,
               higher_is_better=False, logger=None) -> KFoldResult:
    """k-fold cross-validation: for each fold, `make_steps(fold)` ->
    (train_step, eval_step) on a fresh model (`build_steps`' steps),
    `make_batches(graph_subset, shuffle_seed_or_None)` -> batches; StepLR
    (`lr_patience` epochs, `lr_decay`) from `init_lr`; the test MAE after
    every epoch.  Reports both aggregations of the JAX loop: the mean of
    the per-fold best metrics, and the best epoch of the fold-averaged
    curve."""
    log = logger or (lambda msg: print(msg, flush=True))
    curves, fold_best = [], []
    sign = 1.0 if higher_is_better else -1.0
    for fold, (tr_idx, te_idx) in enumerate(k_fold_split(len(graphs), k,
                                                         seed)):
        train_graphs = [graphs[i] for i in tr_idx]
        test_graphs = [graphs[i] for i in te_idx]
        train_step, eval_step = make_steps(fold)
        sched = StepLR(step_size=lr_patience, gamma=lr_decay, lr=init_lr)
        curve, best = [], -np.inf
        for epoch in range(epochs):
            for gb in make_batches(train_graphs, epoch):
                train_step(gb, sched.lr)
            sched.step()
            perf = evaluate(eval_step, make_batches(test_graphs, None))["mae"]
            curve.append(perf)
            best = max(best, sign * perf)
        fold_best.append(sign * best)
        curves.append(curve)
        log(f"fold {fold}: best {sign * best:.4f}")
    curves = np.asarray(curves)            # [k, epochs]
    avg = curves.mean(axis=0)
    best_idx = int((sign * avg).argmax())
    fb = np.asarray(fold_best)
    return KFoldResult(fold_best=list(map(float, fb)),
                       mean=float(fb.mean()), std=float(fb.std()),
                       curve_mean=float(avg[best_idx]),
                       curve_std=float(curves.std(axis=0)[best_idx]),
                       best_epoch=best_idx)
