"""Command-line entry point: spectral-filter regression on the 2D grid (the
LearningFilters workload).

    python -m signnet_basisnet_tpu_torch.train_filters [--device cpu] \
        --filter_type band --net DS --use_eig --lap_method sign_inv \
        --img_num 3

Port of signnet_basisnet_tpu/train_filters.py, with its arguments and
`--device` (`cuda` unless `cpu` is given; without a card it raises).  Each
image gets a fresh model (seeded `seed * 100003 + img`, its sign flips
from `+ 2`), trained full-batch with Adam on the masked sum of squared
errors; the best loss and the r2 at that epoch are kept per image, and
their means and spread are logged and appended as one CSV row to
`<results_dir>/<filter_type>_<img_num>.csv` (`--results_dir ""` writes
none; the default is `out/filters`, not the JAX train_filters' tracked
`results`).

The eigen-features (`--use_eig`) follow `--lap_method`: `none`, `abs_val`
and `sign_flip` concatenate the (first `--k`) eigenvectors, as they are,
in absolute value or with a random sign per column drawn each training
step, and their eigenvalues; `sign_inv` a SignNet PE (`SignInvPE`: phi by
DeepSets, MLP or Transformer through `SignPlus`, a DeepSets rho); and
`basis_inv` a BasisNet PE (`BasisInvPE`: one IGN per eigenvalue
multiplicity over the stacked eigenspace projectors, or the shared IGN,
then a DeepSets rho).  flax infers input widths; the port computes them:
the base net takes 1 + 2k features, or 1 + 32 with a PE; the BasisNet rho
the sum of S_m * m over the multiplicities, plus k.

The JAX train_filters runs `--scan_epochs` steps in one `lax.scan` and keeps the
best (loss, r2) in the carry; the port runs as many eager steps between
host reads, tracking the best on the device with `torch.where`, and reads
it only where the JAX train_filters logs (every 500 epochs and at the end).
`--vmap_images V` trains V images' models at once (`stacked_trainer`:
`torch.func.vmap` over `functional_call` with the parameters and buffers
stacked, one Adam over them, the sum of the per-image losses
backpropagated); each image's model and sign flips are the serial run's.
`--matmul_precision` sets torch's float32 matmul precision for the run
(`train_zinc.py: MATMUL_PRECISION`); without it torch's default (full
float32) holds, where the JAX train_filters on a TPU ran bf16 passes.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch import nn

from .data import filter_labels, load_twodgrid
from .graph import batch_np, from_arrays
from .models import (FILTER_MODEL_REGISTRY, IGNBasisInv, IGNShared, SignPlus,
                     basis_features)
from .models.spectral_filters import TransformerNet
from .nn.deepsets import EqDeepSetsEncoder
from .nn.dropout import DropoutRNG
from .nn.init import init_parameters
from .nn.mlp import MLP as MLPBlock
from .spectral import (eigenspace_layout, projectors_by_multiplicity,
                       prop_higher_mult)
from .train_zinc import matmul_precision
from .training import adam, count_params, set_lr
from .training import metrics as M
from .utils import card_or_cpu

PE_DIM = 32
LAP_METHODS = ("none", "abs_val", "sign_flip", "sign_inv", "basis_inv")


class _TransformerInner(nn.Module):
    """The Transformer phi: TransformerNet(32, out 1, 2 layers) on [k, n, 1]
    (attention over the nodes of each eigenvector)."""

    def __init__(self):
        super().__init__()
        self.t = TransformerNet(1, hidden=32, out=1, num_layers=2)

    def forward(self, x):
        return self.t(None, x)


class SignInvPE(nn.Module):
    """phi(v) + phi(-v) per eigenvector, then a DeepSets rho over
    [phi outputs | eigenvalues] -> [n, pe_dim]."""

    def __init__(self, k: int, sign_inv_net: str = "DS",
                 pe_dim: int = PE_DIM, num_layers: int = 2):
        super().__init__()
        if sign_inv_net == "DS":
            phi = EqDeepSetsEncoder(1, hidden=32, out=1, num_layers=3,
                                    use_bn=True)
        elif sign_inv_net == "MLP":
            phi = MLPBlock(1, 32, 1, num_layers, use_bn=True,
                           bn_track_running_stats=False)
        elif sign_inv_net == "Transformer":
            phi = _TransformerInner()
        else:
            raise ValueError(sign_inv_net)
        self.phi = phi                    # the flax names: pe.phi.*
        self.signplus = SignPlus(phi)
        self.rho = EqDeepSetsEncoder(2 * k, hidden=10, out=pe_dim,
                                     num_layers=3, use_bn=True)

    def forward(self, eigvecs, eigvals):
        n, k = eigvecs.shape
        feats = self.signplus(eigvecs.T[..., None])          # k n 1
        feats = feats.transpose(0, 1).reshape(n, -1)         # n k
        lam = eigvals[None, :].expand(n, k)
        return self.rho(torch.cat([feats, lam], dim=-1))


class BasisInvPE(nn.Module):
    """An IGN per multiplicity bucket (or the shared IGN), the BasisNet
    features, then a DeepSets rho over [features | eigenvalues]; the rho
    takes `basis_width` (the sum of S_m * m) + k features."""

    def __init__(self, mult_list, basis_width: int, k: int,
                 pe_dim: int = PE_DIM, shared: bool = False,
                 ign_hidden: int = 32):
        super().__init__()
        self.ign = (IGNShared(mult_list, hidden=min(ign_hidden, 16))
                    if shared else IGNBasisInv(mult_list, hidden=ign_hidden))
        self.rho = EqDeepSetsEncoder(basis_width + k, hidden=10, out=pe_dim,
                                     num_layers=3, use_bn=True)

    def forward(self, projs, eigvals, n: int):
        feats = basis_features(self.ign(projs), n)
        lam = eigvals[None, :].expand(n, eigvals.shape[0])
        return self.rho(torch.cat([feats, lam], dim=-1))


class FilterModel(nn.Module):
    """The base node-regression net `net` on the image and, with
    `use_eig`, the eigen-features of `lap_method`.  Parameters drawn from
    a generator seeded `seed`; sign flips from `flip_rng` (seed + 2).
    `spaces_per_mult` ({m: S_m}, from the eigenspace layout) sizes the
    BasisNet rho."""

    def __init__(self, net: str = "DS", hidden: int = 32,
                 num_layers: int = 2, use_eig: bool = False,
                 lap_method: str = "none", sign_inv_net: str = "DS",
                 basis_inv_net: str = "IGN", mult_list=(), k: int = 0,
                 ign_hidden: int = 32, spaces_per_mult=None,
                 seed: int = 0):
        super().__init__()
        if use_eig and lap_method not in LAP_METHODS:
            raise ValueError(lap_method)
        self.use_eig, self.lap_method = use_eig, lap_method
        d = 1                               # the image's one channel
        if use_eig and lap_method in ("none", "abs_val", "sign_flip"):
            d += 2 * k
        elif use_eig and lap_method == "sign_inv":
            self.pe = SignInvPE(k, sign_inv_net)
            d += PE_DIM
        elif use_eig and lap_method == "basis_inv":
            width = sum(m * s for m, s in (spaces_per_mult or {}).items())
            self.pe = BasisInvPE(mult_list, width, k,
                                 shared=basis_inv_net == "IGNShared",
                                 ign_hidden=ign_hidden)
            d += PE_DIM
        self.base = FILTER_MODEL_REGISTRY[net](d, hidden=hidden,
                                               num_layers=num_layers)
        self.flip_rng = DropoutRNG(seed + 2)
        init_parameters(self, torch.Generator().manual_seed(seed))

    def draw_flips(self, k: int, device) -> torch.Tensor:
        """A random +-1 per eigenvector column from `flip_rng`."""
        u = torch.rand(k, device=device, generator=self.flip_rng.on(device))
        return torch.where(u >= 0.5, 1.0, -1.0)

    def forward(self, gb, x, eigvecs=None, eigvals=None, projs=None,
                flips=None):
        """`flips` (sign_flip, training): the columns' signs, drawn here
        from `flip_rng` when not given."""
        if self.use_eig:
            n = x.shape[0]
            lam = None if eigvals is None else eigvals[None, :].expand(
                n, eigvals.shape[0])
            if self.lap_method == "none":
                x = torch.cat([x, eigvecs, lam], dim=-1)
            elif self.lap_method == "abs_val":
                x = torch.cat([x, eigvecs.abs(), lam], dim=-1)
            elif self.lap_method == "sign_flip":
                v = eigvecs
                if self.training:
                    if flips is None:
                        flips = self.draw_flips(v.shape[1], v.device)
                    v = v * flips.to(v.dtype)
                x = torch.cat([x, v, lam], dim=-1)
            elif self.lap_method == "sign_inv":
                x = torch.cat([x, self.pe(eigvecs, eigvals)], dim=-1)
            else:
                x = torch.cat([x, self.pe(projs, eigvals, n)], dim=-1)
        return self.base(gb, x)


def _rotate_within_eigenspaces(V, w, rot_seed: int):
    """A random orthogonal rotation inside every repeated eigenspace: the
    basis of a repeated eigenvalue is arbitrary (96.9 % of the 2D grid's
    eigenvectors lie in repeated spaces), so this re-draws it without
    changing the spectral content."""
    V = np.asarray(V, np.float64).copy()
    rng = np.random.default_rng(rot_seed)
    uniq, inv = np.unique(np.round(np.asarray(w), 5), return_inverse=True)
    for gi in range(len(uniq)):
        cols = np.where(inv == gi)[0]
        if len(cols) > 1:
            Q, _ = np.linalg.qr(rng.normal(size=(len(cols), len(cols))))
            V[:, cols] = V[:, cols] @ Q
    return V.astype(np.float32)


def run(args, log=print):
    blk = max(1, min(args.scan_epochs, args.epochs))
    if args.epochs % blk != 0:
        # the epoch loop always runs whole blocks; a count that does not
        # divide would train up to blk - 1 extra epochs
        raise ValueError(f"--epochs ({args.epochs}) must be a multiple of "
                         f"--scan_epochs ({blk})")
    device = card_or_cpu(args.device)
    ctx = (matmul_precision(args.matmul_precision) if args.matmul_precision
           else contextlib.nullcontext())
    with ctx:
        return _run(args, log, device)


def prepare(args, log, device, dtype=torch.float32) -> SimpleNamespace:
    """The run's data on `device` and its model factory: the grid `gb`,
    the images `x` and labels `y` [n, images], the `mask` [n, 1], the
    model's eigen inputs `kwargs`, the image ids and `make_model(seed)`;
    floats in `dtype` (float32 for a run, float64 for checks)."""
    data = load_twodgrid(args.mat_path)
    n = data["n"]
    if args.basis_rot_seed >= 0:
        data = dict(data)
        data["eigvecs"] = _rotate_within_eigenspaces(
            data["eigvecs"], data["eigvals"], args.basis_rot_seed)
        log(f"eigvec basis re-drawn within eigenspaces "
            f"(rot_seed {args.basis_rot_seed})")
    y = filter_labels(data, args.filter_type, cache_dir=args.label_dir)
    gb = from_arrays(batch_np(
        [dict(senders=data["senders"], receivers=data["receivers"],
              node_feat=np.zeros((n, 1), np.float32))],
        num_nodes=n, num_edges=len(data["senders"]), num_graphs=2))
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device,
                                                                  dtype)
    vecs = data["eigvecs"][:, :args.k] if args.k else data["eigvecs"]
    k = vecs.shape[1]
    kwargs = dict(eigvecs=put(vecs), eigvals=put(data["eigvals"][:k]),
                  projs=None)
    mult_list, spaces = (), None
    if args.lap_method == "basis_inv":
        layout = eigenspace_layout(data["eigvals"])
        log(f"prop vecs in higher mult: {prop_higher_mult(layout, n):.4f}; "
            f"num eigenspaces: {layout.num_spaces}")
        kwargs["projs"] = {m: put(P[:, None]) for m, P in
                           projectors_by_multiplicity(data["eigvecs"],
                                                      layout).items()}
        mult_list, spaces = tuple(layout.uniq_mults), layout.spaces_per_mult

    def make_model(seed):
        return FilterModel(
            net=args.net, hidden=args.hidden_channels,
            num_layers=args.num_layers, use_eig=args.use_eig,
            lap_method=args.lap_method, sign_inv_net=args.sign_inv_net,
            basis_inv_net=args.basis_inv_net, mult_list=mult_list, k=k,
            ign_hidden=args.ign_hidden, spaces_per_mult=spaces,
            seed=seed).to(device, dtype).train()

    return SimpleNamespace(
        gb=gb.to(device).cast_floats(dtype), x=put(data["x"]), y=put(y),
        mask=put(data["mask"][:, None]), kwargs=kwargs,
        make_model=make_model,
        img_ids=([int(s) for s in args.img_ids.split(",")] if args.img_ids
                 else list(range(args.img_num))))


def train_step(model, opt, gb, x, y, mask, kwargs):
    """One full-batch Adam step on the masked sum of squared errors: the
    loss and r2 of the prediction before it, left on the device."""
    opt.zero_grad(set_to_none=True)
    pred = model(gb, x, **kwargs)
    loss = M.masked_mse_sum(pred, y, mask)
    loss.backward()
    opt.step()
    return loss.detach(), M.masked_r2(pred.detach(), y, mask)


def _run(args, log, device):
    p = prepare(args, log, device)
    blk = max(1, min(args.scan_epochs, args.epochs))
    if max(1, args.vmap_images) > 1:
        return _run_vmapped(args, log, p, blk)

    results = []
    for img in p.img_ids:
        x, y = p.x[:, img:img + 1], p.y[:, img:img + 1]
        model = p.make_model(args.seed * 100003 + img)
        opt = adam(model.parameters())
        set_lr(opt, args.lr)
        if img == p.img_ids[0]:
            log(f"PARAMETERS: {count_params(model)}")
        t0 = time.time()
        best_loss = torch.full((), float("inf"), device=device)
        best_r2 = torch.zeros((), device=device)
        done = 0
        while done < args.epochs:
            for _ in range(blk):
                loss, r2 = train_step(model, opt, p.gb, x, y, p.mask,
                                      p.kwargs)
                # the r2 at the min-loss epoch, not the highest r2 seen
                better = loss < best_loss
                best_r2 = torch.where(better, r2, best_r2)
                best_loss = torch.where(better, loss, best_loss)
            done += blk
            if done % 500 < blk or done >= args.epochs:
                log(f"img {img} epoch {done} min_loss {float(best_loss):.6f} "
                    f"best_r2 {float(best_r2):.4f} ({time.time() - t0:.1f}s)")
                t0 = time.time()
        best_loss, best_r2 = float(best_loss), float(best_r2)
        results.append([best_loss, best_r2])
        log(f"img {img + 1}: loss={best_loss:.6f} r2={best_r2:.4f}")
    return _report(args, results, log)


def _report(args, results, log):
    arr = np.array(results)
    log(f"mean loss= {arr[:, 0].mean():.8f} stdev= {arr[:, 0].std():.8f} "
        f"mean r2= {arr[:, 1].mean():.6f}")
    if args.results_dir:
        os.makedirs(args.results_dir, exist_ok=True)
        p = os.path.join(args.results_dir,
                         f"{args.filter_type}_{args.img_num}.csv")
        with open(p, "a") as f:
            f.write(f"{args.net},{arr[:, 0].mean():.8f},{arr[:, 0].std():.8f},"
                    f"{args.use_eig},{args.lap_method},{args.hidden_channels},"
                    f"{args.num_layers}\n")
    return arr


def stacked_trainer(models, p, lr):
    """Train `models` (one per image, of one net, on the data of `p`) at
    once: their parameters and buffers stacked [V, ...] (IGN's BatchNorm
    updates its stacked running buffers), one Adam over the stacked
    tensors (Adam is elementwise), and a step that vmaps `functional_call`
    over them and backpropagates the sum of the per-image losses.  Each
    image's sign flips come from its own model's generator, as in the
    serial run, drawn outside the vmapped step.  Returns step(xs, ys) ->
    the per-image (loss, r2) before the step, and the stacked
    parameters."""
    from torch.func import functional_call, stack_module_state, vmap
    params, buffers = stack_module_state(models)
    opt = adam(params.values())
    set_lr(opt, lr)
    model = models[0]   # the module the stacked state runs in
    k = p.kwargs["eigvecs"].shape[1]
    flip = model.use_eig and model.lap_method == "sign_flip"

    def one(params, buffers, x, y, *flips):
        pred = functional_call(model, (params, buffers), (p.gb, x), dict(
            p.kwargs, flips=flips[0] if flips else None))
        return (M.masked_mse_sum(pred, y, p.mask),
                M.masked_r2(pred.detach(), y, p.mask))

    vstep = vmap(one)

    def step(xs, ys):
        opt.zero_grad(set_to_none=True)
        draws = ((torch.stack([m.draw_flips(k, xs.device) for m in models]),)
                 if flip else ())
        loss, r2 = vstep(params, buffers, xs, ys, *draws)
        loss.sum().backward()
        opt.step()
        return loss.detach(), r2

    return step, params


def _run_vmapped(args, log, p, blk):
    """Image-parallel training: chunks of `--vmap_images` images, each
    image's model made from its own seed as in the serial run, trained at
    once by `stacked_trainer`."""
    vm = args.vmap_images
    results = {}
    for c0 in range(0, len(p.img_ids), vm):
        chunk = p.img_ids[c0:c0 + vm]
        models = [p.make_model(args.seed * 100003 + img) for img in chunk]
        if c0 == 0:
            log(f"PARAMETERS: {count_params(models[0])} "
                f"(x{vm} image-parallel models)")
        step, _ = stacked_trainer(models, p, args.lr)
        xs = torch.stack([p.x[:, i:i + 1] for i in chunk])
        ys = torch.stack([p.y[:, i:i + 1] for i in chunk])
        t0 = time.time()
        best_loss = torch.full((len(chunk),), float("inf"), device=xs.device)
        best_r2 = torch.zeros((len(chunk),), device=xs.device)
        done = 0
        while done < args.epochs:
            for _ in range(blk):
                loss, r2 = step(xs, ys)
                better = loss < best_loss
                best_r2 = torch.where(better, r2, best_r2)
                best_loss = torch.where(better, loss, best_loss)
            done += blk
            if done % 1000 < blk or done >= args.epochs:
                bl = best_loss.cpu().numpy()
                log(f"imgs {chunk[0]}-{chunk[-1]} epoch {done} "
                    f"mean_min_loss {bl.mean():.6f} worst {bl.max():.6f} "
                    f"({time.time() - t0:.1f}s)")
                t0 = time.time()
        bl, br = best_loss.cpu().numpy(), best_r2.cpu().numpy()
        for i, img in enumerate(chunk):
            results[img] = [float(bl[i]), float(br[i])]
            log(f"img {img + 1}: loss={bl[i]:.6f} r2={br[i]:.4f}")
    return _report(args, [results[i] for i in p.img_ids], log)


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--epochs", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--filter_type", default="band",
                    choices=["low", "high", "band", "rejection", "comb",
                             "low_band"])
    ap.add_argument("--net", default="BernNet",
                    choices=list(FILTER_MODEL_REGISTRY))
    ap.add_argument("--img_num", type=int, default=3)
    ap.add_argument("--img_ids", default="",
                    help="comma-separated image indices (overrides img_num)")
    ap.add_argument("--use_eig", action="store_true")
    ap.add_argument("--lap_method", default="none")
    ap.add_argument("--sign_inv_net", default="DS")
    ap.add_argument("--basis_inv_net", default="IGN")
    ap.add_argument("--ign_hidden", type=int, default=32,
                    help="IGN phi width; 16 gives the published "
                         "48,221-parameter BasisNet row")
    ap.add_argument("--hidden_channels", type=int, default=32)
    ap.add_argument("--num_layers", type=int, default=2)
    ap.add_argument("--scan_epochs", type=int, default=100,
                    help="epochs between host reads of the best loss")
    ap.add_argument("--vmap_images", type=int, default=1,
                    help="train this many images' models at once through "
                         "torch.func.vmap (1 = serial)")
    ap.add_argument("--matmul_precision", default=None,
                    choices=[None, "default", "high", "highest"],
                    help="torch float32 matmul precision for the run "
                         "('highest' = full float32)")
    ap.add_argument("--k", type=int, default=0,
                    help="use only the first k eigenvectors (0 = all)")
    ap.add_argument("--basis_rot_seed", type=int, default=-1,
                    help=">= 0: a random orthogonal re-draw of the "
                         "eigenvector basis inside repeated eigenspaces")
    ap.add_argument("--mat_path", default="data/2dgrid/2Dgrid.mat")
    ap.add_argument("--label_dir", default="data/2dgrid")
    ap.add_argument("--results_dir", default=os.path.join("out", "filters"))
    return ap


if __name__ == "__main__":
    run(build_parser().parse_args())
