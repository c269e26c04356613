"""Per-kernel micro-benchmarks of the port at ZINC batch shapes, on the card.

Port of bench_ops.py (the JAX package's per-kernel benchmark), section by
section, at its shapes and seeds:

    python -m signnet_basisnet_tpu_torch.bench_ops            # kernels, steps
    python -m signnet_basisnet_tpu_torch.bench_ops --packer   # host packer

- flat SpMM (N, E, D = 3072, 6912, 128): `spmm_reference` (gather +
  index_add_), `spmm_onehot` (one-hot matrix products) and K5 (`spmm_flat`,
  on edges padded to 1024 with 256-node tile ranges);
- tile-local SpMM: K1 (`spmm_tiled`) against `spmm_reference`;
- attention (H = 8, D = 10): K2 forward and K2 + K3 value and gradient
  against `edge_softmax_attention_reference`;
- GatedGCN gate (F = 68): K4 forward and value and gradient against
  `gatedgcn_gate_reference`, values compared at the real edge slots only;
- full-width train steps (GIN 16x95, Transformer 10x64 with 8 heads,
  GatedGCN 16x68, each with SignNet k = 8 and an 8-layer GIN phi) under the
  `xla` and `pallas_tile` aggregation backends on one 128-graph synthetic
  ZINC batch in 256-node tiles;
- `--packer`: numpy `batch_np` against the native packer on 10,000 graphs.

Device times are medians of per-call CUDA-event times (utils.profiling.
cuda_event_ms, warm L2); the packer is host work, timed on the host clock.
A comparison outside its stated tolerance, or any failure, raises: the
script exits non-zero.  `main()` returns a dict of every number printed,
with each section's kernel calls (`calls`) and the launch counters' growth
over it (`launches`).  It runs on `cuda` unless `--device cpu` is given; on
the CPU the kernels' plain versions run and the times are host-clock
medians of PyTorch's CPU code, for the tests only.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch

from . import ops
from .data import add_lap_pe, choose_budgets, pack_batches, synthetic_zinc
from .graph import batch_np, edge_csr, from_arrays
from .graph import segment as seg
from .models import gnn_model
from .training import adam, build_steps, make_zinc_predict
from .utils.profiling import cuda_event_ms

N, E, D = 3072, 6912, 128
BN = 256
REPS = 50
STEP_REPS = 20
# (rtol, atol): f32 sums of the same products in other orders; gradients
# subtract sums of their own magnitude (1e-5 of the largest, at least 1e-5)
VALUE_TOL = (1e-5, 1e-5)
GRAD_TOL = (1e-4, None)

TRAIN_CFGS = {
    "GIN": dict(hidden_dim=95, out_dim=95, n_layers=16, pos_enc_dim=8,
                lap_method="sign_inv", sign_inv_net="gin", sign_inv_layers=8,
                phi_out_dim=4, batch_norm=True, dropout=0.0),
    "Transformer": dict(hidden_dim=64, out_dim=64, n_layers=10, num_heads=8,
                        pos_enc_dim=8, lap_method="sign_inv",
                        sign_inv_net="gin", sign_inv_layers=8, phi_out_dim=4,
                        edge_feat=True, batch_norm=True, dropout=0.0),
    "GatedGCN": dict(hidden_dim=68, out_dim=68, n_layers=16, pos_enc_dim=8,
                     lap_method="sign_inv", sign_inv_net="gin",
                     sign_inv_layers=8, phi_out_dim=4, edge_feat=True,
                     batch_norm=True, dropout=0.0),
}


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    attn = ops.edge_softmax_attention_tiled
    return {"spmm_flat": ops.spmm_flat.launches,
            "spmm_tiled": ops.spmm_tiled.launches,
            "edge_attention_fwd": attn.launches_fwd,
            "edge_attention_bwd": attn.launches_bwd,
            "gatedgcn_gate_fwd": ops.gatedgcn_gate_tiled.launches}


class _Section:
    """One section's record: its times, comparisons, kernel calls (counted
    where the script calls a kernel's wrapper) and the launch counters'
    growth over it."""

    def __init__(self, name, dev, reps):
        self.name, self.dev, self.reps = name, dev, reps
        self.rec = {"ms": {}, "max_err": {}}
        self.calls = defaultdict(int)
        self.before = launch_counts()

    def counted(self, fn, *kernels):
        """fn, counting one call of each of `kernels` per call."""
        def call(*args):
            for k in kernels:
                self.calls[k] += 1
            return fn(*args)
        return call

    def time(self, key, fn, reps=None, warmup=3):
        """Median ms of fn(): CUDA events on the card, host clock on the
        CPU."""
        reps = reps or self.reps
        if self.dev.type == "cuda":
            ms = float(np.median(cuda_event_ms(fn, reps, warmup)))
        else:
            for _ in range(warmup):
                fn()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
            ms = float(np.median(ts))
        self.rec["ms"][key] = ms
        return ms

    def compare(self, key, got, ref, tol=VALUE_TOL):
        """Record max |got - ref| (NaN if any entry is not finite); raise if
        an entry is not within atol + rtol * |ref| (atol None: 1e-5 of max
        |ref|, at least 1e-5).  A NaN is never within it."""
        rtol, atol = tol
        ref = ref.detach().float()
        if atol is None:
            atol = 1e-5 * max(1.0, float(ref.abs().max()))
        err = (got.detach().float() - ref).abs()
        bad = int((~(err <= atol + rtol * ref.abs())).sum())
        self.rec["max_err"][key] = dict(
            max_err=float(err.max()), rtol=rtol, atol=atol,
            ref_max=float(ref.abs().max()), ok=bad == 0)
        if bad:
            raise AssertionError(f"{self.name} {key}: {bad} entries beyond "
                                 f"{atol:g} + {rtol:g}*|ref| (max error "
                                 f"{float(err.max()):.3e})")

    def done(self, check=True):
        """The record; with `check`, on the card, each kernel must have
        launched once per call the section made."""
        now = launch_counts()
        self.rec["calls"] = dict(self.calls)
        self.rec["launches"] = {k: now[k] - self.before[k] for k in now}
        if check and self.dev.type == "cuda":
            for k, n in self.rec["launches"].items():
                if n != self.calls.get(k, 0):
                    raise AssertionError(
                        f"{self.name}: {k} launched {n} times for "
                        f"{self.calls.get(k, 0)} calls")
        return self.rec


def _t(a, dev):
    return torch.as_tensor(a).to(dev)


def flat_problem(n=N, e=E, d=D, seed=0):
    """bench_ops.py's flat SpMM inputs (numpy): x [n, d]; e edges with
    sources anywhere, sorted by destination, 90 % of weight 1 (s, r, w);
    the same padded to 1024 by `pad_edges_to` (sp, rp, wp: weight-0 edges
    from node 0 to the last receiver) and the 256-node tile ranges of the
    padded receivers (st, en)."""
    rng = np.random.default_rng(seed)
    p = dict(x=rng.normal(size=(n, d)).astype(np.float32),
             s=rng.integers(0, n, e).astype(np.int32),
             r=np.sort(rng.integers(0, n, e).astype(np.int32)),
             w=(rng.random(e) < 0.9).astype(np.float32))
    p["sp"], p["rp"], p["wp"] = ops.pad_edges_to(p["s"], p["r"], p["w"],
                                                 1024)
    p["st"], p["en"] = ops.tile_edge_ranges(p["rp"], n, bn=BN)
    return p


def bench_flat_spmm(dev, n=N, e=E, d=D, reps=REPS):
    """bench_ops.py:36-77: XLA-style scatter, one-hot products, K5."""
    sec = _Section("flat_spmm", dev, reps)
    p = {k: _t(v, dev) for k, v in flat_problem(n, e, d).items()}
    x, s, r, w = p["x"], p["s"], p["r"], p["w"]
    ref_fn = lambda: ops.spmm_reference(x, s, r, w, n)
    one_fn = lambda: ops.spmm_onehot(x, s, r, w, n)
    k5 = [p[k] for k in ("x", "sp", "rp", "wp", "st", "en")]
    k5_fn = sec.counted(lambda: ops.spmm_flat(*k5, n, BN), "spmm_flat")
    ref = ref_fn()
    sec.compare("onehot", one_fn(), ref)
    sec.compare("spmm_flat", k5_fn(), ref)
    for key, fn in (("xla_scatter", ref_fn), ("onehot", one_fn),
                    ("spmm_flat", k5_fn)):
        ms = sec.time(key, fn)
        err = sec.rec["max_err"].get(key)
        print(f"{key + ':':13s} {ms * 1e3:8.1f} us  ({e / ms / 1e3:.1f} "
              f"Medges/s)" + (f"  max_err={err['max_err']:.2e}" if err
                              else ""), flush=True)
    sec.rec.update(n=n, e=e, e_padded=len(p["sp"]), d=d)
    return sec.done()


def _tiled_edges(rng, n, e, bn=BN):
    """Dst-sorted tile-local edges (src, dst), numpy, drawn as
    bench_ops.py:_tiled_edges draws them."""
    t = rng.integers(0, n // bn, size=e)
    src = (t * bn + rng.integers(0, bn, size=e)).astype(np.int32)
    dst = (t * bn + rng.integers(0, bn, size=e)).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order]


def bench_tiled_spmm(dev, n=N, e=E, d=D, reps=REPS):
    """bench_ops.py:79-97: K1 on a tile-local edge set."""
    sec = _Section("tiled_spmm", dev, reps)
    x = _t(np.random.default_rng(0).normal(size=(n, d)).astype(np.float32),
           dev)
    rng = np.random.default_rng(1)
    src, dst = _tiled_edges(rng, n, e)
    wt = rng.random(e).astype(np.float32)
    sp, dp, wp = ops.pad_edges_to(src, dst, wt, 1024)
    st, en = ops.tile_edge_ranges(dst, n, bn=BN)
    args = tuple(_t(a, dev) for a in (sp, dp, wp, st, en))
    csr = edge_csr(args[0], args[1], n)
    k1_fn = sec.counted(lambda: ops.spmm_tiled(x, *args, n, BN, csr),
                        "spmm_tiled")
    ref = ops.spmm_reference(x, *(_t(a, dev) for a in (src, dst, wt)), n)
    sec.compare("spmm_tiled", k1_fn(), ref)
    ms = sec.time("spmm_tiled", k1_fn)
    print(f"spmm_tiled:   {ms * 1e3:8.1f} us  ({e / ms / 1e3:.1f} Medges/s)"
          f"  max_err={sec.rec['max_err']['spmm_tiled']['max_err']:.2e}",
          flush=True)
    sec.rec.update(n=n, e=e, d=d)
    return sec.done()


def _grads(fn, inputs, loss):
    """(value, gradients of loss(value) w.r.t. inputs)."""
    out = fn(*inputs)
    return out, torch.autograd.grad(loss(out), inputs)


def bench_attention(dev, n=N, e=E, H=8, Dh=10, reps=REPS):
    """bench_ops.py:244-291: K2, and K2 + K3 under value and gradient."""
    sec = _Section("attention", dev, reps)
    rng = np.random.default_rng(2)
    src, dst = _tiled_edges(rng, n, e)
    sp, dp, mp = ops.pad_edges_to(src, dst, np.ones(e, np.float32), 1024)
    st, en = ops.tile_edge_ranges(dst, n, bn=BN)
    mk = lambda rows: _t(rng.normal(size=(rows, H, Dh)).astype(np.float32),
                         dev)
    qkve = [mk(n), mk(n), mk(n), mk(len(sp))]
    sj, rj, ej, stj, enj = (_t(a, dev) for a in (sp, dp, mp, st, en))
    csr = edge_csr(sj, rj, n)
    xla = lambda *a: ops.edge_softmax_attention_reference(*a, sj, rj, ej, n)
    pal = lambda *a: ops.edge_softmax_attention_tiled(*a, sj, rj, ej, stj,
                                                      enj, BN, csr)
    pal_c = sec.counted(pal, "edge_attention_fwd")
    sec.compare("attn_fwd", pal_c(*qkve), xla(*qkve))
    req = [t.clone().requires_grad_(True) for t in qkve]
    loss = lambda out: (out ** 2).sum()
    gx_fn = lambda: _grads(xla, req, loss)
    gp_fn = sec.counted(lambda: _grads(pal, req, loss), "edge_attention_fwd",
                        "edge_attention_bwd")
    for nm, a, b in zip(("dQ", "dK", "dV", "dE1"), gp_fn()[1], gx_fn()[1]):
        sec.compare(f"attn_{nm}", a, b, GRAD_TOL)
    with torch.no_grad():
        t_x = sec.time("attn_xla", lambda: xla(*qkve))
        t_p = sec.time("attn_kernel", lambda: pal_c(*qkve))
    t_gx = sec.time("attn_xla+bwd", gx_fn)
    t_gp = sec.time("attn_kernel+bwd", gp_fn)
    print(f"attn_xla:     {t_x * 1e3:8.1f} us  ({e / t_x / 1e3:.1f} "
          f"Medges/s)", flush=True)
    print(f"attn_kernel:  {t_p * 1e3:8.1f} us  ({e / t_p / 1e3:.1f} Medges/s)"
          f"  max_err={sec.rec['max_err']['attn_fwd']['max_err']:.2e}  "
          f"speedup={t_x / t_p:.2f}x", flush=True)
    print(f"attn_xla+bwd:    {t_gx * 1e3:8.1f} us", flush=True)
    g_err = max(sec.rec["max_err"][f"attn_{k}"]["max_err"]
                for k in ("dQ", "dK", "dV", "dE1"))
    print(f"attn_kernel+bwd: {t_gp * 1e3:8.1f} us  speedup={t_gx / t_gp:.2f}x"
          f"  max_err(grads)={g_err:.2e}", flush=True)
    sec.rec.update(n=n, e=e, heads=H, head_dim=Dh)
    return sec.done()


def bench_gatedgcn(dev, n=N, e=E, F=68, reps=REPS):
    """bench_ops.py:114-162: K4, and K4 under value and gradient; values
    compared at the valid edge slots only (the reference computes e_new at
    the padding slots, the kernel writes zeros there: both are masked
    downstream)."""
    sec = _Section("gatedgcn", dev, reps)
    rng = np.random.default_rng(4)
    src, dst = _tiled_edges(rng, n, e)
    sp, dp, mp = ops.pad_edges_to(src, dst, np.ones(e, np.float32), 1024)
    st, en = ops.tile_edge_ranges(dst, n, bn=BN)
    feats = [_t(rng.normal(size=(rows, F)).astype(np.float32), dev)
             for rows in (n, n, n, len(sp))]
    sj, rj, ej, stj, enj = (_t(a, dev) for a in (sp, dp, mp, st, en))
    csr = edge_csr(sj, rj, n)
    xla = lambda *f: ops.gatedgcn_gate_reference(*f, sj, rj, ej, n)
    pal = lambda *f: ops.gatedgcn_gate_tiled(*f, sj, rj, ej, stj, enj, n,
                                             BN, csr)
    pal_c = sec.counted(pal, "gatedgcn_gate_fwd")
    (agg_x, e_x), (agg_p, e_p) = xla(*feats), pal_c(*feats)
    vm = (ej > 0)[:, None]
    sec.compare("gate_agg", agg_p, agg_x)
    sec.compare("gate_e_new_valid", e_p * vm, e_x * vm)
    req = [t.clone().requires_grad_(True) for t in feats]
    loss = lambda out: (out[0] ** 2).sum() + (out[1] ** 2).sum()
    gx_fn = lambda: _grads(xla, req, loss)
    gp_fn = sec.counted(lambda: _grads(pal, req, loss), "gatedgcn_gate_fwd")
    with torch.no_grad():
        t_x = sec.time("gate_xla", lambda: xla(*feats))
        t_p = sec.time("gate_kernel", lambda: pal_c(*feats))
    t_gx = sec.time("gate_xla+bwd", gx_fn)
    t_gp = sec.time("gate_kernel+bwd", gp_fn)
    err = max(v["max_err"] for v in sec.rec["max_err"].values())
    print(f"gate_xla:     {t_x * 1e3:8.1f} us  ({e / t_x / 1e3:.1f} "
          f"Medges/s)", flush=True)
    print(f"gate_kernel:  {t_p * 1e3:8.1f} us  ({e / t_p / 1e3:.1f} Medges/s)"
          f"  max_err={err:.2e}  speedup={t_x / t_p:.2f}x", flush=True)
    print(f"gate_xla+bwd:    {t_gx * 1e3:8.1f} us", flush=True)
    print(f"gate_kernel+bwd: {t_gp * 1e3:8.1f} us  speedup={t_gx / t_gp:.2f}x",
          flush=True)
    sec.rec.update(n=n, e=e, F=F)
    return sec.done()


def bench_train_steps(dev, cfgs=None, n_graphs=128, reps=STEP_REPS,
                      warmup=5):
    """bench_ops.py:165-241: one train step of each model under the `xla`
    and `pallas_tile` aggregation backends, on one fixed tile-local batch.
    Records the median step time, real edges/s and, per backend, the
    launches per step of each kernel."""
    sec = _Section("train_steps", dev, reps)
    cfgs = TRAIN_CFGS if cfgs is None else cfgs
    train = synthetic_zinc(num_train=n_graphs, num_val=8, num_test=8,
                           seed=0)["train"]
    k = next(iter(cfgs.values()))["pos_enc_dim"]
    add_lap_pe(train, k)
    nb, eb, gc = choose_budgets(train, n_graphs, tile=BN)
    arrays = pack_batches(train, nb, eb, gc, k=k, tile=BN)[0]
    gb = from_arrays(arrays).to(dev)
    edges = float(arrays["edge_mask"].sum())
    sec.rec.update(num_nodes=nb, num_edges=eb, real_edges=edges, steps={},
                   launches_per_step={})
    saved = seg.get_agg_backend()
    try:
        for name, kw in cfgs.items():
            for backend in ("xla", "pallas_tile"):
                seg.set_agg_backend(backend)
                model = gnn_model(name, **kw).to(dev)
                step, _ = build_steps(
                    model, make_zinc_predict(model, kw["lap_method"]),
                    adam(model.parameters()))
                before = launch_counts()
                ms = sec.time(f"{name}_{backend}",
                              lambda: step(gb, 1e-3), reps, warmup)
                n_steps = reps + warmup
                grew = {kk: v - before[kk]
                        for kk, v in launch_counts().items()}
                per_step = {kk: v / n_steps for kk, v in grew.items() if v}
                sec.rec["steps"][f"{name}_{backend}"] = n_steps
                sec.rec["launches_per_step"][f"{name}_{backend}"] = per_step
                print(f"{name}_step_{backend}: {ms * 1e3:9.1f} us  "
                      f"({edges / ms / 1e3:.2f} M real edges/s)  launches "
                      f"per step {per_step}", flush=True)
            x_ms = sec.rec["ms"][f"{name}_xla"]
            p_ms = sec.rec["ms"][f"{name}_pallas_tile"]
            print(f"{name}_step speedup (pallas_tile vs xla): "
                  f"{x_ms / p_ms:.3f}x", flush=True)
    finally:
        seg.set_agg_backend(saved)
    # the steps call no kernel directly: launches per step are the record
    return sec.done(check=False)


def _packer_graphs(rng, n_graphs):
    gs = []
    for _ in range(n_graphs):
        n = int(rng.integers(10, 38))
        e = int(rng.integers(n, 3 * n))
        s = rng.integers(0, n, e).astype(np.int32)
        r = rng.integers(0, n, e).astype(np.int32)
        gs.append(dict(senders=s, receivers=r,
                       node_feat=rng.integers(0, 28, n).astype(np.int32),
                       edge_feat=rng.integers(0, 4, e).astype(np.int32),
                       y=np.array([float(rng.normal())], np.float32),
                       eigvecs=rng.normal(size=(n, 8)).astype(np.float32),
                       eigvals=rng.normal(size=(8,)).astype(np.float32)))
    return gs


def bench_packer(n_graphs=10000, batch=128, reps=20):
    """bench_ops.py:294-339: host packing of one 128-graph batch, numpy
    `batch_np` against the native packer (host clock, median per batch);
    the two batches must agree bit for bit."""
    from .data.native import GraphStore, pack_batch_native
    gs = _packer_graphs(np.random.default_rng(3), n_graphs)
    nb, eb, gc = 3584, 14336, batch + 1
    idx = np.arange(batch)
    store = GraphStore(gs, k=8)
    sel = lambda i: (idx + i * batch) % n_graphs
    t_np, t_nat = [], []
    for i in range(reps):
        t0 = time.perf_counter()
        a = batch_np([gs[j] for j in sel(i)], nb, eb, gc, k=8)
        t_np.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        b = pack_batch_native(store, sel(i), nb, eb, gc)
        t_nat.append(time.perf_counter() - t0)
        for key, v in a.items():
            if not np.array_equal(v, b[key]):
                raise AssertionError(f"native packer differs from batch_np "
                                     f"at {key!r}")
    np_ms, nat_ms = (float(np.median(t)) * 1e3 for t in (t_np, t_nat))
    print(f"pack_numpy:   {np_ms:8.2f} ms/batch ({batch / np_ms * 1e3:.0f} "
          "graphs/s)", flush=True)
    print(f"pack_native:  {nat_ms:8.2f} ms/batch ({batch / nat_ms * 1e3:.0f}"
          f" graphs/s)  speedup={np_ms / nat_ms:.1f}x", flush=True)
    return dict(numpy_ms_per_batch=np_ms, native_ms_per_batch=nat_ms,
                numpy_graphs_per_s=batch / np_ms * 1e3,
                native_graphs_per_s=batch / nat_ms * 1e3,
                n_graphs=n_graphs, batch=batch, reps=reps, clock="host")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--packer", action="store_true",
                    help="time the host packers instead of the kernels")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions, tests only)")
    args = ap.parse_args(argv)
    if args.packer:
        return {"packer": bench_packer()}
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: bench_ops measures the card "
                           "(pass --device cpu to run the plain versions)")
    res = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "clock": "cuda events" if dev.type == "cuda" else "host"}
    # f32 matmuls (the one-hot products, the steps) at f32, for this run
    # only: the caller's TF32 settings come back afterwards
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        res["flat_spmm"] = bench_flat_spmm(dev)
        res["tiled_spmm"] = bench_tiled_spmm(dev)
        res["attention"] = bench_attention(dev)
        res["gatedgcn"] = bench_gatedgcn(dev)
        res["train_steps"] = bench_train_steps(dev)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return res


if __name__ == "__main__":
    print(json.dumps(main(), default=float))
