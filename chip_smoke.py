#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (signnet_basisnet_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing its start and its seconds, with a synchronize after
each so a stall shows where it happened:

0. the card's name and power limit (nvidia-smi); build every kernel of the
   main path from the checkout's sources (nvcc, -Xptxas -v summary);
1. each kernel against its plain PyTorch version on the card at the main
   path's shapes (f32 and bf16, forward and transposed, autograd, a batch
   with non-tile-local edges), with the stated tolerance; CUDA-event times of
   the kernel, the plain version and one library call (a yardstick, never
   used by the port) beside the bound the card's memory and arithmetic rates
   put on the same work;
2. a reference check: one full-width train step on the card against the same
   step on the CPU (the kernels' plain versions) from the same weights; the
   warm step's time on one fixed batch, f32 and bf16 in turns, with the
   profiler's device share; then the main path itself, the flagship
   trainer (configs/gin_zinc_signinv_gin.json with data.agg_backend
   pallas_tile: GIN 16x95,
   SignNet k=8 with an 8-layer GIN phi, 128-graph batches in 256-node tiles,
   synthetic ZINC) through train_zinc.run in f32, with the kernel launch
   counts read against 47 per train step and 24 per eval step;
3. the same trainer in bf16 compute for a few steps.

The last two lines are the kernels' JSON record and the result line.  Any
failure raises (exit code 1); without a card it exits 2 and prints no
result.  Imports no JAX and nothing of the JAX package.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join("configs", "gin_zinc_signinv_gin.json")
OUT_DIR = os.path.join("out", "chip_smoke")

# published H100 SXM peaks at 700 W (NVIDIA data sheet): HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores (the kernel's FMAs run in f32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        print(f"[phase {self.name}] start", flush=True)
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        import torch
        if exc[0] is None:
            torch.cuda.synchronize()
            print(f"[phase {self.name}] done in {time.time() - self.t0:.1f} s",
                  flush=True)
        return False


def _fail_without_checkout_or_card():
    if not os.path.isdir(os.path.join(ROOT, "signnet_basisnet_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(signnet_basisnet_tpu_torch/ not found)", file=sys.stderr)
        sys.exit(2)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script measures the card "
              "and has no CPU fallback", file=sys.stderr)
        sys.exit(2)


def _cuda_time_ms(fn, iters=50, flush=None):
    """Mean CUDA-event time of fn()'s device work in ms, L2 flushed before
    each call (the main path finds x cold: other layers' work runs in
    between)."""
    import torch
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        # hold the card ~1 ms so the host has enqueued fn() before the
        # start event fires: the events then time the device work alone
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def _profiled_kernel_us(fn, name, iters=20):
    """Mean device time in us of the kernels whose name holds `name`, from
    torch.profiler, or "not measured" if the trace shows none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if name in e.key]
    total = sum(getattr(e, "device_time_total", 0.0) for e in hits)
    count = sum(e.count for e in hits)
    return round(total / count, 2) if count and total else "not measured"


def _interleaved_ms(steps, batch, repeats=5, window=10):
    """Host-clock ms per warm train step for each named step function, on
    one fixed batch (no input pipeline): `repeats` windows of `window`
    steps each, the steps taking turns window by window so that a slow
    spell of the shared host falls on all of them alike."""
    import torch
    for step in steps.values():
        for _ in range(2):
            step(batch, 1e-3)
    torch.cuda.synchronize()
    ms = {name: [] for name in steps}
    for _ in range(repeats):
        for name, step in steps.items():
            t0 = time.time()
            for _ in range(window):
                step(batch, 1e-3)
            torch.cuda.synchronize()
            ms[name].append((time.time() - t0) / window * 1e3)
    return ms


def _profile_steps(step, batch, kernel, steps=3):
    """From torch.profiler over `steps` warm train steps: the device time
    and busy share per step, the device ops per step and `kernel`'s
    share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step(batch, 1e-3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(steps):
            step(batch, 1e-3)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    # device work only: user-annotation ranges on the device timeline span
    # kernels already counted
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in dev)
    if not busy:
        return "not measured (no device events in the trace)"
    ours = sum(e.self_device_time_total for e in dev if kernel in e.key)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    return dict(
        wall_ms_per_step=round(wall_us / steps / 1e3, 2),
        device_us_per_step=round(busy / steps, 1),
        device_busy_share=round(busy / wall_us, 3),
        device_ops_per_step=round(sum(e.count for e in dev) / steps, 1),
        kernel_share_of_device=round(ours / busy, 3),
        top=[(e.key[:60], round(e.self_device_time_total / steps, 1))
             for e in top])


def main():
    _fail_without_checkout_or_card()
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from signnet_basisnet_tpu_torch.data import (add_lap_pe, choose_budgets,
                                                 pack_batches,
                                                 synthetic_zinc)
    from signnet_basisnet_tpu_torch.graph import edge_csr, from_arrays
    from signnet_basisnet_tpu_torch.graph import segment as seg
    from signnet_basisnet_tpu_torch.models import gnn_model
    from signnet_basisnet_tpu_torch.models.conv import batch_csr
    from signnet_basisnet_tpu_torch.ops.spmm_tiled import (
        _launch, _tile_mask, build, build_info, spmm_tiled, spmm_tiled_plain)
    from signnet_basisnet_tpu_torch.train_zinc import run
    from signnet_basisnet_tpu_torch.training import (adam, build_steps,
                                                     load_config,
                                                     make_zinc_predict)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    os.makedirs(OUT_DIR, exist_ok=True)
    record = {}

    # ---------------------------------------------------------------- 0
    with Phase("0 card and build"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        record["card"] = smi
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}", flush=True)
        build()
        print(f"spmm_tiled: nvcc {build_info['seconds']:.1f} s -> "
              f"{os.path.relpath(build_info['path'], ROOT)}", flush=True)
        for line in build_info["ptxas"].splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    # ---------------------------------------------------------------- 1
    with Phase("1 kernel vs plain"):
        gs = synthetic_zinc(512, 0, 0, seed=0)["train"]
        add_lap_pe(gs, 8)
        nb, eb, gc = choose_budgets(gs, 128, tile=256)
        arrays = pack_batches(gs, nb, eb, gc, k=8, tile=256)[0]
        gb = from_arrays(arrays).to(dev)
        bn = 256
        n_tiles = gb.extras["tile_starts"].shape[0]
        print(f"main-path batch: N={nb} ({n_tiles} tiles of {bn}), E={eb}, "
              f"{gc} graph slots, {int(arrays['edge_mask'].sum())} real "
              "edges", flush=True)
        args = (gb.senders, gb.receivers, gb.edge_mask,
                gb.extras["tile_starts"], gb.extras["tile_ends"])
        csr = batch_csr(gb)
        gen = torch.Generator(device=dev).manual_seed(0)
        max_err = 0.0
        # f32: fixed-order f32 sums on both sides, 1e-5; bf16: both round an
        # f32 sum once, so at most one bf16 ulp apart (2**-8 relative)
        tols = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -7, 1e-3)}

        def check(name, got, ref, dtype):
            nonlocal max_err
            rtol, atol = tols[dtype]
            err = (got.float() - ref.float()).abs()
            bad = err > atol + rtol * ref.float().abs()
            max_err = max(max_err, float(err.max()))
            print(f"  {name}: max_abs_err {float(err.max()):.3e} "
                  f"(tol {atol:g} + {rtol:g}*|ref|)", flush=True)
            if bool(bad.any()):
                raise AssertionError(f"{name}: kernel disagrees with its plain "
                                     f"version at {int(bad.sum())} entries")

        for feat in (16, 95, 1520):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(nb, feat, device=dev, generator=gen).to(dtype)
                for transpose in (False, True):
                    got = _launch(x, *args, csr, bn, transpose)
                    ref = spmm_tiled_plain(x, *args, bn, transpose=transpose)
                    check(f"F={feat} {str(dtype)[6:]} "
                          f"{'transposed' if transpose else 'forward'}",
                          got, ref, dtype)
        # autograd through the wrapper (forward + transposed kernel)
        x = torch.randn(nb, 95, device=dev, generator=gen, requires_grad=True)
        c = torch.randn(nb, 95, device=dev, generator=gen)
        (spmm_tiled(x, *args, nb, bn, csr) * c).sum().backward()
        xr = x.detach().clone().requires_grad_(True)
        (spmm_tiled_plain(xr, *args, bn) * c).sum().backward()
        check("autograd dx F=95 f32", x.grad, xr.grad, torch.float32)
        # a batch with non-tile-local edges: 5% of the real edges get a
        # source in another tile; both versions must drop them
        s_far = gb.senders.clone()
        real = torch.nonzero(gb.edge_mask > 0)[:, 0]
        pick = real[torch.randperm(real.numel(), device=dev,
                                   generator=gen)[:real.numel() // 20]]
        s_far[pick] = (s_far[pick] + bn) % nb
        far_args = (s_far,) + args[1:]
        far_csr = edge_csr(s_far, gb.receivers, nb)
        kept = _tile_mask(*far_args[:2], *far_args[3:], bn)
        assert int((~kept & (gb.edge_mask > 0)).sum()) == pick.numel()
        x = torch.randn(nb, 1520, device=dev, generator=gen)
        for transpose in (False, True):
            got = _launch(x, *far_args, far_csr, bn, transpose)
            ref = spmm_tiled_plain(x, *far_args, bn, transpose=transpose)
            drop = spmm_tiled_plain(x, s_far, gb.receivers,
                                    gb.edge_mask * kept, *args[3:], bn,
                                    transpose=transpose)
            check(f"non-local edges {'transposed' if transpose else 'forward'}",
                  got, ref, torch.float32)
            check("  ... same as with them removed", got, drop,
                  torch.float32)

        # times at F = 1520 (phi layers 1-7), f32
        x = torch.randn(nb, 1520, device=dev, generator=gen)
        flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
        kernel_ms = _cuda_time_ms(
            lambda: _launch(x, *args, csr, bn, False), flush=flush)
        kernel_t_ms = _cuda_time_ms(
            lambda: _launch(x, *args, csr, bn, True), flush=flush)
        plain_ms = _cuda_time_ms(lambda: spmm_tiled_plain(x, *args, bn),
                                 flush=flush)
        ok = _tile_mask(gb.senders, gb.receivers, *args[3:], bn)
        rows, cols = gb.receivers.long()[ok], gb.senders.long()[ok]
        a_csr = torch.sparse_coo_tensor(
            torch.stack([rows, cols]), gb.edge_mask[ok], (nb, nb),
            check_invariants=True).coalesce().to_sparse_csr()
        lib = torch.sparse.mm(a_csr, x)
        check("library torch.sparse.mm vs plain (yardstick)", lib,
              spmm_tiled_plain(x, *args, bn), torch.float32)
        library_ms = _cuda_time_ms(lambda: torch.sparse.mm(a_csr, x),
                                   flush=flush)
        # the bound of this batch's work: x is read only at the rows that
        # counted edges reach (forward: their sources; transposed: their
        # destinations), the output written at every row once, and the
        # index arrays the kernel reads once each (forward: senders,
        # weights, dst_ptr; transposed: src_order, receivers, weights,
        # src_ptr; both: the tile ranges)
        counted = ok & (gb.edge_mask != 0)
        n_counted = int(counted.sum())
        flops = 2 * n_counted * 1520
        t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
        bounds = {}
        for transpose, reached, n_index in (
                (False, gb.senders[counted], 2 * eb + nb + 1),
                (True, gb.receivers[counted], 3 * eb + nb + 1)):
            rows_read = int(torch.unique(reached).numel())
            bytes_moved = ((rows_read + nb) * 1520 * 4
                           + (n_index + 2 * n_tiles) * 4)
            t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
            bounds[transpose] = dict(
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=bytes_moved, rows_read=rows_read)
        bound_ms = bounds[False]["bound_ms"]
        bound_by = bounds[False]["bound_by"]
        print(f"spmm_tiled F=1520 f32: kernel_ms {kernel_ms:.4f} "
              f"(transposed {kernel_t_ms:.4f}), plain_ms {plain_ms:.4f}, "
              f"library_ms {library_ms:.4f} (torch.sparse.mm, CSR), "
              f"{flops / 1e6:.1f} MFLOP over {n_counted} counted edges",
              flush=True)
        for transpose, b in bounds.items():
            k_ms = kernel_t_ms if transpose else kernel_ms
            print(f"  bound {'transposed' if transpose else 'forward'}: "
                  f"{b['bound_ms'] * 1e3:.2f} us by {b['bound_by']} "
                  f"({b['bytes'] / 1e6:.2f} MB: x read at {b['rows_read']} "
                  f"of {nb} rows, output at all {nb}); kernel / bound "
                  f"{k_ms / b['bound_ms']:.2f}", flush=True)
        # cross-check of the event times: the profiler's device time of the
        # kernel itself (CUPTI), warm L2, back to back
        prof_us = _profiled_kernel_us(
            lambda: _launch(x, *args, csr, bn, False), "spmm_tiled_kernel")
        print(f"  profiler: spmm_tiled_kernel {prof_us} us per launch "
              "(warm L2)", flush=True)
        record.update(kernel_profiler_us_warm=prof_us)
        kern = dict(name="spmm_tiled", route="cuda",
                    source="signnet_basisnet_tpu_torch/ops/csrc/spmm_tiled.cu",
                    replaces="signnet_basisnet_tpu/ops/pallas_spmm.py:245",
                    launches=None, max_abs_err=max_err, ms=kernel_ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library_ms)
        record.update(kernel_transposed_ms=kernel_t_ms,
                      bound_transposed_ms=bounds[True]["bound_ms"])
        del x, flush, a_csr, lib

    # ---------------------------------------------------------------- 2
    def trainer_cfg(extra):
        return load_config(CONFIG, [
            "data.agg_backend", "pallas_tile", "data.synth_train", "512",
            "data.synth_eval", "128", "train.print_epoch_interval", "1",
            "out_dir", OUT_DIR] + extra)

    with Phase("2a full-width step, card vs CPU"):
        # one train step from the same weights through K1: on the card in
        # f32, and on the CPU (K1's plain version) in f32 and in f64.  The
        # f64 step stands for the exact one; the card's f32 error against
        # it must stay within 10x of the CPU's f32 error, tensor by tensor
        # (float noise grows through 24 BatchNorm'd layers on both)
        cfg = trainer_cfg([])
        m = cfg.model
        net = dict(hidden_dim=m.hidden_dim, out_dim=m.out_dim,
                   n_layers=m.n_layers, pos_enc_dim=m.pos_enc_dim,
                   lap_method=m.lap_method, sign_inv_layers=m.sign_inv_layers,
                   phi_out_dim=m.phi_out_dim, pe_aggregate=m.pe_aggregate,
                   seed=cfg.train.seed)
        seg.set_agg_backend("pallas_tile")
        losses, grads = {}, {}
        for run_name, d, dt in (("card", "cuda", torch.float32),
                                ("cpu", "cpu", torch.float32),
                                ("cpu_f64", "cpu", torch.float64)):
            model = gnn_model("GIN", **net).to(d, dt)
            step, _ = build_steps(model, make_zinc_predict(model, "sign_inv"),
                                  adam(model.parameters()))
            batch = from_arrays(arrays).to(d).cast_floats(dt)
            losses[run_name] = float(step(batch, 1e-3)["loss"])
            grads[run_name] = {n: p.grad.detach().cpu().double() for n, p in
                               model.named_parameters() if p.grad is not None}
            if run_name == "card":
                card_step = (step, batch)
        print("  loss " + ", ".join(f"{k} {v:.9f}" for k, v in
                                    losses.items()), flush=True)
        if not np.isfinite(losses["card"]) or abs(
                losses["card"] - losses["cpu_f64"]) > 10 * abs(
                losses["cpu"] - losses["cpu_f64"]) + 1e-6:
            raise AssertionError("card and CPU losses disagree")
        worst = (0.0, "")
        for n, g in grads["cpu_f64"].items():
            e_card = float((grads["card"][n] - g).abs().max())
            e_cpu = float((grads["cpu"][n] - g).abs().max())
            tol = 10 * e_cpu + 1e-6 * float(g.abs().max()) + 1e-12
            worst = max(worst, (e_card / tol, n))
            print(f"  {n}: max|g| {float(g.abs().max()):.3e} f32 error "
                  f"card {e_card:.3e} cpu {e_cpu:.3e}", flush=True)
        print(f"  grads: worst card error / tol {worst[0]:.3f} at {worst[1]}",
              flush=True)
        if worst[0] > 1:
            raise AssertionError(f"grad {worst[1]}: the card's f32 error is "
                                 "beyond 10x the CPU's")
        del model, step, grads

    with Phase("2b warm step, f32 and bf16 interleaved"):
        # the warm step on one fixed batch (no input pipeline), f32 and
        # bf16 compute taking turns window by window;
        # median and spread over the windows, then where each one's device
        # time goes (torch.profiler)
        bf16_model = gnn_model("GIN", **net).to(dev)
        bf16_step, _ = build_steps(
            bf16_model, make_zinc_predict(bf16_model, "sign_inv",
                                          compute_dtype=torch.bfloat16),
            adam(bf16_model.parameters()))
        f32_step, batch = card_step
        ms = _interleaved_ms({"f32": f32_step, "bf16": bf16_step}, batch)
        for name, v in ms.items():
            print(f"  warm {name} step (host clock, {len(v)} windows of 10 "
                  f"steps): median {float(np.median(v)):.2f} ms, min "
                  f"{min(v):.2f}, max {max(v):.2f}; windows "
                  f"{[round(t, 2) for t in v]}", flush=True)
            record[f"warm_{name}_step_ms"] = v
        for name, step in (("f32", f32_step), ("bf16", bf16_step)):
            prof = _profile_steps(step, batch, "spmm_tiled_kernel")
            print(f"  profiler, {name}: {prof}", flush=True)
            record[f"warm_{name}_step_profile"] = prof
        del bf16_model, bf16_step, f32_step, card_step

    with Phase("2 main path f32 (train_zinc, pallas_tile)"):
        cfg = trainer_cfg(["train.epochs", "2", "name", "f32"])
        # one forward launch per GIN layer (16 base + 8 phi = 24), one
        # transposed launch per layer but phi layer 0, whose input is the
        # eigenvector stack and needs no gradient: 47 per train step
        per_eval = cfg.model.n_layers + cfg.model.sign_inv_layers
        per_train = 2 * per_eval - 1
        spmm_tiled.launches = 0
        res = run(cfg, device="cuda", log=lambda s: print("  " + s,
                                                          flush=True))
        torch.cuda.synchronize()
        launches = spmm_tiled.launches
        expect = per_train * res.train_steps + per_eval * res.eval_steps
        print(f"  spmm_tiled launches {launches}, expected {per_train} x "
              f"{res.train_steps} train steps + {per_eval} x "
              f"{res.eval_steps} eval steps = {expect}", flush=True)
        if launches != expect:
            raise AssertionError(f"the main path did not launch K1 "
                                 f"{per_train} times per train step and "
                                 f"{per_eval} per eval step")
        hist = res.history
        if (res.epochs_run != 2 or not all(
                np.isfinite([h["train_loss"], h["val_mae"]]).all()
                for h in hist) or not np.isfinite(res.test_mae)):
            raise AssertionError(f"non-finite or missing metrics: {hist}")
        step_ms = hist[-1]["train_time"] / hist[-1]["train_steps"] * 1e3
        print(f"  step time (epoch 2, {hist[-1]['train_steps']} steps, "
              f"host clock to the last loss on the host): {step_ms:.2f} ms; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} "
              "MiB", flush=True)
        kern["launches"] = launches
        record.update(f32_step_ms=step_ms, f32_train_steps=res.train_steps,
                      f32_eval_steps=res.eval_steps, f32_history=hist)

    # ---------------------------------------------------------------- 3
    with Phase("3 main path bf16 (train.compute_dtype bfloat16)"):
        cfg = trainer_cfg(["train.epochs", "2", "train.compute_dtype",
                           "bfloat16", "data.synth_train", "384",
                           "name", "bf16"])
        spmm_tiled.launches = 0
        res = run(cfg, device="cuda", log=lambda s: print("  " + s,
                                                          flush=True))
        torch.cuda.synchronize()
        expect = per_train * res.train_steps + per_eval * res.eval_steps
        print(f"  spmm_tiled launches {spmm_tiled.launches}, expected "
              f"{expect}", flush=True)
        if spmm_tiled.launches != expect:
            raise AssertionError("bf16 path: wrong K1 launch count")
        h = res.history[-1]
        if not np.isfinite([h["train_loss"], h["val_mae"], res.test_mae]).all():
            raise AssertionError(f"bf16: non-finite metrics {res.history}")
        step_ms = h["train_time"] / h["train_steps"] * 1e3
        print(f"  bf16 step time (epoch 2, {h['train_steps']} steps, host "
              f"clock to the last loss on the host): {step_ms:.2f} ms",
              flush=True)
        record.update(bf16_step_ms=step_ms, bf16_history=res.history)

    record["kernels"] = [kern]
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=float)
    print(json.dumps({"kernels": [kern]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
