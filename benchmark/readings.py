"""The readings that a cell's limits (limits/<cell>.json) are set from, on
the card at the cell's own size, many seeds in one process:

    python3 benchmark/readings.py --workload <cell> --seeds <n> ... \
        [--control-seeds <n> ...] [--out FILE]

For each of `--seeds`: the program's first three steps against the
plain reference's (the lower reading: what sound runs give), and a second
run of the reference against the first (how far two sound runs of the
plain reference lie apart: index_add_ on the card adds in no fixed
order).  For each of `--control-seeds` also: the control, the reference
computed with TF32 (the nearest precision below the configuration's f32
with TF32 off) in the program's place; and the fault of half of each
batch's graphs left out, the mean taken over the rest, planted in the
reference put in the program's place.  (A step that returns its state
unchanged reads 1 on every change by construction and needs no run.)
One JSON line a reading goes to `--out`, and a summary to stdout.  The
benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _half_batch_loss(common):
    """readout_loss over the first half of each batch's graphs only."""
    import torch

    def readout_loss(P, batch, h):
        sums = h.new_zeros((batch.num_graphs, h.shape[1]))
        sums = sums.index_add_(0, batch.graph_id, h)
        counts = torch.bincount(batch.graph_id, minlength=batch.num_graphs)
        hg = sums / counts[:, None].to(h.dtype)
        for i in range(2):
            hg = torch.relu(common.linear(P, f"mlp_readout.fc_{i}", hg))
        pred = common.linear(P, "mlp_readout.fc_2", hg)[:, 0]
        half = batch.num_graphs // 2
        return (pred[:half] - batch.y[:half]).abs().mean()
    return readout_loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, BENCH_DIR]
    import torch
    from harness import cell as run
    from harness import check
    from harness.program import Program
    from harness.spec import load_cell
    from reference import common
    if not torch.cuda.is_available():
        print("readings.py: no CUDA card", file=sys.stderr)
        return 3
    cell = load_cell(ROOT, args.workload)
    dev = torch.device("cuda")
    out = open(args.out, "a") if args.out else None
    rows = []

    def emit(seed, kind, values):
        row = {"cell": cell.name, "seed": seed, "kind": kind, **values}
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in args.seeds + [s for s in args.control_seeds
                              if s not in args.seeds]:
        t0 = time.monotonic()
        run.set_precision(False)
        graphs, params, buffers = run.make_inputs(cell, seed, dev)
        ref = run.reference_run(cell, graphs, params, buffers, seed, dev)
        if seed in args.seeds:
            program = Program(cell.config, cell.traffic, graphs, seed, dev,
                              params, buffers)
            first = run.first_batches(program)
            program.make_step(first[0])
            prog = program.first_steps(first)
            program.free()
            del program, first
            torch.cuda.empty_cache()
            emit(seed, "program", check.readings(prog, ref))
            again = run.reference_run(cell, graphs, params, buffers, seed,
                                      dev)
            emit(seed, "reference_again", check.readings(again, ref))
        if seed in args.control_seeds:
            ctl = run.reference_run(cell, graphs, params, buffers, seed, dev,
                                    tf32=True)
            emit(seed, "control_tf32", check.readings(ctl, ref))
            saved = common.readout_loss
            common.readout_loss = _half_batch_loss(common)
            try:
                half = run.reference_run(cell, graphs, params, buffers, seed,
                                         dev)
            finally:
                common.readout_loss = saved
            emit(seed, "fault_half_batch", check.readings(half, ref))
        print(f"# seed {seed}: {time.monotonic() - t0:.1f} s",
              file=sys.stderr, flush=True)
    keys = [k for k in rows[0] if k not in ("cell", "seed", "kind")]
    for kind in sorted({r["kind"] for r in rows}):
        sel = [r for r in rows if r["kind"] == kind]
        print(f"## {kind} ({len(sel)} seeds): " + "; ".join(
            f"{k} {min(r[k] for r in sel):.3e}..{max(r[k] for r in sel):.3e}"
            for k in keys), flush=True)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
