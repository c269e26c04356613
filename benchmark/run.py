"""The benchmark of the PyTorch/CUDA port (signnet_basisnet_tpu_torch): one
run of one cell of BENCHMARK.json on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with as many cards as the cell
asks for.  It trains the cell's configuration on its traffic through the
port's captured train step and its input pipeline for `--seconds`, then
compares the port's first three steps with the plain reference
(benchmark/reference/).  The last line of stdout is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics;
with `--trace 1` its per-layer ones, read from a traced epoch after the
window), `device`, with `--trace 1` `breakdown`, and last `compared`, each
number compared beside its limit, which also close stderr.

Without a card, with fewer cards than the cell asks for, or where the
checkout lacks the port, it exits non-zero and prints no result; so it
does where the process holds jax, jaxlib, flax or the JAX package once the
window has closed.  Python's bytecode and any kernel cache go to fixed
directories inside the checkout (benchmark/.cache/); the port's nvcc
builds go to its own signnet_basisnet_tpu_torch/ops/_build/.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE = os.path.join(BENCH_DIR, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "signnet_basisnet_tpu")


def _caches() -> None:
    """Bytecode and kernel caches at fixed paths in the checkout, for this
    process and any it starts (where the environment turns the bytecode
    cache off, each run would compile torch's sources again)."""
    sys.dont_write_bytecode = False
    sys.pycache_prefix = os.path.join(CACHE, "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")


def _threads() -> None:
    """One thread for the CPU math libraries: the host's cores are shared,
    and idle OpenMP workers spinning beside the training loop and the
    input pipeline's thread make the host's clock jitter."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def loaded_forbidden():
    """Modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    say = lambda msg: print(msg, file=sys.stderr, flush=True)
    if not os.path.isdir(os.path.join(ROOT, "signnet_basisnet_tpu_torch")):
        say("run.py: the checkout lacks signnet_basisnet_tpu_torch/")
        return 2
    _caches()
    _threads()
    sys.path[:0] = [ROOT, BENCH_DIR]
    import torch
    torch.set_num_threads(1)
    from harness.cell import run_cell
    from harness.spec import load_cell
    cell = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        say(f"run.py: cell {cell.name} needs {cell.chips} CUDA card(s); "
            f"this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START, say)
    bad = loaded_forbidden()
    if bad:
        say(f"run.py: the process holds {bad}: the benchmark and the port "
            "must not load JAX or the JAX package")
        return 4
    for name, c in result["compared"].items():
        say(f"compared {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
