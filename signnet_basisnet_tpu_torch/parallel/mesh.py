"""Process groups and device meshes.

Port of signnet_basisnet_tpu/parallel/mesh.py onto `torch.distributed`:
one process per rank.  `init_distributed` joins the process group, from
the environment `torchrun` sets or from an explicit store (a `file://` or
`tcp://` init method), and returns the rank's device.  The backend is
NCCL where every rank of the host has a card of its own, and gloo on the
CPU and where several ranks share a card (NCCL refuses two ranks on one
device); gloo moves CUDA tensors through host memory itself, so the
ranks' tensors stay on the card either way.  `make_mesh` is a 2-D
`DeviceMesh` named ("dp", "mp"), `dp_sharding` and `replicated` its
DTensor placements for a stacked batch and for replicated state.

`spawn_ranks` runs a function in fresh processes (the `spawn` start
method), one a rank, joined through a file store in a temporary
directory: the tests' and the benchmarks' way to start a world without
`torchrun` or a TCP port.  A rank that fails or hangs fails the call, and
every process is stopped before it returns.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils import card_or_cpu


def init_distributed(device: str = "cuda", init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group (once per process; later calls only return
    the device) and return this rank's device: `cuda:{local_rank %
    device_count}`, or the CPU when `device` is 'cpu'.  Without
    `init_method` the group comes from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT).
    `backend` defaults to NCCL when each rank on the host has a card of its
    own, else gloo."""
    dev = card_or_cpu(device)
    if dist.is_initialized():
        world_size, rank = dist.get_world_size(), dist.get_rank()
    elif init_method is None:
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if backend is None:
            backend = ("nccl" if dev.type == "cuda"
                       and local_world <= torch.cuda.device_count()
                       else "gloo")
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank, **kw)
    return dev


def make_mesh(dp: Optional[int] = None, mp: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """The ("dp", "mp") mesh over every rank of the process group;
    `mesh.get_group("dp")` and `mesh.get_group("mp")` are this rank's
    groups along each axis."""
    n = dist.get_world_size()
    if dp is None:
        dp = n // mp
    if dp * mp != n:
        raise ValueError(f"dp*mp = {dp * mp} != {n} devices")
    return init_device_mesh(device_type, (dp, mp),
                            mesh_dim_names=("dp", "mp"))


def dp_sharding(mesh: DeviceMesh) -> Tuple:
    """Placements of stacked microbatches: the leading axis sharded over
    'dp', replicated over the other axes."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if name == "dp" else Replicate()
                 for name in _names(mesh))


def replicated(mesh: DeviceMesh) -> Tuple:
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in _names(mesh))


def _names(mesh: DeviceMesh) -> Sequence[str]:
    return mesh.mesh_dim_names or tuple(str(i) for i in range(mesh.ndim))


def _rank_main(fn, rank, world_size, init_method, device, backend, args,
               results):
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        dev = init_distributed(device, init_method=init_method,
                               world_size=world_size, rank=rank,
                               backend=backend)
        results.put((rank, True, fn(rank, dev, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, args: Sequence = (),
                device: str = "cuda", backend: Optional[str] = None,
                timeout: float = 600.0) -> List[Any]:
    """fn(rank, device, *args) in `world_size` new processes joined into
    one process group (`init_distributed`; `backend` as there); returns
    the ranks' results in rank order.  `fn` and `args` must pickle (a
    module-level function).  If a rank raises, or the ranks have not all
    returned within `timeout` seconds, every process is killed and
    RuntimeError raised with the failing rank's traceback."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world_size, init_method, device, backend, tuple(args),
            results)) for r in range(world_size)]
        for p in procs:
            p.start()
        got, failure = {}, None
        deadline = time.time() + timeout
        try:
            # drain the queue before joining: a writer blocks until read
            while len(got) < world_size and failure is None:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        failure = f"rank {dead[0]} exited with code " \
                                  f"{procs[dead[0]].exitcode}"
                    elif time.time() > deadline:
                        failure = (f"ranks {sorted(set(range(world_size)) - set(got))} "
                                   f"did not finish within {timeout:.0f} s")
                    continue
                if ok:
                    got[rank] = out
                else:
                    failure = f"rank {rank} raised:\n{out}"
        finally:
            for p in procs:
                p.join(timeout=30 if failure is None else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
        if failure is not None:
            raise RuntimeError(failure)
    return [got[r] for r in range(world_size)]
