"""Rank functions of the parallel tests (tests/test_torch_mp_halo.py,
tests/test_torch_parallel.py, tests/test_torch_train_step.py).

`signnet_basisnet_tpu_torch.parallel.mesh.spawn_ranks` runs them in fresh
processes, one a rank, over gloo; a spawned process imports this module to
find them, so it imports torch, numpy and the port only, never JAX.  Each
world runs all its cases in one start (`run_cases`) and returns every
rank's results, which the tests compare with the JAX package in the parent
process.  `single_step` is the parent's single-device step.
"""
import contextlib

import numpy as np
import torch
import torch.distributed as dist

from signnet_basisnet_tpu_torch import models as TM
from signnet_basisnet_tpu_torch import train_zinc
from signnet_basisnet_tpu_torch.bridge import load_flax_variables
from signnet_basisnet_tpu_torch.graph import from_arrays
from signnet_basisnet_tpu_torch.graph import segment as seg
from signnet_basisnet_tpu_torch.parallel import (
    build_dp_steps, build_gspmd_steps, build_mp_steps, device_arrays_mp,
    edge_sharded_aggregate, graphbatch_shardings, halo_edge_aggregate,
    make_mesh, partition_batch_mp, shard_arrays_mp, tile_aligned_aggregate)
from signnet_basisnet_tpu_torch.parallel.mp_halo import (
    _gb_of, mp_axis_ctx, mp_exchange, mp_neighbor_sum, mp_pool_nodes)
from signnet_basisnet_tpu_torch.training import (adam, build_steps,
                                                 load_config,
                                                 make_zinc_predict)

LR = 1e-3


@contextlib.contextmanager
def one_rank_shard(arrays, store_dir):
    """The batch as the one shard of a model-parallel world of this
    process alone (gloo, a file store in `store_dir`), under
    mp_axis_ctx: every sender is local and the exchange sends the halo
    block to this rank itself.  The group is destroyed on exit."""
    dist.init_process_group("gloo", init_method=f"file://{store_dir}/store",
                            world_size=1, rank=0)
    try:
        arrs = shard_arrays_mp(device_arrays_mp(
            partition_batch_mp(arrays, 1)), 0, "cpu")
        with mp_axis_ctx(dist.group.WORLD):
            yield _gb_of(arrs, arrs["repl"])
    finally:
        dist.destroy_process_group()


def edge_rows(t, shard):
    """Per-edge rows `t` of the batch padded to the one-rank shard's edge
    count (its edges are the batch's, in order, then padding)."""
    pad = shard.num_edges - t.shape[0]
    return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])


def run_cases(rank, dev, cases):
    """Every case of a world, in order: [CASES[kind](rank, dev, case)]."""
    return [CASES[c["kind"]](rank, dev, c) for c in cases]


def _np(t):
    return t.detach().cpu().numpy()


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def port_model(case, dev="cpu"):
    """The case's net, with the JAX init's weights where the case has
    them (else the port's seeded init)."""
    tm = TM.gnn_model(case["name"], **case["net"])
    if case.get("variables") is not None:
        load_flax_variables(tm, case["variables"])
    return tm.to(device=dev, dtype=case.get("dtype", torch.float32))


def kernel_launches():
    from signnet_basisnet_tpu_torch import ops
    return {"K1": ops.spmm_tiled.launches,
            "K2": ops.edge_softmax_attention_tiled.launches_fwd,
            "K3": ops.edge_softmax_attention_tiled.launches_bwd,
            "K4": ops.gatedgcn_gate_tiled.launches,
            "K5": ops.spmm_flat.launches}


def _record(tm, metrics, launches0=None):
    launches = kernel_launches()
    if launches0 is not None:
        launches = {k: v - launches0[k] for k, v in launches.items()}
    return {"loss": float(metrics["loss"]), "mae": float(metrics["mae"]),
            "launches": launches,
            "grads": {n: (np.zeros(p.shape) if p.grad is None
                          else _np(p.grad))
                      for n, p in tm.named_parameters()},
            "buffers": {n: _np(b) for n, b in tm.named_buffers()},
            "params": {n: _np(p) for n, p in tm.named_parameters()}}


def single_step(case, dev="cpu"):
    """One train step of the single-device port on the whole batch."""
    tm = port_model(case, dev)
    gb = from_arrays(case["arrays"]).to(dev).cast_floats(
        case.get("dtype", torch.float32))
    train, _ = build_steps(tm, make_zinc_predict(tm, case["lap_method"]),
                           adam(tm.parameters()))
    before = kernel_launches()
    return _record(tm, train(gb, LR), before)


def mp_step(rank, dev, case):
    """One train step and one eval step of `build_mp_steps` on this
    rank's shard of the batch."""
    dtype = case.get("dtype", torch.float32)
    tm = port_model(case, dev)
    parts = partition_batch_mp(case["arrays"], dist.get_world_size())
    arrs = _cast(shard_arrays_mp(device_arrays_mp(parts), rank, dev), dtype)
    train, ev = build_mp_steps(tm, make_zinc_predict(tm, case["lap_method"]),
                               adam(tm.parameters()))
    before = kernel_launches()
    out = _record(tm, train(arrs, LR), before)
    out["eval"] = {k: float(v) for k, v in ev(arrs).items()}
    out["halo"] = parts["halo"]
    return out


def exchange(rank, dev, case):
    """mp_exchange of this rank's rows of x by its row of the table."""
    mp = dist.get_world_size()
    x = torch.from_numpy(case["x"]).reshape(mp, -1, case["x"].shape[-1])
    send_idx = torch.from_numpy(case["send_idx"][rank])
    return _np(mp_exchange(x[rank], send_idx, dist.group.WORLD))


def neighbor_sum(rank, dev, case):
    """mp_neighbor_sum of this rank's shard (and its gradient from a
    fixed cotangent), over the partition of case['arrays']."""
    parts = partition_batch_mp(case["arrays"], dist.get_world_size())
    arrs = shard_arrays_mp(device_arrays_mp(parts), rank, dev)
    gb = _gb_of(arrs, arrs["repl"])
    shard_n = parts["shard_n"]
    x = torch.from_numpy(case["x"][rank * shard_n:(rank + 1) * shard_n])
    x.requires_grad_(True)
    ct = torch.from_numpy(case["ct"][rank * shard_n:(rank + 1) * shard_n])
    with mp_axis_ctx(dist.group.WORLD):
        out = mp_neighbor_sum(x, gb)
    (out * ct).sum().backward()
    return {"out": _np(out), "grad": _np(x.grad)}


def pool(rank, dev, case):
    """mp_pool_nodes sum, mean and max of this rank's node rows, and
    whether the max refuses a gradient."""
    parts = partition_batch_mp(case["arrays"], dist.get_world_size())
    arrs = shard_arrays_mp(device_arrays_mp(parts), rank, dev)
    gb = _gb_of(arrs, arrs["repl"])
    shard_n = parts["shard_n"]
    x = torch.from_numpy(case["x"][rank * shard_n:(rank + 1) * shard_n])
    out = {}
    with mp_axis_ctx(dist.group.WORLD):
        for reduce in ("sum", "mean", "max"):
            out[reduce] = _np(mp_pool_nodes(x, gb, reduce))
        try:
            mp_pool_nodes(x.clone().requires_grad_(True), gb, "max")
            out["max_grad"] = "ran"
        except NotImplementedError as e:
            out["max_grad"] = str(e)
    return out


def dp_step(rank, dev, case):
    """An eval step, then a train step of `build_dp_steps`, over this
    rank's microbatches case['micro'][rank]."""
    seg.set_agg_backend(case.get("backend", "xla"))
    tm = port_model(case, dev)
    stack = [from_arrays(a).to(dev) for a in case["micro"][rank]]
    train, ev = build_dp_steps(tm, make_zinc_predict(tm, case["lap_method"]),
                               adam(tm.parameters()))
    sums = {k: float(v) for k, v in ev(stack).items()}
    before = kernel_launches()
    out = _record(tm, train(stack, LR, 0), before)
    seg.set_agg_backend("xla")
    out["eval"] = sums
    return out


def mesh_shapes(rank, dev, case):
    mesh = make_mesh(dp=4, mp=2, device_type="cpu")
    out = {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
           "groups": [dist.get_world_size(mesh.get_group(a))
                      for a in ("dp", "mp")]}
    try:
        make_mesh(dp=3, mp=2, device_type="cpu")
    except ValueError as e:
        out["refused"] = str(e)
    return out


def edge_sharded(rank, dev, case):
    """edge_sharded_aggregate over this rank's slice of the edges."""
    world = dist.get_world_size()
    e = len(case["senders"]) // world
    sl = slice(rank * e, (rank + 1) * e)
    t = {k: torch.from_numpy(case[k][sl])
         for k in ("senders", "receivers", "edge_mask")}
    out = edge_sharded_aggregate()(torch.from_numpy(case["x"]), t["senders"],
                                   t["receivers"], t["edge_mask"],
                                   case["x"].shape[0])
    return _np(out)


def dst_partitioned(rank, dev, case):
    """halo_edge_aggregate (and, on tile-local edges,
    tile_aligned_aggregate) of this rank's node shard, with the gradient
    of the halo form from a fixed cotangent."""
    world = dist.get_world_size()
    x = torch.from_numpy(case["x"]).reshape(world, -1, case["x"].shape[-1])
    xs = x[rank].clone().requires_grad_(True)
    t = {k: torch.from_numpy(case["shards"][k][rank])
         for k in ("senders", "receivers", "edge_mask")}
    args = (t["senders"], t["receivers"], t["edge_mask"])
    halo = halo_edge_aggregate()(xs, *args)
    ct = torch.from_numpy(case["ct"]).reshape(x.shape)[rank]
    (halo * ct).sum().backward()
    out = {"halo": _np(halo), "grad": _np(xs.grad)}
    if case["tile_local"]:
        out["tile"] = _np(tile_aligned_aggregate()(x[rank], *args))
    return out


def gspmd(rank, dev, case):
    """graphbatch_shardings over a 1-D mesh of the world, the refusal of
    build_gspmd_steps, and what DTensor makes of the in-place index_add_
    of a replicated [40, 12, 12] accumulator (the op that blocks it)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = init_device_mesh("cpu", (dist.get_world_size(),),
                            mesh_dim_names=("mp",))
    gb = from_arrays(case["arrays"])
    specs = graphbatch_shardings(mesh, gb, "mp").tensors()
    out = {"sharded": {k: v == (Shard(0),) for k, v in specs.items()},
           "replicated": {k: v == (Replicate(),) for k, v in specs.items()}}
    try:
        build_gspmd_steps(None, None, None, mesh, gb)
    except NotImplementedError as e:
        out["refused"] = str(e)
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 40, (160,), generator=g)
    src = torch.randn(160, 12, 12, generator=g)
    acc = distribute_tensor(torch.zeros(40, 12, 12), mesh, [Replicate()])
    try:
        res = acc.index_add_(0, distribute_tensor(idx, mesh, [Shard(0)]),
                             distribute_tensor(src, mesh, [Shard(0)]))
        local = tuple(res.to_local().shape)
        out["index_add_"] = (f"placements {res.placements}, local {local}"
                             + ("" if local == _local_shape(res)
                                else " (inconsistent)"))
    except RuntimeError as e:
        out["index_add_"] = "raised: " + str(e)
    return out


def _local_shape(dt):
    """The local shape a DTensor's placements imply on a 1-D mesh whose
    size divides every sharded axis."""
    shape = list(dt.shape)
    for p in dt.placements:
        if p.is_shard():
            shape[p.dim] //= dt.device_mesh.size()
    return tuple(shape)


def train_zinc_mp(rank, dev, case):
    """train_zinc.run with train.mp = world size on the CPU."""
    cfg = load_config(case["config"], case["overrides"])
    logs = []
    res = train_zinc.run(cfg, device="cpu", log=logs.append)
    return {"val_mae": res.val_mae, "test_mae": res.test_mae,
            "history": res.history, "logs": logs}


CASES = {"mp_step": mp_step, "exchange": exchange,
         "neighbor_sum": neighbor_sum, "pool": pool, "dp_step": dp_step,
         "mesh": mesh_shapes, "edge_sharded": edge_sharded,
         "dst_partitioned": dst_partitioned, "gspmd": gspmd,
         "train_zinc": train_zinc_mp}
