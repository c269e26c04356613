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
from signnet_basisnet_tpu_torch.parallel.gspmd import (place_batch,
                                                       register_rules)
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
    """graphbatch_shardings over a 1-D mesh of the world, and this rank's
    shard of each leaf of the batch that place_batch placed by them."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    mesh = init_device_mesh("cpu", (dist.get_world_size(),),
                            mesh_dim_names=("mp",))
    gb = from_arrays(case["arrays"])
    specs = graphbatch_shardings(mesh, gb, "mp")
    placed = place_batch(gb, mesh, specs).tensors()
    specs = specs.tensors()
    return {"sharded": {k: v == (Shard(0),) for k, v in specs.items()},
            "replicated": {k: v == (Replicate(),) for k, v in specs.items()},
            "local": {k: _np(v.to_local()) for k, v in placed.items()}}


def _mesh(world):
    """The ("dp", "mp") mesh of JAX's GSPMD test: dp 1, mp the world."""
    return make_mesh(dp=1, mp=world, device_type="cpu")


def gspmd_rules(rank, dev, case):
    """The port's DTensor pieces against plain torch on the same inputs:
    the registered rules (segment sums of sharded rows into a Partial
    accumulator and of replicated ones, segment max and min of sharded
    rows, a gather by sharded ids) forward and gradient, in_degrees; the
    dropout mask and the sign flips drawn under DTensor; the all-gather
    through c10d against the functional one; and each kernel wrapper
    handed a DTensor outside on_replicated."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from signnet_basisnet_tpu_torch import ops
    from signnet_basisnet_tpu_torch.models.pe import sign_flip
    from signnet_basisnet_tpu_torch.parallel.gspmd import _all_gather_c10d
    from signnet_basisnet_tpu_torch.nn.dropout import Dropout, DropoutRNG
    register_rules()
    mesh = _mesh(dist.get_world_size())
    shard, repl = (Replicate(), Shard(0)), (Replicate(), Replicate())
    place = lambda t, p: DTensor.from_local(
        t.chunk(dist.get_world_size())[rank] if p == shard else t, mesh, p)
    out = {}
    x = torch.from_numpy(case["x"]).double()
    ids = torch.from_numpy(case["ids"])
    ct = torch.from_numpy(case["ct"]).double()
    for name, op, p in (("sum sharded", seg.segment_sum, shard),
                        ("sum replicated", seg.segment_sum, repl),
                        ("max sharded", seg.segment_max, shard),
                        ("min sharded", seg.segment_min, shard)):
        xd = place(x, p).requires_grad_(True)
        xp = x.clone().requires_grad_(True)
        got = op(xd, place(ids, p), case["segments"])
        want = op(xp, ids, case["segments"])
        (got * place(ct, repl)).sum().backward()
        (want * ct).sum().backward()
        out[name] = {"partial": [q.is_partial() for q in got.placements],
                     "got": _np(got.full_tensor()), "want": _np(want),
                     "grad": _np(xd.grad.full_tensor()),
                     "grad_want": _np(xp.grad)}
    # a gather of replicated rows by sharded ids (an embedding lookup),
    # whose backward is the accumulating index_put
    wd, wp = (place(ct, repl).requires_grad_(True),
              ct.clone().requires_grad_(True))
    got, want = wd[place(ids, shard)], wp[ids]
    (got * place(x, shard)).sum().backward()
    (want * x).sum().backward()
    out["gather sharded"] = {"got": _np(got.full_tensor()),
                             "want": _np(want),
                             "grad": _np(wd.grad.full_tensor()),
                             "grad_want": _np(wp.grad)}
    gb = from_arrays(case["arrays"])
    placed = place_batch(gb, mesh, graphbatch_shardings(mesh, gb, "mp"))
    out["in_degrees"] = (_np(placed.in_degrees().full_tensor()),
                         _np(gb.in_degrees()))
    drop = Dropout(0.5, DropoutRNG(7))
    x2 = torch.from_numpy(case["x"])
    out["dropout"] = (_np(drop(place(x2, shard)).full_tensor()),
                      _np(Dropout(0.5, DropoutRNG(7))(x2)))
    pe = torch.from_numpy(case["pe"])
    out["sign_flip"] = (_np(sign_flip(place(pe, shard),
                                      DropoutRNG(5)).full_tensor()),
                        _np(sign_flip(pe, DropoutRNG(5))))
    shard_x = torch.from_numpy(case["x"]).reshape(
        dist.get_world_size(), 4, -1)[rank]
    out["all_gather"] = {
        dim: (_np(_all_gather_c10d(shard_x, dim, (mesh, 1))),
              _np(funcol.wait_tensor(funcol.all_gather_tensor(
                  shard_x, dim, (mesh, 1))))) for dim in (0, 1)}
    t = from_arrays(case["tiled"])
    n, e = t.num_nodes, t.num_edges
    csr = tuple(t.extras[k] for k in ("dst_ptr", "src_order", "src_ptr"))
    st, en = t.extras["tile_starts"], t.extras["tile_ends"]
    bn = n // st.shape[0]
    xs = place(torch.ones(n, 8), shard)
    ee = place(torch.ones(e, 2, 4), shard)
    q = place(torch.ones(n, 2, 4), shard)
    calls = {
        "spmm_tiled": lambda: ops.spmm_tiled(
            xs, t.senders, t.receivers, t.edge_mask, st, en, n, bn, csr),
        "spmm_flat": lambda: ops.spmm_flat(
            xs, t.senders, t.receivers, t.edge_mask, st, en, n, bn),
        "gatedgcn_gate_tiled": lambda: ops.gatedgcn_gate_tiled(
            xs, xs, xs, place(torch.ones(e, 8), shard), t.senders,
            t.receivers, t.edge_mask, st, en, n, bn, csr),
        "edge_softmax_attention_tiled": lambda: (
            ops.edge_softmax_attention_tiled(
                q, q, q, ee, t.senders, t.receivers, t.edge_mask, st, en,
                bn, csr))}
    out["refused"] = {}
    for name, call in calls.items():
        try:
            call()
            out["refused"][name] = "ran"
        except TypeError as err:
            out["refused"][name] = str(err)
    return out


def _adam_state(opt, tm):
    """exp_avg and exp_avg_sq of each parameter, by name, full."""
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    return {f"{n}.{k}": _np(full(opt.state[p][k]))
            for n, p in tm.named_parameters() if p in opt.state
            for k in ("exp_avg", "exp_avg_sq")}


def _gspmd_record(tm, opt, ev, metrics):
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    return {"loss": float(metrics["loss"]), "mae": float(metrics["mae"]),
            "eval": {k: float(v) for k, v in ev.items()},
            "grads": {n: _np(full(p.grad)) for n, p in tm.named_parameters()
                      if p.grad is not None},
            "buffers": {n: _np(full(b)) for n, b in tm.named_buffers()},
            "adam": _adam_state(opt, tm)}


def gspmd_step(rank, dev, case):
    """The SignNetGNN of JAX's GSPMD test (seeded init, or the case's
    bridged weights), an eval step then a train step, in each of the
    case's dtypes: the single-device steps on the whole batch and
    build_gspmd_steps' over the world (dp 1, mp the world), with the
    case's attention dropout."""
    from signnet_basisnet_tpu_torch.training import make_module_predict
    out = {}
    for name in case["dtypes"]:
        dtype = getattr(torch, name)
        gb = from_arrays(case["arrays"]).cast_floats(dtype)
        for how in ("single", "gspmd"):
            tm = TM.SignNetGNN(12, 1, 2, 2, 1)
            if case.get("variables") is not None:
                load_flax_variables(tm, case["variables"])
            TM.set_attention_dropout(tm, case["attention_dropout"])
            tm = tm.to(dtype)
            opt = adam(tm.parameters())
            if how == "single":
                train, ev = build_steps(tm, make_module_predict(tm), opt)
            else:
                train, ev = build_gspmd_steps(
                    tm, make_module_predict(tm), opt,
                    _mesh(dist.get_world_size()), gb)
            sums = ev(gb)
            out[f"{how}_{name}"] = _gspmd_record(tm, opt, sums,
                                                 train(gb, LR))
    return out


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
         "gspmd_rules": gspmd_rules, "gspmd_step": gspmd_step,
         "train_zinc": train_zinc_mp}
