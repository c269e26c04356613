"""GSPMD-style sharding of the unmodified train step.

Port of signnet_basisnet_tpu/parallel/gspmd.py.  The JAX module jits the
single-device `build_steps` step with input shardings that place the
GraphBatch's node and edge axes on the mesh and lets XLA's partitioner
insert the collectives.  The torch counterpart is DTensor: the same step on
a GraphBatch of DTensors placed by `graphbatch_shardings`, every parameter
and buffer replicated, DTensor's sharding rules inserting the
redistributions.

The port's own pieces under DTensor:

- Segment sums (graph/segment.py: `segment_sum`, `GraphBatch.in_degrees`)
  add a sharded source into a `Partial` zero accumulator with the
  out-of-place `aten.index_add` (an in-place op cannot change its
  output's placement), under the rule `register_rules` registers for it.
  It registers two more: segment max and min (`aten.scatter_reduce`
  amax/amin) into a `Partial` max or min, and a gather's backward (the
  accumulating `aten.index_put`, whose strategy on torch 2.11 expands a
  shard to the global shape) into a `Partial` sum.
- The random draws (nn/dropout.py: `Dropout`, models/pe.py: `sign_flip`)
  draw on the full shape from the model's own generator and place the draw
  as the input is placed, so the step draws the single-device step's bits,
  as JAX's partitionable PRNG does.
- The tile-local SpMM kernel K1 (ops/spmm_tiled.py), a custom call to
  XLA, runs as XLA runs one it cannot partition: on replicated operands
  (`on_replicated`, a `local_map`), launched on each rank's full tensors.
  The other kernel wrappers refuse a DTensor (TypeError).
- Gloo and CUDA tensors: torch 2.11's functional all-gather over a gloo
  group crashes on CUDA tensors (a segfault in `wait_tensor`; two ranks
  sharing one H100, where NCCL refuses them), though c10d's
  `all_gather_into_tensor` takes them, as do the functional all-reduce
  and reduce-scatter.  `register_rules` routes DTensor's all-gathers of
  CUDA tensors over a gloo mesh axis through c10d (`_all_gather_c10d`).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_module, distribute_tensor)

from ..graph.batch import GraphBatch

_RULES = []
# the functional all-gathers DTensor calls (torch 2.11 and 2.13 names)
_ALL_GATHERS = ("all_gather_tensor", "all_gather_single")


def _all_gather_c10d(tensor, gather_dim, group):
    """The functional all-gather's result (the shards of the mesh axis
    `group` = (mesh, dim) concatenated on `gather_dim`) through c10d's
    synchronous all_gather_into_tensor."""
    mesh, dim = group
    pg, n = mesh.get_group(dim), mesh.size(dim)
    x = tensor.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=pg)
    if gather_dim:
        out = torch.cat(out.chunk(n), dim=gather_dim)
    return out


def _route_gloo_cuda_all_gathers() -> None:
    """DTensor's all-gathers of CUDA tensors over a gloo mesh axis (the
    (mesh, dim) groups its redistributions name) through
    `_all_gather_c10d` (module docstring); every other call unchanged."""
    import torch.distributed._functional_collectives as funcol

    def routed(original):
        def all_gather(self, gather_dim, group, tag=""):
            if (self.is_cuda and isinstance(group, tuple)
                    and dist.get_backend(group[0].get_group(group[1]))
                    == "gloo"):
                return _all_gather_c10d(self, gather_dim, group)
            return original(self, gather_dim, group, tag)
        return all_gather

    for name in _ALL_GATHERS:
        if hasattr(funcol, name):
            setattr(funcol, name, routed(getattr(funcol, name)))


def register_rules() -> None:
    """Register the port's DTensor sharding rules and route gloo's CUDA
    all-gathers (once per process)."""
    if _RULES:
        return
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten
    _route_gloo_cuda_all_gathers()

    @register_sharding(aten.index_add.default)
    def index_add_rule(acc, dim, index, source, alpha=1):
        # out R <- acc R, index R, source R;
        # out P <- acc P, index S(dim), source S(dim): each rank adds its
        # rows into its share of the sum
        return [([Replicate()], [Replicate(), None, Replicate(),
                                 Replicate()]),
                ([Partial()], [Partial(), None, Shard(dim), Shard(dim)])]

    @register_sharding(aten.scatter_reduce.two)
    def scatter_reduce_rule(acc, dim, index, src, reduce,
                            include_self=True):
        # out R <- acc R, index R, src R;
        # amax/amin with acc included: out P(max/min) <- acc R, index
        # S(dim), src S(dim): each rank reduces its rows into acc, and a
        # max or min over ranks that share acc is the whole reduction
        rules = [([Replicate()], [Replicate(), None, Replicate(),
                                  Replicate(), None])]
        if reduce in ("amax", "amin") and include_self:
            rules.append(([Partial(reduce[1:])],
                          [Replicate(), None, Shard(dim), Shard(dim), None]))
        return rules

    @register_sharding(aten.index_put.default)
    def index_put_rule(acc, indices, values, accumulate=False):
        # (the backward of a gather x[idx], as of an embedding lookup)
        # out R <- acc R, indices R, values R;
        # accumulating by one index: out P <- acc P, index S(0), values
        # S(0): each rank adds its rows into its share of the sum
        repl = [Replicate()] * (len(indices) + 2)
        rules = [([Replicate()], repl + [None])]
        if accumulate and len(indices) == 1:
            rules.append(([Partial()], [Partial(), Shard(0), Shard(0),
                                        None]))
        return rules

    _RULES.extend([index_add_rule, scatter_reduce_rule, index_put_rule])


def graphbatch_shardings(mesh: DeviceMesh, gb: GraphBatch,
                         axis: str = "mp") -> GraphBatch:
    """The DTensor placements of each leaf of `gb`, as a GraphBatch of
    placement tuples (one entry per mesh axis): node- and edge-indexed
    tensors sharded on their leading axis over `axis`, where its length
    divides the axis size; every other leaf replicated."""
    n_nodes = gb.node_mask.shape[0]
    n_edges = gb.edge_mask.shape[0]
    names = mesh.mesh_dim_names
    size = mesh.size(names.index(axis))

    def spec_for(leaf):
        lead = leaf.shape[0] if leaf.dim() else None
        sharded = lead in (n_nodes, n_edges) and lead % size == 0
        return tuple(Shard(0) if sharded and name == axis else Replicate()
                     for name in names)

    return gb._map(spec_for)


def place_batch(gb: GraphBatch, mesh: DeviceMesh,
                specs: GraphBatch) -> GraphBatch:
    """`gb`, which every rank holds whole, as DTensors on `mesh` placed by
    `specs` (`graphbatch_shardings`): each rank keeps its own shard, with
    no communication."""
    def place(t, spec):
        return distribute_tensor(t, mesh, spec, src_data_rank=None)

    kw = {}
    for name, t in vars(gb).items():
        s = getattr(specs, name)
        if name == "extras":
            kw[name] = {k: place(v, s[k]) for k, v in t.items()}
        else:
            kw[name] = None if t is None else place(t, s)
    return GraphBatch(**kw)


def on_replicated(fn: Callable, mesh: DeviceMesh) -> Callable:
    """`fn` of plain tensors as a function of DTensors on `mesh`: every
    tensor argument gathered to `Replicate`, `fn` run on each rank's full
    local tensors, its one tensor result `Replicate`.  How XLA runs a
    custom call it cannot partition."""
    from torch.distributed.tensor.experimental import local_map
    repl = [Replicate()] * mesh.ndim

    def call(*args):
        in_placements = tuple(repl if isinstance(a, torch.Tensor) else None
                              for a in args)
        return local_map(fn, out_placements=repl,
                         in_placements=in_placements, device_mesh=mesh,
                         redistribute_inputs=True)(*args)

    return call


def _full(tree):
    """Metrics with each DTensor made a plain full tensor."""
    return {k: v.full_tensor() if isinstance(v, DTensor) else v
            for k, v in tree.items()}


def build_gspmd_steps(model, predict, optimizer, mesh: DeviceMesh,
                      example_gb: GraphBatch, axis: str = "mp",
                      loss_fn: Optional[Callable] = None):
    """(train_step(gb, lr) -> metrics, eval_step(gb, flip_rng=None) ->
    sums): `training.train.build_steps`' steps, unchanged, on `gb` placed
    over `mesh` by the shardings of `example_gb` (`graphbatch_shardings`,
    `place_batch`), as JAX fixes its input shardings from it.

    Every parameter and buffer of `model` is replicated over the mesh in
    place (`distribute_module`); `optimizer`, made over the model's
    parameters and not yet stepped, is pointed at the replicated ones.
    Each rank passes the whole batch; the metrics come back as plain full
    tensors."""
    from ..training.train import build_steps

    if optimizer.state:
        raise ValueError("build_gspmd_steps needs an optimizer that has not "
                         "stepped yet")
    register_rules()
    specs = graphbatch_shardings(mesh, example_gb, axis)
    before = dict(model.named_parameters())
    distribute_module(model, mesh)
    after = dict(model.named_parameters())
    by_id = {id(p): after[n] for n, p in before.items()}
    for group in optimizer.param_groups:
        group["params"] = [by_id[id(p)] for p in group["params"]]

    kwargs = {} if loss_fn is None else {"loss_fn": loss_fn}
    train_step, eval_step = build_steps(model, predict, optimizer, **kwargs)

    def train(gb, lr):
        return _full(train_step(place_batch(gb, mesh, specs), lr))

    def evaluate(gb, flip_rng=None):
        return _full(eval_step(place_batch(gb, mesh, specs), flip_rng))

    return train, evaluate
