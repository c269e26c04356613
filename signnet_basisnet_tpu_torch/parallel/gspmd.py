"""GSPMD-style sharding of the unmodified train step.

Port of signnet_basisnet_tpu/parallel/gspmd.py.  The JAX module jits the
single-device `build_steps` step with input shardings that place the
GraphBatch's node and edge axes on the mesh and lets XLA's partitioner
insert the collectives.  The torch counterpart is DTensor: the same step on
a GraphBatch of DTensors placed by `graphbatch_shardings`, parameters
replicated, DTensor's sharding rules inserting the redistributions.

`graphbatch_shardings` is ported.  `build_gspmd_steps` refuses
(ROADMAP.md item 26): the port's segment sums are
`new_zeros(...).index_add_(...)`, and DTensor has no usable rule for the
in-place `aten.index_add_`.  Torch 2.11 registers no sharding strategy
for it; torch 2.13's picks an output placement (Shard on the feature
axis) that the replicated accumulator cannot take in place: a [N, 12, 12]
sum leaves a DTensor whose placement says Shard(1) over full local rows
(or raises "narrow unexpectedly changed concrete size"), so inside the
net the next op gathers twice the features.  With the out-of-place
`index_add` the forward matches the single-device one but the gradient of
a masked BatchNorm bias in the SignNet phi does not (0.28 apart against a
largest of 0.20, torch 2.13), so the step is not run on DTensors.
"""
from __future__ import annotations

from typing import Optional

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..graph.batch import GraphBatch


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


def build_gspmd_steps(model, predict, optimizer, mesh: DeviceMesh,
                      example_gb: GraphBatch, axis: str = "mp",
                      loss_fn: Optional[object] = None):
    """The single-device steps on DTensor batches over `mesh`: refused,
    see the module docstring."""
    raise NotImplementedError(
        "build_gspmd_steps: DTensor has no usable rule for the in-place "
        "aten.index_add_ of the port's segment sums (none registered on "
        "torch 2.11; on 2.13 a Shard(1) output that the replicated "
        "accumulator cannot take in place), and with the out-of-place "
        "index_add a masked BatchNorm bias gradient is wrong (ROADMAP.md "
        "item 26); use build_mp_steps or build_dp_steps")
