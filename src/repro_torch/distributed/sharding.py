"""Coadd mesh residency: which flat slab of a layout each rank holds.

Counterpart of the coadd half of ``repro.distributed.sharding``.  The
reference shards an image-major (M, ...) layout over a JAX device mesh with
``NamedSharding(mesh, P(shard_axes))`` and runs one program on every device
under ``shard_map``.  Here the mesh is a ``torch.distributed`` `DeviceMesh`
and the program is SPMD over its process group: every rank runs the same
job (`CoaddEngine.run_distributed`), and its body, the part the reference
hands to ``shard_map``, maps this rank's slab only.  So ``shard_map_compat``
has no counterpart, and `image_axis_slab` replaces `image_axis_sharding`:
it names the contiguous slab ``[s*L, (s+1)*L)`` that the sharding puts on
this rank's device.

The LM's sharding rules of the reference module are not part of this port.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.core.plan import scan_budget


def mesh_shape(mesh) -> Dict[str, int]:
    """{dimension name: size} of a named `DeviceMesh` (``mesh.shape`` of a JAX
    mesh)."""
    names = mesh.mesh_dim_names
    if not names:
        raise ValueError("the mesh needs mesh_dim_names")
    return dict(zip(names, (int(n) for n in mesh.mesh.shape)))


def shard_count(mesh, axes: Sequence[str]) -> int:
    """Total number of shards over the given mesh axes."""
    shape = mesh_shape(mesh)
    return int(np.prod([shape[a] for a in axes])) if axes else 1


def shard_index(mesh, axes: Sequence[str]) -> int:
    """This rank's shard over ``axes``: its mesh coordinates taken row-major
    over the named axes in their order, the order in which
    ``NamedSharding(mesh, P(tuple(axes)))`` splits axis 0 over a tuple of
    axes.  A mesh axis not among ``axes`` replicates the slab."""
    shape = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    s = 0
    for a in axes:
        s = s * shape[a] + int(coord[a])
    return s


def image_axis_slab(mesh, shard_axes: Sequence[str], n_flat: int) -> Tuple[int, int]:
    """[start, stop) of this rank's slab of an image-major axis of
    ``n_flat`` entries split over ``shard_axes``: the rows the reference's
    `image_axis_sharding` puts on this rank's device.  ``n_flat`` must
    divide by the shard count."""
    n = shard_count(mesh, shard_axes)
    if n_flat % n:
        raise ValueError(f"shard count {n} must divide flat length {n_flat}")
    local = n_flat // n
    s = shard_index(mesh, shard_axes)
    return s * local, (s + 1) * local


def shard_local_compaction(
    union_gate: np.ndarray, n_shards: int
) -> Tuple[np.ndarray, np.ndarray, int, np.ndarray]:
    """Per-shard gather indices for a job's union flat gate (DESIGN.md §5).

    ``union_gate`` is the (M,) OR of every query's flat slot gate; shard
    ``s`` holds the contiguous slab ``[s*L, (s+1)*L)`` with
    ``L = M // n_shards``.  Each shard maps only the slab entries some query
    selected, so this derives, per shard, the *local* indices of its gated
    slots, padded to one shared shape (`plan.scan_budget` bucket of the
    worst shard's count), and each shard's OWN bucketed budget: the executor
    picks one power-of-two tile size dividing the shared budget and maps
    ``ceil(own_budget / tile)`` tiles per shard, so quiet shards stop paying
    the busiest shard's work.

    Returns ``(local_idx (S, G) int32, pad_mask (S, G) bool, G,
    budgets (S,) int32)`` with ``G == budgets.max()``; padding entries
    point at local slot 0 and are masked False in the compacted per-query
    gates, the same duplicate-then-mask discipline as `plan.compact_gate`.
    """
    m = union_gate.shape[0]
    if m % n_shards:
        raise ValueError(
            f"shard count {n_shards} must divide flat length {m}"
        )
    local_len = m // n_shards
    per_shard = union_gate.reshape(n_shards, local_len)
    counts = per_shard.sum(axis=1)
    budgets = np.array(
        [scan_budget(int(c), local_len) for c in counts], np.int32
    )
    budget = int(budgets.max())
    local_idx = np.zeros((n_shards, budget), np.int32)
    pad_mask = np.zeros((n_shards, budget), bool)
    for s in range(n_shards):
        nz = np.nonzero(per_shard[s])[0][:budget]
        local_idx[s, : len(nz)] = nz
        pad_mask[s, : len(nz)] = True
    return local_idx, pad_mask, budget, budgets
