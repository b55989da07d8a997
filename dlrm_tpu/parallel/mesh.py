"""Device-mesh construction and sharding helpers.

The reference has no distributed layer (single-process shared memory,
SURVEY.md §2.4); here the mesh is a first-class component.  Default topology
for DLRM is a 1-D mesh whose single axis serves double duty — batch
data-parallelism for the MLPs AND model-parallel table sharding for the
embeddings (the classic hybrid).

Multi-host has two shapes:
  * a 1-D mesh spanning every device of every process (the all-to-all
    crosses hosts) — ``init_distributed`` + ``make_mesh``;
  * a 2-D hybrid ``(h, d)`` mesh: tables shard over the intra-host axis
    ``d`` only (named ``ici`` in flags and comments: the cards of one host,
    NVLink-joined), batch data-parallelism spans both axes, and the sparse
    updates are all-gathered over the inter-host axis ``h`` (named ``dcn``)
    in compressed (ids, grad-rows) form so the tables stay replicated
    across hosts without a dense-table psum (parallel/embedding._dcn_fold).
    Every sharded entry point (train steps, block step, adagrad, eval)
    detects the extra axis via ``dcn_axis_of`` and routes automatically.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dlrm_tpu.config import DLRMConfig
from dlrm_tpu.parallel.placement import TablePlacement, plan_placement


def make_mesh(n_devices: Optional[int] = None, axis: str = "d") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only {len(devs)} "
                f"device(s) are visible on platform "
                f"'{devs[0].platform}'; for a virtual CPU mesh set "
                "jax.config.update('jax_platforms', 'cpu') and "
                "XLA_FLAGS=--xla_force_host_platform_device_count=N")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize multi-process JAX — call once per process before any
    device use.  No-ops when already initialized or single-process.

    A GPU cluster gives no topology to discover, so pass all three
    arguments: the coordinator's ``host:port`` (process 0's address), the
    number of processes and this process's id.  The CPU-backend
    integration tests bring up the same way, with cross-process
    collectives over gloo (jax's default CPU collectives).  After this,
    ``jax.devices()`` spans every process and :func:`make_mesh` /
    :func:`make_hybrid_mesh` build global meshes.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except RuntimeError as e:  # already initialized
        if "already initialized" not in str(e).lower():
            raise


def is_lead_process() -> bool:
    """True on the process that owns logging / metadata writes (orbax
    checkpoint WRITES stay collective — every process saves its addressable
    shards — but stdout/run_meta.json belong to exactly one)."""
    return jax.process_index() == 0


def local_batch_rows(sharding: NamedSharding, global_batch: int,
                     dim: int = 0) -> "tuple[int, int]":
    """The contiguous ``[lo, hi)`` range of global batch rows this process
    must feed for a batch sharded by ``sharding`` along ``dim``.

    Multi-host feeding contract: each process materializes ONLY its
    addressable slice of the global batch host-side and assembles the
    global array with ``jax.make_array_from_process_local_data``.  This
    helper derives the slice from the sharding's own index map (never from
    an assumed device order), and rejects non-contiguous layouts — the
    1-D and (dcn, ici) hybrid meshes both stripe the batch contiguously
    per process because ``jax.devices()`` is process-major.
    """
    shape = [1] * (dim + 1)
    shape[dim] = global_batch
    spans = set()
    for dev, idx in sharding.addressable_devices_indices_map(
            tuple(shape)).items():
        sl = idx[dim]
        spans.add((sl.start or 0,
                   global_batch if sl.stop is None else sl.stop))
    los = [s[0] for s in spans]
    his = [s[1] for s in spans]
    lo, hi = min(los), max(his)
    covered = sorted(spans)
    pos = lo
    for s, e in covered:  # contiguity: no gap between addressable spans
        if s > pos:
            raise ValueError(
                f"non-contiguous process-local batch rows {covered}; "
                "multi-host feeding needs a process-contiguous batch "
                "sharding (devices process-major along the batch axes)")
        pos = max(pos, e)
    return lo, hi


# NOTE on parameter placement under multi-process: jax.device_put(host_tree,
# global_shardings) is multi-process-correct as long as every process holds
# the SAME host value (deterministic seeded init / checkpoint restore) —
# each process materializes only its addressable shards, no communication.
# Verified on the 2-process gloo CPU mesh; no make_array_from_callback
# wrapper is needed.


def make_hybrid_mesh(ici_axis: str = "d", dcn_axis: str = "h") -> Mesh:
    """2-D mesh for multi-host: the fast intra-host dimension (``ici_axis``:
    the cards of one host, joined all to all by NVLink) x the network
    dimension across hosts (``dcn_axis``).

    Built with ``mesh_utils.create_hybrid_device_mesh`` with the process as
    the granule, so each row of the mesh is one host's cards — collectives
    along ``ici_axis`` stay on NVLink, and only the (rare) cross-host
    traffic touches the network.  The DLRM hybrid maps batch
    data-parallelism over BOTH axes and table-model-parallelism over
    ``ici_axis`` only (the all-to-all embedding exchange stays inside a
    host, SURVEY.md §2.4 mapping).
    """
    from jax.experimental import mesh_utils

    devs = jax.devices()
    # the granule is the PROCESS: one host's cards share the fast links
    # (NVLink), and what joins processes is the slower network
    n_granules = max(len({d.process_index for d in devs}), 1)
    per_granule = len(devs) // n_granules
    devices = mesh_utils.create_hybrid_device_mesh(
        mesh_shape=(per_granule,), dcn_mesh_shape=(n_granules,),
        devices=devs, process_is_granule=True)
    return Mesh(devices.reshape(n_granules, per_granule),
                (dcn_axis, ici_axis))


def make_mesh_2d(dcn: int, ici: int, dcn_axis: str = "h",
                 ici_axis: str = "d") -> Mesh:
    """Explicit (dcn, ici)-shaped 2-D mesh over the first dcn*ici devices.
    For real clusters prefer :func:`make_hybrid_mesh` (host-aware device
    order); this builder serves virtual CPU meshes and tests where device
    order is synthetic anyway."""
    devs = jax.devices()
    if len(devs) < dcn * ici:
        raise ValueError(f"requested a {dcn}x{ici} mesh but only "
                         f"{len(devs)} device(s) are visible")
    return Mesh(np.asarray(devs[:dcn * ici]).reshape(dcn, ici),
                (dcn_axis, ici_axis))


def dcn_axis_of(mesh: Mesh, axis: str = "d") -> Optional[str]:
    """The mesh's data-only (DCN) axis name, or None on a 1-D mesh.  The
    convention throughout: ``axis`` is the table-sharding/ICI axis; any
    OTHER mesh axis carries pure batch data-parallelism (tables replicated
    over it, updates all-gathered over it)."""
    others = [a for a in mesh.axis_names if a != axis]
    if not others:
        return None
    if len(others) > 1:
        raise ValueError(f"mesh has axes {mesh.axis_names}; expected at "
                         f"most one besides the table axis {axis!r}")
    return others[0]


def batch_sharding(mesh: Mesh, axis: str = "d") -> NamedSharding:
    """Batch-dim sharding: over ``axis`` on a 1-D mesh, over EVERY mesh
    axis (dcn-major) on a hybrid mesh — batch data-parallelism spans the
    full device set while the tables span only ``axis``."""
    if len(mesh.axis_names) > 1:
        return NamedSharding(mesh, P(tuple(mesh.axis_names)))
    return NamedSharding(mesh, P(axis))


def block_batch_sharding(mesh: Mesh, axis: str = "d") -> NamedSharding:
    """(K, B, ...) stacked-block batches: micro-step dim replicated, batch
    dim sharded like :func:`batch_sharding`."""
    if len(mesh.axis_names) > 1:
        return NamedSharding(mesh, P(None, tuple(mesh.axis_names)))
    return NamedSharding(mesh, P(None, axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def param_shardings(mesh: Mesh, params: dict, axis: str = "d") -> dict:
    """Sharding pytree for the parameter pytree: MLPs replicated (they are
    small; data-parallel), sharded embedding stack (N, R, D) split on axis."""
    shard = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    out = {
        "bottom": jax.tree.map(lambda _: repl, params["bottom"]),
        "emb": shard,
        "top": jax.tree.map(lambda _: repl, params["top"]),
    }
    if "emb_cs" in params:  # column-sharded per-table (N, R, D/N) leaves
        out["emb_cs"] = tuple(shard for _ in params["emb_cs"])
    if "emb_h" in params:  # host-resident row-sharded stack
        out["emb_h"] = NamedSharding(mesh, P(axis),
                                     memory_kind="pinned_host")
    return out
