"""Model-parallel embedding lookup & update over a device mesh.

The classic DLRM hybrid (SURVEY.md §2.4/P2): embedding tables are sharded
across devices (each owns whole tables, placed by ``plan_placement``) while
the batch is data-parallel over the SAME devices.  The lookup is a
``shard_map`` with explicit collectives (NVLink between one host's cards):

    ids (B/N, T)  ──all_gather──►  ids (B, T)  [ints: cheap]
    local gather of owned tables ──► pooled (B, K, D)   [K = slots/shard]
    ──all_to_all (batch-split / slot-concat)──► (B/N, N·K, D)
    static column permutation ──► pooled (B/N, T, D)    [batch-sharded]

and the sparse SGD update routes gradients back with the inverse
``all_to_all`` and applies them with a local scatter-add — embedding
gradients are never densified and never psum'd (the key DLRM win: per-device
comm volume is B·T·D/N instead of the full B·T·D of a data-parallel psum).

The reference's counterpart is shared-memory: EmbeddingTables.jl lookup
strategies + multithreaded compressed update (train.jl:283-290).  There, the
"exchange" was cache coherence; here it is an explicit all-to-all.

Static-shape discipline: device-dependent metadata (slot→table map, local
row offsets, validity mask) enters the shard_map as (N, K) arrays sharded on
the same axis, so the traced program is SPMD-uniform.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dlrm_tpu.config import DLRMConfig
from dlrm_tpu.parallel.placement import TablePlacement


# -- host-side shard/unshard ---------------------------------------------------

def shard_tables(stacked: np.ndarray, placement: TablePlacement,
                 config: DLRMConfig) -> np.ndarray:
    """Re-layout the stacked table into (N, local_rows, D) per-shard stacks
    (trash row zeroed).  Accepts either storage layout — a lane-packed
    (packed_total_rows, 128) stack is unpacked first (the sharded engine
    currently uses the logical layout internally)."""
    from dlrm_tpu.ops import embedding as emb_ops

    if isinstance(stacked, (tuple, list)):
        stacked = emb_ops.unpack_tables(
            tuple(np.asarray(c) for c in stacked), config)
    stacked = np.asarray(stacked)
    n, r = placement.num_shards, placement.local_rows
    p = placement.pack
    d = stacked.shape[1]
    out = np.zeros((n, r, d * p), dtype=stacked.dtype)

    def fill(shard, lo, tab, prows):
        pad = prows * p - len(tab)
        if pad:
            tab = np.concatenate([tab, np.zeros((pad, d), tab.dtype)])
        out[shard, lo:lo + prows] = tab.reshape(prows, d * p)

    for t in placement.slot_table_list:
        rows = placement.table_sizes[t]
        fill(placement.table_shard[t], placement.table_local_offsets[t],
             stacked[config.table_offsets[t]:
                     config.table_offsets[t] + rows], -(-rows // p))
    for k, t in enumerate(placement.row_sharded):
        if placement.rs_host and placement.rs_host[k]:
            continue  # lives in the host stack (shard_host_tables)
        rows = placement.table_sizes[t]
        chunk = placement.rs_rows_per_shard[k]
        go = config.table_offsets[t]
        for shard in range(n):
            blk = stacked[go + shard * chunk:
                          go + min((shard + 1) * chunk, rows)]
            if len(blk):
                fill(shard, placement.rs_local_offsets[k], blk, chunk // p)
    return out


def shard_host_tables(stacked, placement: TablePlacement,
                      config: DLRMConfig) -> np.ndarray:
    """Per-shard host stack (N, host_local_rows, W) for the host-resident
    row-sharded tables (placement.rs_host).  Place with
    NamedSharding(mesh, P(axis), memory_kind='pinned_host')."""
    from dlrm_tpu.ops import embedding as emb_ops

    if isinstance(stacked, (tuple, list)):
        stacked = emb_ops.unpack_tables(
            tuple(np.asarray(c) for c in stacked), config)
    stacked = np.asarray(stacked)
    n, p = placement.num_shards, placement.pack
    d = stacked.shape[1]
    out = np.zeros((n, placement.host_local_rows, d * p),
                   dtype=stacked.dtype)
    for k, t in enumerate(placement.row_sharded):
        if not placement.rs_host[k]:
            continue
        rows = placement.table_sizes[t]
        chunk = placement.rs_rows_per_shard[k]
        lo = placement.rs_local_offsets[k]
        go = config.table_offsets[t]
        for shard in range(n):
            blk = stacked[go + shard * chunk:
                          go + min((shard + 1) * chunk, rows)]
            if len(blk):
                pad = chunk - len(blk)
                if pad:
                    blk = np.concatenate(
                        [blk, np.zeros((pad, d), blk.dtype)])
                out[shard, lo:lo + chunk // p] = blk.reshape(
                    chunk // p, d * p)
    return out


def unshard_tables(sharded: np.ndarray, placement: TablePlacement,
                   config: DLRMConfig, host=None) -> np.ndarray:
    """Inverse of :func:`shard_tables` (returns the logical (R, D) stack).
    ``host``: the (N, host_local_rows, W) host stack when the placement has
    host-resident row-sharded tables (their rows stay zero if omitted)."""
    sharded = np.asarray(sharded)
    total = sum(placement.table_sizes)
    p = placement.pack
    d = sharded.shape[-1] // p
    out = np.zeros((total, d), dtype=sharded.dtype)
    for t in placement.slot_table_list:
        rows = placement.table_sizes[t]
        shard = placement.table_shard[t]
        lo = placement.table_local_offsets[t]
        go = config.table_offsets[t]
        prows = -(-rows // p)
        out[go:go + rows] = sharded[shard, lo:lo + prows].reshape(
            prows * p, d)[:rows]
    for k, t in enumerate(placement.row_sharded):
        src = sharded
        if placement.rs_host and placement.rs_host[k]:
            if host is None:
                continue  # caller merges the host stack separately
            src = np.asarray(host)
        rows = placement.table_sizes[t]
        chunk = placement.rs_rows_per_shard[k]
        lo = placement.rs_local_offsets[k]
        go = config.table_offsets[t]
        for shard in range(placement.num_shards):
            start = shard * chunk
            n_rows = min(chunk, rows - start)
            if n_rows <= 0:
                break
            out[go + start:go + start + n_rows] = src[
                shard, lo:lo + chunk // p].reshape(chunk, d)[:n_rows]
    return out


def shard_col_tables(stacked, placement: TablePlacement,
                     config: DLRMConfig):
    """Column-sharded tables: (R, D) -> tuple of (N, R, D/N) arrays (one
    per table in placement.col_sharded order), each to be placed with
    P(axis) on dim 0.  Accepts either storage layout for ``stacked``."""
    from dlrm_tpu.ops import embedding as emb_ops

    if isinstance(stacked, (tuple, list)):
        stacked = emb_ops.unpack_tables(
            tuple(np.asarray(c) for c in stacked), config)
    stacked = np.asarray(stacked)
    n = placement.num_shards
    d = stacked.shape[1]
    assert d % n == 0, (d, n)
    wc = d // n
    out = []
    for t in placement.col_sharded:
        go = config.table_offsets[t]
        tab = stacked[go:go + placement.table_sizes[t]]  # (R, D)
        out.append(np.stack(
            [tab[:, s * wc:(s + 1) * wc] for s in range(n)], axis=0))
    return tuple(out)


def unshard_col_tables(cs_arrays, placement: TablePlacement):
    """Inverse of :func:`shard_col_tables`: per-table (N, R, D/N) ->
    list of logical (R, D) tables in placement.col_sharded order."""
    out = []
    for arr in cs_arrays:
        arr = np.asarray(arr)
        out.append(np.concatenate([arr[s] for s in range(arr.shape[0])],
                                  axis=1))
    return out


def placement_arrays(placement: TablePlacement):
    """Device-dependent metadata as arrays to shard over the table axis."""
    return {
        "slot_tables": jnp.asarray(placement.slot_tables, jnp.int32),
        "slot_valid": jnp.asarray(placement.slot_valid, jnp.int32),
        "slot_offsets": jnp.asarray(placement.slot_local_offsets, jnp.int32),
    }


def _dcn_axis(mesh: Mesh, axis: str):
    from dlrm_tpu.parallel.mesh import dcn_axis_of
    return dcn_axis_of(mesh, axis)


def _batch_spec(mesh: Mesh, axis: str, leading: bool = False):
    """shard_map PartitionSpec for batch operands: the batch dim spans
    EVERY mesh axis on a hybrid (dcn, ici) mesh; ``leading`` adds the
    replicated micro-step dim of stacked (K, B, ...) block batches."""
    dcn = _dcn_axis(mesh, axis)
    b = (dcn, axis) if dcn is not None else axis
    return P(None, b) if leading else P(b)


def _dcn_fold(ids, d_pooled, dcn_axis, exchange_dtype=None):
    """Fold the DCN data-parallel axis into the local batch for the update:
    all-gather ids + compressed pooled gradients over ``dcn_axis`` so every
    DCN replica applies the IDENTICAL global sparse update — the tables
    stay bit-replicated across the DCN axis without ever materializing a
    dense table gradient (per-device DCN traffic is B*T*D/ici bytes, the
    compressed gradient, vs the full table a dense psum would move).
    ``exchange_dtype`` halves that traffic again (bf16 wire format); the
    gathered gradient is identical on every replica either way, so the
    replication invariant is unaffected."""
    dt = d_pooled.dtype
    with jax.named_scope("dcn_grad_allgather"):
        ids = jax.lax.all_gather(ids, dcn_axis, axis=0, tiled=True)
        d_pooled = jax.lax.all_gather(_xc(d_pooled, exchange_dtype),
                                      dcn_axis, axis=0,
                                      tiled=True).astype(dt)
    return ids, d_pooled


def _update_check_kw(dcn_axis):
    """shard_map kwargs for the update bodies.  With a DCN axis the tables'
    out_specs claim replication over it; that replication is REAL (every
    DCN replica applies the identical folded update — the all_gather makes
    its operands DCN-invariant) but the static VMA checker cannot infer it
    through the scatter chain, so the check is disabled for these bodies
    only.  tests/test_hybrid_mesh.py asserts replica equality numerically."""
    return {} if dcn_axis is None else {"check_vma": False}


def _xc(x, exchange_dtype):
    """Compress a collective operand to the wire dtype (``exchange_dtype``,
    e.g. bf16 — half the collective bytes of f32) before the exchange; the
    caller casts the result back.  None = uncompressed.  The compression
    is exactly one rounding applied at the exchange boundary: collectives
    only MOVE data (all_to_all/all_gather) or add disjoint-support
    partials (the rs psum_scatter with single-id lookups; multi-hot rs
    partials take one extra rounding per owning shard — see the
    rs_reduce_scatter note) — no other precision is lost inside the
    collective itself.  Measured inventory in SCALING.md: the fs=128
    pooled a2a is the dominant per-step collective (117 MB/chip at an
    8-mesh), which is exactly the operand this halves."""
    return x if exchange_dtype is None else x.astype(exchange_dtype)


# -- shard_map bodies ----------------------------------------------------------

def _local_rows_for_slots(ids_all, meta, pack: int):
    """Per-device local (physical row, lane slot) for this shard's slots.

    ids_all: (B, T[, H]) global ids, identical on every device.
    Returns (phys, slot), each (B, K[, H]); padding slots resolve to the
    trash physical row.
    """
    tbl = meta["slot_tables"][0]      # (K,)
    valid = meta["slot_valid"][0]     # (K,)
    offs = meta["slot_offsets"][0]    # (K,)
    own = jnp.take(ids_all, tbl, axis=1)  # (B, K[, H])
    if own.ndim == 3:
        own = own * valid[None, :, None]
        offs = offs[None, :, None]
    else:
        own = own * valid[None, :]
        offs = offs[None, :]
    if pack == 1:
        return own + offs, jnp.zeros_like(own)
    return offs + own // pack, own % pack


def _extract(g, slot, pack: int, d: int):
    """(..., D*pack) physical rows + lane slot -> (..., D) logical rows
    (ops/embedding.extract_slots with explicit geometry)."""
    if pack == 1:
        return g
    from dlrm_tpu.ops.embedding import extract_slots
    return extract_slots(g, slot, pack=pack, d=d)


def _expand(rows, slot, pack: int):
    """(..., D) + lane slot -> (..., D*pack) zero outside the slot
    (ops/embedding.expand_slots with explicit geometry)."""
    if pack == 1:
        return rows
    from dlrm_tpu.ops.embedding import expand_slots
    return expand_slots(rows, slot, pack=pack)


def _rs_translate(ids_t, k, placement, my_idx):
    """Row-sharded table k: global ids (B[,H]) -> (phys, slot, owned mask)
    for THIS shard's contiguous block (non-owned ids -> trash row of the
    stack the table lives in, device or host)."""
    pack = placement.pack
    chunk = placement.rs_rows_per_shard[k]
    lo = placement.rs_local_offsets[k]
    trash = (placement.host_local_rows - 1
             if placement.rs_host and placement.rs_host[k]
             else placement.local_rows - 1)
    owner = ids_t // chunk
    owned = owner == my_idx
    local = jnp.where(owned, ids_t - my_idx * chunk, 0)
    phys = jnp.where(owned, lo + local // pack, trash)
    slot = local % pack if pack > 1 else jnp.zeros_like(local)
    return phys, slot, owned


def _host_gather_rows(emb_h_local, phys):
    """Gather physical rows from this shard's host stack (host compute),
    returning device-resident rows: phys any shape -> shape + (W,)."""
    from jax.experimental import compute_on
    from dlrm_tpu.parallel.host_tier import _raw_gather

    # re-annotate the table as host-resident: the input IS pinned_host, but
    # trace-time memory-space inference can drop the tag when other inputs
    # were placed from a different thread (prefetch); this device_put is a
    # no-op on data and pins the aval
    emb_h_local = jax.device_put(emb_h_local, jax.memory.Space.Host)
    flat = jax.device_put(phys.reshape(-1), jax.memory.Space.Host)
    with jax.named_scope("host_rs_gather"), \
            compute_on.compute_on("device_host"):
        rows = _raw_gather(emb_h_local, flat)
    rows = jax.device_put(rows, jax.memory.Space.Device)
    return rows.reshape(phys.shape + (emb_h_local.shape[-1],))


def _host_scatter_add_rows(emb_h_local, phys, upd):
    """Scatter-add physical-row updates into this shard's host stack
    (host compute); upd: phys.shape + (W,)."""
    from jax.experimental import compute_on
    from dlrm_tpu.parallel.host_tier import _raw_scatter_add

    emb_h_local = jax.device_put(emb_h_local, jax.memory.Space.Host)
    flat = jax.device_put(phys.reshape(-1), jax.memory.Space.Host)
    upd_h = jax.device_put(upd.reshape(-1, upd.shape[-1]),
                           jax.memory.Space.Host)
    with jax.named_scope("host_rs_scatter"), \
            compute_on.compute_on("device_host"):
        return _raw_scatter_add(emb_h_local, flat, upd_h)


def _cs_lookup(cs_local, ids_t, axis: str, exchange_dtype=None,
               csc_local=None):
    """Column-sharded table: local gather of the lane slice for ALL ids,
    then one all-to-all that splits the batch and concatenates the lane
    slices: (B, D/N) per shard -> (B/N, D) batch-sharded.

    ``csc_local``: per-(shard, row) dequantization scales (1, R_t) when
    the slice is int8 (quantized serving) — dequantize BEFORE pooling."""
    rows = jnp.take(cs_local[0], ids_t, axis=0)   # (B[, H], D/N)
    if csc_local is not None:
        s = jnp.take(csc_local[0], ids_t, axis=0)  # (B[, H])
        rows = rows.astype(jnp.float32) * s[..., None]
    if rows.ndim == 3:
        rows = jnp.sum(rows, axis=1)              # pool multi-hot
    dt = rows.dtype
    with jax.named_scope("cs_a2a_fwd"):
        return jax.lax.all_to_all(
            _xc(rows, exchange_dtype), axis, split_axis=0, concat_axis=1,
            tiled=True).astype(dt)                # (B/N, D)


def _deq_local(rows, phys, slot, scales_l, pack: int):
    """Dequantize extracted logical rows: rows (..., D) int8-exact values
    x per-logical-row scale selected by (phys, slot) from the shard's
    (local_rows, pack) scale array."""
    s = jnp.take(scales_l, phys, axis=0)          # (..., pack)
    if pack > 1:
        s = jnp.take_along_axis(s, slot[..., None], axis=-1)[..., 0]
    else:
        s = s[..., 0]
    return rows.astype(jnp.float32) * s[..., None]


def _lookup_body(emb, emb_h, cs, ids, meta, scales, cs_scales, *,
                 axis: str, out_column: np.ndarray, pack: int, dim: int,
                 placement: "TablePlacement", exchange_dtype=None,
                 quantized: bool = False):
    """SPMD body: emb (1, R, D*pack), emb_h (1, H, D*pack) host-resident
    (or None), cs per-table (1, R_t, D/N) lane slices, ids (B/N, T[,H])
    -> pooled (B/N, T, D) in GLOBAL table order.

    ``quantized`` (int8 serving): emb/cs are int8 and ``scales``
    (1, R, pack) / ``cs_scales`` (per-table (1, R_t)) dequantize each
    gathered logical row right after slot extraction — before pooling,
    masking, and the exchange.  The pinned-host stack stays
    full-precision (quantization saves HBM; emb_h lives in host RAM).

    Slot-placed tables: local gather + all-to-all slot exchange.
    Row-sharded tables: each id's row lives on exactly ONE shard, so the
    masked local partials sum to the full lookup — psum_scatter both sums
    over shards and splits the batch in one collective (comm volume B*D
    per table, same order as the slot all-to-all).  Host-resident
    row-sharded tables gather from this shard's pinned-host stack
    (host-side compute, only hit rows cross PCIe) and join the same
    psum_scatter.
    Column-sharded tables: every shard gathers its lane slice for all ids,
    one all-to-all splits the batch and concatenates the lanes.
    """
    ids_all = jax.lax.all_gather(ids, axis, axis=0, tiled=True)
    parts = []
    if placement.slot_table_list:
        # meta's slot_tables carry global table indices, so the slot path
        # picks its columns straight from the full ids_all
        phys, slot = _local_rows_for_slots(ids_all, meta, pack)
        g = jnp.take(emb[0], phys, axis=0)       # (B, K[, H], D*pack)
        rows = _extract(g, slot, pack, dim)      # (B, K[, H], D)
        if quantized:
            rows = _deq_local(rows, phys, slot, scales[0], pack)
        if rows.ndim == 4:
            with jax.named_scope("pool"):
                rows = jnp.sum(rows, axis=2)     # pool before the exchange
        with jax.named_scope("a2a_fwd"):
            ex = jax.lax.all_to_all(
                _xc(rows, exchange_dtype), axis, split_axis=0,
                concat_axis=1, tiled=True)       # (B/N, N*K, D)
        parts.append(jnp.take(ex, jnp.asarray(out_column),
                              axis=1).astype(rows.dtype))
    if placement.row_sharded:
        my_idx = jax.lax.axis_index(axis)
        rs_parts = []
        for k, t in enumerate(placement.row_sharded):
            ids_t = (ids_all[:, t] if ids_all.ndim == 2
                     else ids_all[:, t, :])      # (B[, H])
            phys, slot, owned = _rs_translate(ids_t, k, placement, my_idx)
            if placement.rs_host and placement.rs_host[k]:
                g = _host_gather_rows(emb_h[0], phys)
                rows = _extract(g, slot, pack, dim)  # host stack: f32
                if quantized:
                    rows = rows.astype(jnp.float32)
            else:
                g = jnp.take(emb[0], phys, axis=0)  # (B[, H], D*pack)
                rows = _extract(g, slot, pack, dim)  # (B[, H], D)
                if quantized:
                    rows = _deq_local(rows, phys, slot, scales[0], pack)
            rows = rows * owned[..., None].astype(rows.dtype)
            if rows.ndim == 3:
                rows = jnp.sum(rows, axis=1)     # pool multi-hot partials
            rs_parts.append(rows)                # (B, D)
        stacked = jnp.stack(rs_parts, axis=1)    # (B, n_rs, D)
        with jax.named_scope("rs_reduce_scatter"):
            # sum partials over shards AND split the batch in one
            # collective.  Exchange compression: one-hot partials have
            # disjoint support (each id owned by exactly one shard), so
            # the compressed psum only adds exact zeros — a single
            # rounding, same as the a2a paths.  Multi-hot partials may be
            # nonzero on several shards (a sample's H hits can straddle
            # owners), so their sum accumulates in the wire dtype — one
            # extra bf16 rounding per owning shard, bounded and tested.
            part = jax.lax.psum_scatter(
                _xc(stacked, exchange_dtype), axis, scatter_dimension=0,
                tiled=True).astype(stacked.dtype)  # (B/N, n_rs, D)
        parts.append(part)
    if placement.col_sharded:
        cs_parts = []
        for k, t in enumerate(placement.col_sharded):
            ids_t = (ids_all[:, t] if ids_all.ndim == 2
                     else ids_all[:, t, :])
            cs_parts.append(_cs_lookup(
                cs[k], ids_t, axis, exchange_dtype,
                csc_local=cs_scales[k] if quantized else None))  # (B/N, D)
        parts.append(jnp.stack(cs_parts, axis=1))            # (B/N, n_cs, D)
    out = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)
    return jnp.take(out, jnp.asarray(placement.output_order()), axis=1)


def _update_body(emb, emb_h, cs, ids, d_pooled, lr, meta, *, axis: str,
                 out_column: np.ndarray, num_slots: int, pack: int,
                 placement: "TablePlacement", block_leading: bool = False,
                 dcn_axis=None, exchange_dtype=None):
    """SPMD body of the sparse SGD update.

    emb (1, R, D*pack), ids (B/N, T[,H]), d_pooled (B/N, T, D) -> new emb.
    Slot tables route gradients back through the inverse all-to-all;
    row-sharded tables all-gather their (B, D) gradient columns and each
    shard scatter-adds only the rows it owns.

    ``block_leading``: ids/d_pooled carry a leading micro-step dim
    (K, B/N, ...) from the coalesced block step — folded into the local
    batch here (scatter-add order is irrelevant), so K steps' updates
    cost ONE scatter pass.

    ``dcn_axis``: hybrid (dcn, ici) mesh — the DCN replicas' gradients are
    folded into the batch first (:func:`_dcn_fold`) so the replicated
    tables apply one identical global update.
    """
    if block_leading:
        ids = ids.reshape((-1,) + ids.shape[2:])
        d_pooled = d_pooled.reshape((-1,) + d_pooled.shape[2:])
    if dcn_axis is not None:
        ids, d_pooled = _dcn_fold(ids, d_pooled, dcn_axis, exchange_dtype)
    dim = d_pooled.shape[-1]
    b_local = d_pooled.shape[0]
    ids_all = jax.lax.all_gather(ids, axis, axis=0, tiled=True)
    new = emb[0]
    if placement.slot_table_list:
        d_slots = jnp.take(
            d_pooled, jnp.asarray(placement.slot_table_list), axis=1)
        scat = jnp.zeros((b_local, num_slots, dim), d_pooled.dtype)
        scat = scat.at[:, jnp.asarray(out_column), :].set(d_slots)
        with jax.named_scope("a2a_bwd"):
            back = jax.lax.all_to_all(
                _xc(scat, exchange_dtype), axis, split_axis=1,
                concat_axis=0, tiled=True).astype(
                    d_pooled.dtype)  # (B,K,D)
        phys, slot = _local_rows_for_slots(ids_all, meta, pack)
        if phys.ndim == 3:
            # sum-pooled multi-hot: every hot row gets the pooled gradient
            back = jnp.broadcast_to(back[:, :, None, :],
                                    phys.shape + (dim,))
        upd = _expand((-lr * back).astype(new.dtype), slot, pack)
        new = new.at[phys.reshape(-1)].add(
            upd.reshape(-1, dim * pack), mode="drop")
    new_h = emb_h[0]
    if placement.row_sharded:
        my_idx = jax.lax.axis_index(axis)
        d_rs = jnp.take(d_pooled, jnp.asarray(placement.row_sharded,
                                              jnp.int32), axis=1)
        with jax.named_scope("rs_allgather_bwd"):
            d_rs_all = jax.lax.all_gather(
                _xc(d_rs, exchange_dtype), axis, axis=0,
                tiled=True).astype(d_pooled.dtype)  # (B, n_rs, D)
        for k, t in enumerate(placement.row_sharded):
            ids_t = (ids_all[:, t] if ids_all.ndim == 2
                     else ids_all[:, t, :])
            phys, slot, owned = _rs_translate(ids_t, k, placement, my_idx)
            g = d_rs_all[:, k, :]                       # (B, D)
            if ids_t.ndim == 2:  # multi-hot: broadcast pooled grad to hits
                g = jnp.broadcast_to(g[:, None, :], ids_t.shape + (dim,))
            g = g * owned[..., None].astype(g.dtype)
            if placement.rs_host and placement.rs_host[k]:
                upd = _expand((-lr * g).astype(new_h.dtype), slot, pack)
                new_h = _host_scatter_add_rows(new_h, phys, upd)
            else:
                upd = _expand((-lr * g).astype(new.dtype), slot, pack)
                new = new.at[phys.reshape(-1)].add(
                    upd.reshape(-1, dim * pack), mode="drop")
    new_cs = []
    for k, t in enumerate(placement.col_sharded):
        d_t = d_pooled[:, t, :]  # (B/N, D), global table order
        with jax.named_scope("cs_a2a_bwd"):
            back = jax.lax.all_to_all(
                _xc(d_t, exchange_dtype), axis, split_axis=1,
                concat_axis=0, tiled=True).astype(
                    d_pooled.dtype)  # (B, D/N)
        ids_t = (ids_all[:, t] if ids_all.ndim == 2
                 else ids_all[:, t, :])
        g = back
        if ids_t.ndim == 2:  # multi-hot: broadcast pooled grad to hits
            g = jnp.broadcast_to(back[:, None, :],
                                 ids_t.shape + (back.shape[-1],))
        local = cs[k][0]
        upd = (-lr * g).astype(local.dtype)
        new_cs.append(local.at[ids_t.reshape(-1)].add(
            upd.reshape(-1, upd.shape[-1]), mode="drop")[None])
    return new[None], new_h[None], tuple(new_cs)


# -- public API ----------------------------------------------------------------

def sharded_lookup(emb: jax.Array, ids: jax.Array, *, mesh: Mesh,
                   placement: TablePlacement, axis: str = "d",
                   cs=(), emb_h=None, exchange_dtype=None,
                   scales=None, cs_scales=()) -> jax.Array:
    """Pooled lookup: emb (N, R, W) sharded on ``axis``; ids (B, T[,H])
    batch-sharded on ``axis``; ``cs`` the column-sharded per-table
    (N, R_t, D/N) arrays; ``emb_h`` the (N, host_local_rows, W) pinned-host
    stack for host-resident row-sharded tables.  Returns (B, T, D)
    batch-sharded.

    ``exchange_dtype`` (e.g. jnp.bfloat16) compresses the activation
    exchanges (slot/cs all_to_all, rs psum_scatter) to half the
    collective bytes; the result equals the f32 lookup rounded once to the wire
    dtype (see :func:`_xc`).

    ``scales`` (N, local_rows, pack) + ``cs_scales`` (per-table
    (N, R_t)): int8 quantized SERVING — emb/cs hold int8 rows (from
    ops/quant.quantize_sharded_stack / quantize_col_shards) and each
    gathered row dequantizes on its owning shard.  This is what fits
    Terabyte-scale serving in a slice's HBM (fs=128: ~451 GB f32 vs
    ~113 GB int8).  Inference-only: the update paths reject int8."""
    quantized = scales is not None
    if emb.dtype == jnp.int8 and not quantized:
        raise ValueError("int8 table stack without scales — pass the "
                         "scales from quantize_sharded_stack")
    meta = placement_arrays(placement)
    if emb_h is None:
        emb_h = _dummy_host_stack(emb, placement)
    if not quantized:
        # SPMD-uniform dummies (never read: `quantized` is static)
        scales = jnp.zeros((emb.shape[0], 1, 1), jnp.float32)
        cs_scales = tuple(jnp.zeros((c.shape[0], 1), jnp.float32)
                          for c in cs)
    body = functools.partial(_lookup_body, axis=axis,
                             out_column=placement.out_column(),
                             pack=placement.pack,
                             dim=emb.shape[-1] // placement.pack,
                             placement=placement,
                             exchange_dtype=exchange_dtype,
                             quantized=quantized)
    # hybrid (dcn, ici) mesh: the lookup needs NO dcn communication at all
    # — each dcn replica holds full tables (sharded over `axis` only) and
    # serves its own batch slice; only the batch spec spans both axes
    bspec = _batch_spec(mesh, axis)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(axis), tuple(P(axis) for _ in cs), bspec,
                  {k: P(axis) for k in meta}, P(axis),
                  tuple(P(axis) for _ in cs_scales)),
        out_specs=bspec,
    )(emb, emb_h, tuple(cs), ids, meta, scales, tuple(cs_scales))


def _collect_grad_pairs(ids_all, back, meta, placement, pack, dim):
    """Collect every (logical-row key, gradient row) contribution on this
    shard: slot tables (from the routed-back a2a grads) + row-sharded
    tables (from the all-gathered rs grad columns).  Invalid entries carry
    key -1 and zero rows.  Returns (keys (M,), g (M, D))."""
    keys_parts, g_parts = [], []
    if placement.slot_table_list:
        phys, slot = _local_rows_for_slots(ids_all, meta, pack)
        valid = meta["slot_valid"][0]          # (K,)
        b = back
        if phys.ndim == 3:
            b = jnp.broadcast_to(back[:, :, None, :], phys.shape + (dim,))
            vmask = valid[None, :, None]
        else:
            vmask = valid[None, :]
        key = jnp.where(vmask > 0, phys * pack + slot, -1)
        keys_parts.append(key.reshape(-1))
        g_parts.append((b * (vmask > 0)[..., None]).reshape(-1, dim))
    return keys_parts, g_parts


def _adagrad_apply_local(emb_l, acc_l, keys, g, lr, pack, dim,
                         eps: float = 1e-10, twin: bool = False):
    """Exact local Adagrad on deduped (key, summed-grad) pairs (same math
    as train/optim.apply_adagrad_chunked / optax.scale_by_rss).

    ``twin``: ``g`` carries (g, lr_k*g) concatenated along the feature
    dim — one dedup sums both; the accumulator folds in the RAW summed
    gradient, the weight step applies the lr-scaled one with lr = 1 (the
    per-micro-step-schedule block contract, see
    optim.apply_adagrad_chunked's d_rows_scaled)."""
    from dlrm_tpu.ops.embedding import dedup_sparse_grad, SparseGrad

    out = dedup_sparse_grad(SparseGrad(keys, g))
    keys_u, g_u = out.ids, out.rows
    gs_u = None
    if twin:
        g_u, gs_u = g_u[:, :dim], g_u[:, dim:]
    phys_u = jnp.where(keys_u >= 0, keys_u // pack, -1)
    lane_u = jnp.where(keys_u >= 0, keys_u % pack, 0)
    acc_rows = _extract(jnp.take(acc_l, phys_u, axis=0), lane_u, pack, dim)
    acc_new = acc_rows + g_u * g_u
    acc_l = acc_l.at[phys_u].add(
        _expand(g_u * g_u, lane_u, pack), mode="drop")
    rs = jnp.where(acc_new > 0, jax.lax.rsqrt(acc_new + eps), 0.0)
    step_rows = (gs_u * rs) if twin else (lr * (g_u * rs))
    emb_l = emb_l.at[phys_u].add(
        _expand((-step_rows).astype(emb_l.dtype), lane_u, pack),
        mode="drop")
    return emb_l, acc_l


def _rowwise_apply_local(emb_l, racc_l, keys, g, lr, pack, dim,
                         eps: float = 1e-10, twin: bool = False):
    """Exact local ROW-WISE Adagrad on deduped (key, summed-grad) pairs:
    one accumulator scalar per logical row (racc_l: (local_rows, pack)
    f32), acc[r] += mean_D(g_r^2), w[r] -= lr*g_r*rsqrt(acc[r]+eps) —
    the sharded counterpart of optim.apply_rowwise_adagrad_chunked.
    The dedup key IS the flat (local_rows*pack) accumulator index."""
    from dlrm_tpu.ops.embedding import dedup_sparse_grad, SparseGrad

    out = dedup_sparse_grad(SparseGrad(keys, g))
    keys_u, g_u = out.ids, out.rows
    gs_u = None
    if twin:
        g_u, gs_u = g_u[:, :dim], g_u[:, dim:]
    phys_u = jnp.where(keys_u >= 0, keys_u // pack, -1)
    lane_u = jnp.where(keys_u >= 0, keys_u % pack, 0)
    g2m = jnp.mean(g_u * g_u, axis=-1)
    racc_flat = racc_l.reshape(-1)
    acc_new = racc_flat[keys_u] + g2m        # surplus keys: g2m == 0
    racc_l = racc_flat.at[keys_u].add(g2m, mode="drop").reshape(
        racc_l.shape)
    rs = jnp.where(acc_new > 0, jax.lax.rsqrt(acc_new + eps), 0.0)
    step_rows = (gs_u * rs[:, None]) if twin else (lr * (g_u * rs[:, None]))
    emb_l = emb_l.at[phys_u].add(
        _expand(-step_rows, lane_u, pack).astype(emb_l.dtype),
        mode="drop")
    return emb_l, racc_l


def _cs_adagrad_local(cs_local, acc_local, ids_t, g, lr,
                      eps: float = 1e-10, g_scaled=None):
    """Exact Adagrad on one column-sharded table's lane slice: Adagrad is
    elementwise, so each shard's (R, D/N) slice keeps an independent
    accumulator slice.  ``g``: (B[, H], D/N) routed-back lane grads;
    ``g_scaled``: lr_k-pre-scaled grads (schedule blocks) — deduped
    jointly, applied with lr = 1."""
    from dlrm_tpu.ops.embedding import dedup_sparse_grad, SparseGrad

    wc = g.shape[-1]
    if g_scaled is not None:
        g = jnp.concatenate([g.reshape(-1, wc),
                             g_scaled.reshape(-1, wc)], axis=-1)
    out = dedup_sparse_grad(SparseGrad(ids_t.reshape(-1),
                                       g.reshape(-1, g.shape[-1])))
    ids_u, g_u = out.ids, out.rows
    gs_u = None
    if g_scaled is not None:
        g_u, gs_u = g_u[:, :wc], g_u[:, wc:]
    acc_rows = jnp.take(acc_local, ids_u, axis=0)
    acc_new = acc_rows + g_u * g_u
    acc_local = acc_local.at[ids_u].add(g_u * g_u, mode="drop")
    rs = jnp.where(acc_new > 0, jax.lax.rsqrt(acc_new + eps), 0.0)
    step = (gs_u * rs) if gs_u is not None else (lr * (g_u * rs))
    cs_local = cs_local.at[ids_u].add((-step).astype(cs_local.dtype),
                                      mode="drop")
    return cs_local, acc_local


def _cs_rowwise_local(cs_local, racc, ids_t, g, lr, axis: str, dim: int,
                      eps: float = 1e-10, g_scaled=None):
    """Exact ROW-WISE Adagrad on one column-sharded table (dense-G form).

    Row-wise needs the mean over the FULL feature dim of g^2, but each
    shard holds only a (R, D/N) lane slice.  Each shard scatter-adds its
    lane gradients into a dense (R, D/N) buffer (duplicate ids sum exactly
    — the dedup-then-apply contract for free, same trick as
    optim.apply_adagrad_dense_g), and ONE psum over ``axis`` of the
    per-row lane sum-of-squares completes the full-D sum.  The (R,)
    accumulator is REPLICATED across shards: the psum output is
    axis-invariant, so every shard folds in the identical per-row mean and
    the VMA checker PROVES replication is maintained (no check_vma
    disable).  Memory: R floats per shard vs R*D/N for an elementwise
    slice — the 1/D rowwise saving survives column sharding; the dense
    form also drops the dedup argsort entirely (cs targets HOT tables,
    where a dense (R, D/N) pass is cheap and collision-heavy scatters are
    exactly the expensive case).

    ``g_scaled``: lr_k-pre-scaled lane grads (schedule blocks) — a second
    dense buffer carries them; the step then applies with lr = 1.
    Reference semantics bar: dedup-then-apply, src/train/train.jl:283-290."""
    rows, wc = cs_local.shape
    flat = ids_t.reshape(-1)

    def densify(x):
        return jnp.zeros((rows, wc), jnp.float32).at[flat].add(
            x.reshape(-1, wc).astype(jnp.float32), mode="drop")

    with jax.named_scope("cs_rowwise_densify"):
        G = densify(g)
    with jax.named_scope("cs_rowwise_psum"):
        s2 = jax.lax.psum(jnp.sum(G * G, axis=-1), axis)   # (R,) full-D
    g2m = s2 / dim
    acc_new = racc + g2m                 # untouched rows: g2m == 0
    rs = jnp.where(acc_new > 0, jax.lax.rsqrt(acc_new + eps), 0.0)
    if g_scaled is not None:
        step = densify(g_scaled) * rs[:, None]
    else:
        step = (lr * G) * rs[:, None]    # untouched rows: G == 0
    cs_local = (cs_local - step.astype(cs_local.dtype)).astype(
        cs_local.dtype)
    return cs_local, acc_new


def _host_rowwise_local(emb_h_l, racc_h_l, key, g, lr, pack, dim, trash,
                        eps: float = 1e-10, twin: bool = False):
    """Exact ROW-WISE Adagrad on one host-resident table's owned rows: the
    scalar-per-row accumulator is a (host_local_rows, pack) f32 slab
    pinned host-side next to the table slab; dedup runs on device, then
    one host gather of the accumulator lanes and two host scatter-adds
    (acc += mean(g^2), table -= step) — the rowwise counterpart of
    :func:`_host_adagrad_local` with 1/D the slow-tier optimizer bytes."""
    from dlrm_tpu.ops.embedding import dedup_sparse_grad, SparseGrad

    out = dedup_sparse_grad(SparseGrad(key, g))
    keys_u, g_u = out.ids, out.rows
    phys_u = jnp.where(keys_u >= 0, keys_u // pack, trash)
    lane_u = jnp.where(keys_u >= 0, keys_u % pack, 0)
    g_u = g_u * (keys_u >= 0)[:, None]
    gs_u = None
    if twin:
        g_u, gs_u = g_u[:, :dim], g_u[:, dim:]
    g2m = jnp.mean(g_u * g_u, axis=-1)               # (M,)
    acc_rows = _host_gather_rows(racc_h_l, phys_u)   # (M, pack)
    acc_sel = jnp.take_along_axis(acc_rows, lane_u[:, None], axis=1)[:, 0]
    acc_new = acc_sel + g2m
    lane_hot = jax.nn.one_hot(lane_u, pack, dtype=jnp.float32)
    racc_h_l = _host_scatter_add_rows(racc_h_l, phys_u,
                                      lane_hot * g2m[:, None])
    rs = jnp.where(acc_new > 0, jax.lax.rsqrt(acc_new + eps), 0.0)
    step_rows = (gs_u * rs[:, None]) if twin else (lr * (g_u * rs[:, None]))
    emb_h_l = _host_scatter_add_rows(
        emb_h_l, phys_u,
        _expand(-step_rows, lane_u, pack).astype(emb_h_l.dtype))
    return emb_h_l, racc_h_l


def _host_adagrad_local(emb_h_l, acc_h_l, key, g, lr, pack, dim, trash,
                        eps: float = 1e-10, twin: bool = False):
    """Exact Adagrad on one host-resident table's owned rows: dedup on
    device, then host-side gather of accumulator rows and two host-side
    scatter-adds (acc += g^2, table -= lr*g*rsqrt(acc')).  ``twin``: g
    carries (g, lr_k*g) along the feature dim (schedule blocks)."""
    from dlrm_tpu.ops.embedding import dedup_sparse_grad, SparseGrad

    out = dedup_sparse_grad(SparseGrad(key, g))
    keys_u, g_u = out.ids, out.rows
    phys_u = jnp.where(keys_u >= 0, keys_u // pack, trash)
    lane_u = jnp.where(keys_u >= 0, keys_u % pack, 0)
    g_u = g_u * (keys_u >= 0)[:, None]
    gs_u = None
    if twin:
        g_u, gs_u = g_u[:, :dim], g_u[:, dim:]
    acc_rows = _extract(_host_gather_rows(acc_h_l, phys_u), lane_u, pack,
                        dim)
    acc_new = acc_rows + g_u * g_u
    acc_h_l = _host_scatter_add_rows(
        acc_h_l, phys_u, _expand(g_u * g_u, lane_u, pack))
    rs = jnp.where(acc_new > 0, jax.lax.rsqrt(acc_new + eps), 0.0)
    step_rows = (gs_u * rs) if twin else (lr * (g_u * rs))
    emb_h_l = _host_scatter_add_rows(
        emb_h_l, phys_u,
        _expand(-step_rows, lane_u, pack).astype(emb_h_l.dtype))
    return emb_h_l, acc_h_l


def _update_body_adagrad(emb, acc, emb_h, acc_h, cs, acc_cs, ids, d_pooled,
                         lr, meta, *, axis: str, out_column: np.ndarray,
                         num_slots: int, pack: int,
                         placement: "TablePlacement", dcn_axis=None,
                         block_leading: bool = False, twin: bool = False,
                         rowwise: bool = False, exchange_dtype=None):
    """SPMD Adagrad update: same gradient routing as _update_body, then an
    exact dedup-then-apply Adagrad on each shard's owned rows (accumulator
    sharded like the tables; lane-sliced for column-sharded tables;
    pinned-host slab mirroring the host-resident row-sharded stack).
    ``block_leading``/``dcn_axis`` fold extra gradient sources into the
    batch exactly as in :func:`_update_body`; the dedup then sums a key's
    contributions across micro-steps / DCN replicas before the nonlinear
    accumulator update, preserving the dedup-then-apply contract."""
    if block_leading:
        ids = ids.reshape((-1,) + ids.shape[2:])
        d_pooled = d_pooled.reshape((-1,) + d_pooled.shape[2:])
    if dcn_axis is not None:
        ids, d_pooled = _dcn_fold(ids, d_pooled, dcn_axis, exchange_dtype)
    # ``twin``: d_pooled carries (g, lr_k*g) concatenated on the feature
    # dim (scheduled blocks) — ALL gradient routing moves the doubled
    # width unchanged; only the apply fns split it
    width = d_pooled.shape[-1]
    dim = width // 2 if twin else width
    b_local = d_pooled.shape[0]
    ids_all = jax.lax.all_gather(ids, axis, axis=0, tiled=True)
    keys_parts, g_parts = [], []
    if placement.slot_table_list:
        d_slots = jnp.take(
            d_pooled, jnp.asarray(placement.slot_table_list), axis=1)
        scat = jnp.zeros((b_local, num_slots, width), d_pooled.dtype)
        scat = scat.at[:, jnp.asarray(out_column), :].set(d_slots)
        with jax.named_scope("a2a_bwd"):
            back = jax.lax.all_to_all(
                _xc(scat, exchange_dtype), axis, split_axis=1,
                concat_axis=0, tiled=True).astype(d_pooled.dtype)
        kp, gp = _collect_grad_pairs(ids_all, back, meta, placement,
                                     pack, width)
        keys_parts += kp
        g_parts += gp
    new_h = emb_h[0]
    new_acc_h = acc_h[0]
    if placement.row_sharded:
        my_idx = jax.lax.axis_index(axis)
        d_rs = jnp.take(d_pooled, jnp.asarray(placement.row_sharded,
                                              jnp.int32), axis=1)
        with jax.named_scope("rs_allgather_bwd"):
            d_rs_all = jax.lax.all_gather(
                _xc(d_rs, exchange_dtype), axis, axis=0,
                tiled=True).astype(d_pooled.dtype)
        for k, t in enumerate(placement.row_sharded):
            ids_t = (ids_all[:, t] if ids_all.ndim == 2
                     else ids_all[:, t, :])
            phys, slot, owned = _rs_translate(ids_t, k, placement, my_idx)
            g = d_rs_all[:, k, :]
            if ids_t.ndim == 2:
                g = jnp.broadcast_to(g[:, None, :], ids_t.shape + (width,))
            key = jnp.where(owned, phys * pack + slot, -1)
            if placement.rs_host and placement.rs_host[k]:
                host_apply = (_host_rowwise_local if rowwise
                              else _host_adagrad_local)
                new_h, new_acc_h = host_apply(
                    new_h, new_acc_h, key.reshape(-1),
                    (g * owned[..., None]).reshape(-1, width).astype(
                        jnp.float32),
                    lr, pack, dim, placement.host_local_rows - 1,
                    twin=twin)
            else:
                keys_parts.append(key.reshape(-1))
                g_parts.append((g * owned[..., None]).reshape(-1, width))
    if keys_parts:
        keys = jnp.concatenate(keys_parts)
        g = jnp.concatenate(g_parts).astype(jnp.float32)
        apply_local = (_rowwise_apply_local if rowwise
                       else _adagrad_apply_local)
        new_emb, new_acc = apply_local(emb[0], acc[0], keys, g,
                                       lr, pack, dim, twin=twin)
    else:
        new_emb, new_acc = emb[0], acc[0]
    new_cs, new_acc_cs = [], []
    for k, t in enumerate(placement.col_sharded):
        # the cs all_to_all splits the FEATURE dim over shards, so the
        # twin halves must ride separate exchanges (a feature-concat
        # would interleave raw and scaled lanes across shards)
        def _cs_route(cols):
            with jax.named_scope("cs_a2a_bwd"):
                back = jax.lax.all_to_all(
                    _xc(cols, exchange_dtype), axis, split_axis=1,
                    concat_axis=0, tiled=True)
            if ids_t.ndim == 2:  # multi-hot: broadcast pooled grad
                back = jnp.broadcast_to(back[:, None, :],
                                        ids_t.shape + (back.shape[-1],))
            return back.astype(jnp.float32)

        ids_t = (ids_all[:, t] if ids_all.ndim == 2
                 else ids_all[:, t, :])
        g = _cs_route(d_pooled[:, t, :dim])
        gs = _cs_route(d_pooled[:, t, dim:]) if twin else None
        if rowwise:
            # replicated (R,) accumulator — enters the body whole (P()),
            # every shard applies the identical psum'd row means
            cs_new, acc_new = _cs_rowwise_local(
                cs[k][0], acc_cs[k], ids_t, g, lr, axis, dim, g_scaled=gs)
            new_cs.append(cs_new[None])
            new_acc_cs.append(acc_new)
        else:
            cs_new, acc_new = _cs_adagrad_local(
                cs[k][0], acc_cs[k][0], ids_t, g, lr, g_scaled=gs)
            new_cs.append(cs_new[None])
            new_acc_cs.append(acc_new[None])
    return (new_emb[None], new_acc[None], new_h[None], new_acc_h[None],
            tuple(new_cs), tuple(new_acc_cs))


def sharded_update_adagrad(emb: jax.Array, acc: jax.Array, ids: jax.Array,
                           d_pooled: jax.Array, lr, *, mesh: Mesh,
                           placement: TablePlacement, axis: str = "d",
                           cs=(), acc_cs=(), emb_h=None, acc_h=None,
                           block_leading: bool = False,
                           d_pooled_scaled=None, rowwise: bool = False,
                           exchange_dtype=None):
    """Sparse Adagrad on the sharded tables (slot + row-sharded +
    host-resident + column-sharded).  ``acc`` is the accumulator in the
    same (N, local_rows, W) layout; ``acc_h`` mirrors the pinned-host
    stack; ``acc_cs`` mirrors the per-table (N, R_t, D/N) column-sharded
    arrays (Adagrad is elementwise, so lane slices accumulate
    independently).  Returns (new_emb, new_acc, new_emb_h, new_acc_h,
    new_cs, new_acc_cs) — the host pair is None without host tables."""
    if emb.dtype == jnp.int8:
        raise ValueError("int8 quantized tables are inference-only; "
                         "train on f32/bf16 storage and quantize after")
    meta = placement_arrays(placement)
    has_host = emb_h is not None
    if not has_host:
        emb_h = _dummy_host_stack(emb, placement)
        acc_h = jnp.zeros(emb_h.shape, jnp.float32)
    twin = d_pooled_scaled is not None
    if twin:
        # scheduled blocks: (g, lr_k*g) ride the routing as one
        # double-width tensor, split at the apply points; lr is then 1
        d_pooled = jnp.concatenate([d_pooled, d_pooled_scaled], axis=-1)
        lr = 1.0
    body = functools.partial(
        _update_body_adagrad, axis=axis, out_column=placement.out_column(),
        num_slots=placement.num_shards * placement.slots_per_shard,
        pack=placement.pack, placement=placement,
        dcn_axis=_dcn_axis(mesh, axis), block_leading=block_leading,
        twin=twin, rowwise=rowwise, exchange_dtype=exchange_dtype)
    bspec = _batch_spec(mesh, axis, leading=block_leading)
    # rowwise cs accumulators are REPLICATED (R,) vectors (see
    # _cs_rowwise_local); elementwise cs accumulators shard like the
    # lane slices
    acc_cs_spec = tuple((P() if rowwise else P(axis)) for _ in acc_cs)
    out = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis),
                  tuple(P(axis) for _ in cs),
                  acc_cs_spec, bspec, bspec, P(),
                  {k: P(axis) for k in meta}),
        out_specs=(P(axis), P(axis), P(axis), P(axis),
                   tuple(P(axis) for _ in cs),
                   acc_cs_spec),
        **_update_check_kw(_dcn_axis(mesh, axis)),
    )(emb, acc, emb_h, acc_h, tuple(cs), tuple(acc_cs), ids, d_pooled,
      jnp.asarray(lr, jnp.float32), meta)
    new_emb, new_acc, new_h, new_acc_h, new_cs, new_acc_cs = out
    if not has_host:
        new_h = new_acc_h = None
    return new_emb, new_acc, new_h, new_acc_h, new_cs, new_acc_cs


def make_dcn_replica_check(mesh: Mesh, axis: str = "d"):
    """Debug-mode runtime guard for the hybrid mesh's core invariant: the
    tables are bit-REPLICATED across the DCN axis (every replica applied
    the identical folded update, _dcn_fold).  The static VMA checker is
    disabled for the folded update bodies (_update_check_kw) because it
    cannot see through the scatter chain — so a future edit that breaks
    DCN-invariance would compile cleanly and silently diverge.  This check
    closes that hole at runtime: per-shard XOR-fold of the raw bits (order
    independent, catches any single-bit divergence), one tiny all_gather
    over DCN, equality.  Returns a jitted ``check(params) -> (ici,) bool``
    (True everywhere iff replicas agree), or None on a 1-D mesh.  Run it
    every N steps under ``--paranoid N`` — cost is one pass over the
    shards, so keep N large in production."""
    dcn = _dcn_axis(mesh, axis)
    if dcn is None:
        return None

    def xor_fold(x):
        bits = jax.lax.bitcast_convert_type(
            x.astype(jnp.float32), jnp.uint32).reshape(-1)
        return jax.lax.reduce(bits, np.uint32(0), jax.lax.bitwise_xor,
                              (0,))

    def body(emb, cs, emb_h):
        c = xor_fold(emb)
        for t in cs:
            c = c ^ xor_fold(t)
        c = c ^ xor_fold(emb_h)     # dummy stack folds zeros: harmless
        sums = jax.lax.all_gather(c, dcn)           # (H,) per ici shard
        return jnp.all(sums == sums[0])[None]

    built = {}  # len(cs) -> shard_mapped body, so repeat checks reuse
                # one traced/compiled program instead of re-wrapping

    def check(params) -> jax.Array:
        cs = tuple(params.get("emb_cs", ()))
        emb_h = params.get("emb_h")
        if emb_h is None:
            emb_h = _dummy_host_stack(params["emb"])
        else:
            # pull the pinned-host stack into device memory for the fold
            # (debug mode: the PCIe copy is the price of checking it too)
            emb_h = jax.device_put(emb_h, NamedSharding(mesh, P(axis)))
        if len(cs) not in built:
            built[len(cs)] = jax.jit(jax.shard_map(
                body, mesh=mesh,
                in_specs=(P(axis), tuple(P(axis) for _ in cs), P(axis)),
                out_specs=P(axis), check_vma=False))
        return built[len(cs)](params["emb"], cs, emb_h)

    return check


def _dummy_host_stack(emb: jax.Array,
                      placement: Optional[TablePlacement] = None
                      ) -> jax.Array:
    """(N, 1, W) placeholder threaded through shard_map when the placement
    has no host-resident tables (keeps the SPMD body signature uniform).

    When ``placement`` is given and it HAS host-resident tables, substituting
    the dummy would be a caller bug (params missing 'emb_h'): the translated
    host row indices address [0, host_local_rows) while the dummy has one
    row, and the PROMISE_IN_BOUNDS gathers/scatters would silently read
    garbage / corrupt memory — so fail loudly instead."""
    if placement is not None and placement.host_row_sharded:
        raise ValueError(
            f"placement has host-resident tables "
            f"{list(placement.host_row_sharded)} but no emb_h stack was "
            "passed — params are missing the pinned-host tier")
    return jnp.zeros((emb.shape[0], 1, emb.shape[-1]), emb.dtype)


def sharded_update_sgd(emb: jax.Array, ids: jax.Array, d_pooled: jax.Array,
                       lr, *, mesh: Mesh, placement: TablePlacement,
                       axis: str = "d", cs=(), emb_h=None,
                       block_leading: bool = False, exchange_dtype=None):
    """Apply the compressed embedding gradient (d loss / d pooled, shape
    (B, T, D) batch-sharded) to the sharded tables with SGD.  Returns
    (new_emb, new_emb_h, new_cs) — new_emb_h is None when the placement
    has no host-resident row-sharded tables.

    ``block_leading``: ids/d_pooled are (K, B, ...) — K micro-steps'
    gradients coalesced into one scatter pass (sharded_train_block)."""
    if emb.dtype == jnp.int8:
        raise ValueError("int8 quantized tables are inference-only; "
                         "train on f32/bf16 storage and quantize after")
    meta = placement_arrays(placement)
    has_host = emb_h is not None
    if not has_host:
        emb_h = _dummy_host_stack(emb, placement)
    body = functools.partial(
        _update_body, axis=axis, out_column=placement.out_column(),
        num_slots=placement.num_shards * placement.slots_per_shard,
        pack=placement.pack, placement=placement,
        block_leading=block_leading, dcn_axis=_dcn_axis(mesh, axis),
        exchange_dtype=exchange_dtype)
    batch_spec = _batch_spec(mesh, axis, leading=block_leading)
    new_emb, new_h, new_cs = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(axis), tuple(P(axis) for _ in cs), batch_spec,
                  batch_spec, P(), {k: P(axis) for k in meta}),
        out_specs=(P(axis), P(axis), tuple(P(axis) for _ in cs)),
        **_update_check_kw(_dcn_axis(mesh, axis)),
    )(emb, emb_h, tuple(cs), ids, d_pooled, jnp.asarray(lr, jnp.float32),
      meta)
    return new_emb, (new_h if has_host else None), new_cs
