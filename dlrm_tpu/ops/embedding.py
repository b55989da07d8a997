"""Embedding lookup with compressed sparse gradients.

Replaces the reference's EmbeddingTables.jl (SIMD gather/scatter kernels,
``maplookup`` strategies, ``SparseEmbeddingUpdate`` compressed gradients,
``SparseIndexer`` dedup — see SURVEY.md §2.2).  The design:

* All tables share one embedding dimension (as in the reference) and are
  **stacked row-wise into a single array** ``(total_rows, D)``.  A whole
  batch's lookups across all 26 tables become ONE ``take`` — one fused XLA
  gather instead of 26 small ones.  Per-table ids are translated by static
  row offsets.
* Multi-hot lookups are gathered as ``(B, T, H, D)`` and sum-pooled over H,
  matching EmbeddingTables' pooled lookup (verified bit-exact against
  ref/pytorch_reference_multi.hdf5: sum pooling, ids grouped per-sample).
* Gradients are never densified.  ``sparse_value_and_grad`` splits the
  gather out of the differentiated function, so autodiff produces the
  gradient w.r.t. the *gathered rows* — the exact analog of the reference's
  ``SparseEmbeddingUpdate{(grads, ids)}`` (train/train.jl:283-290) — and the
  optimizer applies it with a scatter-add.
* For plain SGD, scatter-add of per-hit contributions equals dedup-then-apply
  (the ``SparseIndexer`` path, train.jl:276-290): a row hit k times receives
  the summed gradient once.  ``dedup_sparse_grad`` provides explicit
  deduplication for optimizers that need per-unique-row semantics.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class SparseGrad(NamedTuple):
    """Compressed embedding gradient: ``rows[i]`` is the gradient w.r.t. the
    table row indexed by ``ids[i]`` (into the stacked table).  Duplicate ids
    mean contributions to be summed (scatter-add semantics)."""

    ids: jax.Array  # (n,) int32, indices into the stacked table
    rows: jax.Array  # (n, D)


def translate_ids(ids: jax.Array, offsets) -> jax.Array:
    """Translate per-table ids to stacked-table row indices.

    ``ids``: (T,), (B, T) or (B, T, H) int32, 0-based per-table row ids.
    ``offsets``: static per-table row offsets (config.table_offsets).

    Disambiguation is by RANK, never by axis length — when ``n_hot`` equals
    the table count a shape test on the last axis would silently add the
    offsets along the hot axis instead of the table axis.
    """
    offs = jnp.asarray(offsets, dtype=ids.dtype)
    if ids.ndim == 3:   # (B, T, H): broadcast offsets over the hot dim
        assert ids.shape[1] == len(offsets), (ids.shape, len(offsets))
        return ids + offs[:, None]
    assert ids.shape[-1] == len(offsets), (ids.shape, len(offsets))
    return ids + offs  # (T,) or (B, T)


def gather_rows(emb: jax.Array, flat_ids: jax.Array) -> jax.Array:
    """One fused gather of all lookups: ``(R, D)[ids] -> ids.shape + (D,)``."""
    return jnp.take(emb, flat_ids, axis=0)


def pool(rows: jax.Array) -> jax.Array:
    """Sum-pool the hot dimension: (B, T, H, D) -> (B, T, D); identity for
    one-hot (B, T, D) input."""
    if rows.ndim == 4:
        return jnp.sum(rows, axis=2)
    return rows


def lookup(emb: jax.Array, ids: jax.Array, offsets) -> jax.Array:
    """Full lookup: per-table ids -> pooled per-table embedding vectors.

    Differentiating through this produces a *dense* table gradient; use
    ``sparse_value_and_grad`` in training code.
    """
    return pool(gather_rows(emb, translate_ids(ids, offsets)))


def sparse_value_and_grad(
    loss_fn: Callable, *, has_aux: bool = False
) -> Callable:
    """Like ``jax.value_and_grad`` but with compressed embedding gradients.

    ``loss_fn(dense_params, pooled, *args)`` must consume the pooled lookup
    result ``(B, T, D)``.  The returned function has signature

        f(dense_params, emb, ids, offsets, *args) ->
            (value, (dense_grads, SparseGrad))

    The gather happens *outside* the differentiated region, so autodiff
    computes d(loss)/d(gathered rows) — shape (B, T[, H], D) — which is
    returned compressed as (flat_ids, rows).  This is the JAX
    equivalent of Zygote's pullback returning ``SparseEmbeddingUpdate``
    (reference train.jl:220-226, never densified).
    """

    def wrapped(dense_params, emb, ids, offsets, *args):
        flat = translate_ids(ids, offsets)
        rows = gather_rows(emb, flat)

        def inner(dp, r):
            return loss_fn(dp, pool(r), *args)

        out, (dgrads, drows) = jax.value_and_grad(
            inner, argnums=(0, 1), has_aux=has_aux
        )(dense_params, rows)
        sparse = SparseGrad(
            ids=flat.reshape(-1), rows=drows.reshape(-1, drows.shape[-1])
        )
        return out, (dgrads, sparse)

    return wrapped


def apply_sparse_sgd(emb: jax.Array, grad: SparseGrad, lr) -> jax.Array:
    """SGD step on the stacked table: ``emb[ids] -= lr * rows`` with duplicate
    ids accumulating (scatter-add).  Matches the reference's dedup-then-apply
    SGD exactly (sum of per-hit gradients applied once, train.jl:283-290)."""
    return emb.at[grad.ids].add(
        (-lr * grad.rows).astype(emb.dtype), mode="drop"
    )


def dedup_sparse_grad(grad: SparseGrad, *, max_unique: int | None = None
                      ) -> SparseGrad:
    """Combine duplicate ids by summation (the ``SparseIndexer`` analog).

    Returns a SparseGrad with ``max_unique`` entries (default: same length),
    where surplus slots carry id ``-1`` and zero rows (dropped by
    ``.at[].add(mode='drop')``).  Static output shape: sort ids, segment-sum
    runs of equal ids into the position of each run head.

    CALLER INVARIANT: ``max_unique`` must be >= the true number of
    distinct ids — segment ids past it are silently dropped by
    segment_sum (gradient mass lost, no error).  The default (the input
    length) is always safe; every in-repo caller uses it.
    """
    n = grad.ids.shape[0]
    if max_unique is None:
        max_unique = n
    order = jnp.argsort(grad.ids)
    sids = grad.ids[order]
    srows = grad.rows[order]
    # Run heads: first occurrence of each unique id in the sorted order.
    heads = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), sids[1:] != sids[:-1]]
    )
    # Position of each element's run head.
    seg = jnp.cumsum(heads.astype(jnp.int32)) - 1  # (n,), values in [0, n)
    summed = jax.ops.segment_sum(srows, seg, num_segments=max_unique)
    uniq = jax.ops.segment_max(
        jnp.where(heads, sids, -1), seg, num_segments=max_unique
    )
    n_uniq = seg[-1] + 1
    slot = jnp.arange(max_unique)
    uniq = jnp.where(slot < n_uniq, uniq, -1)
    return SparseGrad(ids=uniq, rows=summed)


# -- lane-packed, chunked storage (the engine format) ------------------------
#
# The storage layout:
#
# 1. PACK = 128 // D logical rows share each 128-wide physical row, so a
#    narrow (R, 16) table is gathered and scattered as whole 512-byte
#    rows.
# 2. The stack is split into chunks of <= config.chunk_budget_bytes (whole
#    tables, first-fit-decreasing); per-chunk scatters are independent ops
#    XLA can overlap.
#
# Both were tuned on the previous accelerator; whether they pay on the GPU
# is not yet measured.
#
# Engine format: ``emb`` is a TUPLE of per-chunk (rows, row_width) arrays.
# Tables are padded to whole physical rows (tables never share one); slot
# extraction/expansion are elementwise selects, exact at any matmul
# precision.  This replaces the reference's SIMD-width-aware row layout
# concerns (EmbeddingTables.jl SIMD kernels).

def pack_tables(emb, config):
    """(total_rows, D) logical stack -> tuple of per-chunk packed arrays."""
    if not config.is_packed:
        return emb
    xp = jnp if isinstance(emb, jax.Array) else np
    d = config.feature_size
    p = config.pack
    w = config.row_width
    chunks = [[] for _ in range(config.num_chunks)]
    for t in range(config.num_tables):
        off, n = config.table_offsets[t], config.table_sizes[t]
        tab = emb[off:off + n]
        pad = config.packed_table_rows[t] * p - n
        if pad:
            tab = xp.concatenate(
                [tab, xp.zeros((pad, d), tab.dtype)], axis=0)
        chunks[config.table_chunk[t]].append(tab.reshape(-1, w))
    return tuple(xp.concatenate(c, axis=0) for c in chunks)


def unpack_tables(emb, config):
    """Inverse of :func:`pack_tables` (accepts plain storage unchanged)."""
    if not isinstance(emb, (tuple, list)):
        return emb
    xp = jnp if isinstance(emb[0], jax.Array) else np
    return xp.concatenate(
        [get_logical_table(emb, config, t)
         for t in range(config.num_tables)], axis=0)


def get_logical_table(emb, config, t: int) -> jax.Array:
    """Table ``t`` as a logical (rows, D) array from either storage."""
    if isinstance(emb, (tuple, list)):
        c = config.table_chunk[t]
        po = config.chunk_table_offsets[t]
        pn = config.packed_table_rows[t]
        return emb[c][po:po + pn].reshape(-1, config.feature_size)[
            :config.table_sizes[t]]
    off = config.table_offsets[t]
    return emb[off:off + config.table_sizes[t]]


def check_storage(emb, config) -> None:
    """Trace-time guard: chunk shapes must match the config's geometry.

    Chunk assignment depends on table sizes AND the storage dtype's bytes
    (chunk_budget_bytes), so arrays packed under one config are silently
    wrong under another — convert via unpack -> cast -> pack_tables.
    """
    from dlrm_tpu.ops import quant
    if isinstance(emb, quant.QuantEmb):
        quant.check_quant_storage(emb, config)
        return
    if not isinstance(emb, (tuple, list)):
        if config.is_packed:
            raise ValueError(
                "config.is_packed but params['emb'] is a single array; "
                "build params with init_params or pack_tables")
        return
    shapes = tuple(tuple(c.shape) for c in emb)
    if shapes != config.emb_shapes:
        raise ValueError(
            f"embedding chunk shapes {shapes} do not match the config's "
            f"{config.emb_shapes}; if you changed table sizes, dtype, or "
            "chunk_budget_bytes, repack via unpack_tables -> pack_tables")


def chunk_groups(config, tables):
    """Group a table-index list by storage chunk.

    Returns [(chunk_index, positions, table_indices)] where ``positions``
    index into the ``tables`` axis of an ids/grads array.
    """
    groups = {}
    for pos, t in enumerate(tables):
        groups.setdefault(config.table_chunk[t], ([], []))
        groups[config.table_chunk[t]][0].append(pos)
        groups[config.table_chunk[t]][1].append(t)
    return [(c, tuple(pos), tuple(ts))
            for c, (pos, ts) in sorted(groups.items())]


def chunk_translate(ids: jax.Array, config, tables):
    """Per-table ids (for ``tables``, all in ONE chunk) -> (chunk-local
    physical row, slot)."""
    p = config.pack
    po = jnp.asarray([config.chunk_table_offsets[t] for t in tables],
                     ids.dtype)
    if ids.ndim == 3:  # (B, T, H): broadcast offsets over the hot dim
        po = po[:, None]
    if p == 1:
        return po + ids, jnp.zeros_like(ids)
    return po + ids // p, ids % p


def _slot_mask(slot: jax.Array, pack: int) -> jax.Array:
    """(..., pack, 1) boolean: True at each row's own slot."""
    return (jnp.arange(pack, dtype=slot.dtype) == slot[..., None])[..., None]


def extract_slots(g128: jax.Array, slot: jax.Array, config=None, *,
                  pack: int = None, d: int = None) -> jax.Array:
    """(..., row_width) gathered physical rows + slot -> (..., D) logical
    rows.  Geometry from ``config`` or explicit ``pack``/``d``.

    An elementwise select and a sum of one value with zeros, so the stored
    row comes back bit for bit.  (A one-hot matmul would run in TF32 at
    the GPU's default precision and round table values to 10 mantissa
    bits; the select is also faster, measured in PERF.md.)"""
    if pack is None:
        pack, d = config.pack, config.feature_size
    g = g128.reshape(g128.shape[:-1] + (pack, d))
    return jnp.sum(jnp.where(_slot_mask(slot, pack), g,
                             jnp.zeros((), g.dtype)), axis=-2, dtype=g.dtype)


def expand_slots(rows: jax.Array, slot: jax.Array, config=None, *,
                 pack: int = None) -> jax.Array:
    """(..., D) update rows + slot -> (..., D*pack) physical-row updates
    with zeros in the other slots (transpose of :func:`extract_slots`;
    exact, an elementwise select)."""
    if pack is None:
        pack = config.pack
    out = jnp.where(_slot_mask(slot, pack), rows[..., None, :],
                    jnp.zeros((), rows.dtype))
    return out.reshape(rows.shape[:-1] + (pack * rows.shape[-1],))


def chunk_gather(chunk: jax.Array, phys: jax.Array, slot: jax.Array,
                 config) -> jax.Array:
    """Gather logical rows from one chunk: phys/slot of any shape
    -> shape + (D,)."""
    g = jnp.take(chunk, phys, axis=0)
    if config.pack == 1:
        return g
    return extract_slots(g, slot, config)


def chunk_apply_sgd(chunk: jax.Array, phys: jax.Array, slot: jax.Array,
                    d_rows: jax.Array, lr, config) -> jax.Array:
    """SGD scatter-add on one chunk: chunk[phys, slot] -= lr*d_rows.

    Collisions — same physical row hit from different slots, or duplicate
    logical rows — sum correctly because the expanded row_width updates are
    zero outside their slot and scatter-add accumulates."""
    upd = (-lr * d_rows).astype(chunk.dtype)
    if config.pack > 1:
        upd = expand_slots(upd, slot, config)
    w = chunk.shape[1]
    return chunk.at[phys.reshape(-1)].add(
        upd.reshape(-1, w).astype(chunk.dtype), mode="drop")


def apply_sgd_chunked(emb, ids: jax.Array, d_rows: jax.Array, lr, config,
                      tables=None):
    """SGD scatter-add of per-table gradient rows into the chunked stack.

    ``ids``: (B, T[, H]) for ``tables`` (default all); ``d_rows`` the
    matching (B, T[, H], D) gradient rows.  Returns the new chunk tuple —
    one independent scatter per chunk (they overlap on device).
    """
    if tables is None:
        tables = tuple(range(config.num_tables))
    new = list(emb)
    for c, pos, ts in chunk_groups(config, tuple(tables)):
        ids_g = ids[:, pos] if ids.ndim == 2 else ids[:, pos, :]
        d_g = d_rows[:, pos] if d_rows.ndim == 3 else d_rows[:, pos, :, :]
        phys, slot = chunk_translate(ids_g, config, ts)
        new[c] = chunk_apply_sgd(new[c], phys, slot, d_g, lr, config)
    return tuple(new)


def partition_tables(table_sizes, threshold: int):
    """Split tables into (small, big) index lists by row count.

    Strategy selection for the mixed embedding engine: small tables are
    looked up inside the differentiated function (:func:`small_table_lookup`)
    so autodiff hands back a dense (R, D) table gradient, applied as one
    contiguous add; big tables keep compressed (ids, rows) gradients and a
    scatter-add.  The analog of the reference's pluggable lookup
    strategies (EmbeddingTables maplookup strategies, SURVEY.md §2.2).
    """
    small = [i for i, s in enumerate(table_sizes) if s <= threshold]
    big = [i for i, s in enumerate(table_sizes) if s > threshold]
    return tuple(small), tuple(big)


def small_table_lookup(table: jax.Array, ids: jax.Array,
                       compute_dtype=jnp.bfloat16) -> jax.Array:
    """Pooled lookup of a small logical (R, D) table: (B[, H]) ids ->
    (B, D) float32.

    A gather, so stored rows come back exactly at any matmul precision.
    Differentiable: the table cotangent is a DENSE (R, D) gradient (a
    scatter-add into zeros), which is what the callers apply as one
    contiguous add — fine precisely because R is small.  Multi-hot ids are
    summed in float32.

    ``compute_dtype`` rounds the looked-up values (bf16 under --bf16,
    consistent with bf16 compute everywhere else in that mode; it makes
    results discontinuous in table size at small_table_threshold, since
    big tables' gathers keep full precision).
    """
    rows = jnp.take(table, ids, axis=0).astype(compute_dtype).astype(
        jnp.float32)
    if rows.ndim == 3:  # (B, H, D) multi-hot: sum-pool the hot dim
        rows = jnp.sum(rows, axis=1)
    return rows


def table_order_permutation(small, big) -> Tuple[int, ...]:
    """Permutation restoring global table order from [big..., small...]
    column blocks."""
    order = list(big) + list(small)
    inv = [0] * len(order)
    for pos, t in enumerate(order):
        inv[t] = pos
    return tuple(inv)


def gather_tables(emb, ids: jax.Array, config, tables=None) -> jax.Array:
    """Un-pooled gather of per-table ids from either storage layout.

    ``ids``: (B, T[, H]) for the table subset ``tables`` (default all);
    returns ids.shape + (D,).  Engine storage: one fused take per chunk,
    results re-assembled into ``tables`` order.
    """
    if tables is None:
        tables = tuple(range(config.num_tables))
    tables = tuple(tables)
    if not isinstance(emb, (tuple, list)):
        offs = tuple(config.table_offsets[t] for t in tables)
        return gather_rows(emb, translate_ids(ids, offs))
    groups = chunk_groups(config, tables)
    parts = []
    order = []
    for c, pos, ts in groups:
        ids_g = ids[:, pos] if ids.ndim == 2 else ids[:, pos, :]
        phys, slot = chunk_translate(ids_g, config, ts)
        parts.append(chunk_gather(emb[c], phys, slot, config))
        order.extend(pos)
    if len(parts) == 1 and order == list(range(len(tables))):
        return parts[0]
    stacked = jnp.concatenate(parts, axis=1)
    inv = np.argsort(np.asarray(order))
    return jnp.take(stacked, jnp.asarray(inv), axis=1)


def mixed_lookup(emb: jax.Array, ids: jax.Array, config,
                 small_dtype=None) -> jax.Array:
    """Pooled lookup using the per-table strategy split: gather for big
    tables (one fused take, lane-packed when config.is_packed), a
    differentiable per-table take for small ones.  Differentiable end-to-end (big-table grads
    densify under plain jax.grad — training uses the machinery in
    train/train.py to keep them compressed).

    Dispatches on the storage type: int8-quantized storage (ops/quant.py
    QuantEmb, the serving path) routes to the dequantizing lookup so the
    model forward — and everything built on it — serves quantized tables
    unchanged."""
    from dlrm_tpu.ops import quant
    if isinstance(emb, quant.QuantEmb):
        return quant.quant_mixed_lookup(emb, ids, config)
    small, big = partition_tables(config.table_sizes,
                                  config.small_table_threshold)
    if not small:
        return pool(gather_tables(emb, ids, config))
    if small_dtype is None:
        small_dtype = config.compute_dtype
    parts = []
    if big:
        ids_big = ids[:, big] if ids.ndim == 2 else ids[:, big, :]
        parts.append(pool(gather_tables(emb, ids_big, config, big)))
    for t in small:
        tab = get_logical_table(emb, config, t)
        idt = ids[:, t] if ids.ndim == 2 else ids[:, t, :]
        parts.append(small_table_lookup(tab, idt, small_dtype)[:, None, :])
    emb_dtype = emb[0].dtype if isinstance(emb, (tuple, list)) else emb.dtype
    stacked = jnp.concatenate(parts, axis=1).astype(emb_dtype)
    return stacked[:, table_order_permutation(small, big), :]


def uncompress(grad: SparseGrad, total_rows: int, dim: int) -> jax.Array:
    """Densify a SparseGrad (test oracle; mirrors EmbeddingTables.uncompress
    used by reference test/train/backprop.jl:156)."""
    dense = jnp.zeros((total_rows, dim), grad.rows.dtype)
    return dense.at[grad.ids].add(grad.rows, mode="drop")
