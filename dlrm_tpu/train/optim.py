"""Optimizers: plain SGD (the reference's only optimizer, Flux.Descent)
plus sparse-aware Adagrad — the standard DLRM optimizer the reference
lacks.

Dense parameters (MLP weights/biases) go through optax.  Embedding tables
need special treatment: their gradients exist only as compressed
``d(loss)/d(gathered rows)`` and the optimizer state (Adagrad accumulator)
lives in the same chunked lane-packed storage as the tables, so a step
touches only the hit rows.

Duplicate-id semantics (a row hit k times in one batch) follow the
reference's dedup-then-apply contract (SparseIndexer + apply!, reference
train/train.jl:276-290): the k gradient contributions are SUMMED and the
optimizer update is applied ONCE with the summed gradient.  For SGD
scatter-add gives that for free; for Adagrad the accumulator update
depends nonlinearly on the summed gradient, so duplicates are explicitly
combined first (sort + segment-sum per chunk, static shapes).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

try:
    import optax
except ImportError:  # pragma: no cover
    optax = None

from dlrm_tpu.config import DLRMConfig
from dlrm_tpu.ops import embedding as emb_ops


class EmbAdagradState(NamedTuple):
    """Per-chunk Adagrad accumulators, same storage layout as the tables."""

    acc: Tuple[jax.Array, ...]


class EmbRowwiseAdagradState(NamedTuple):
    """Row-wise Adagrad accumulators: ONE f32 scalar per LOGICAL row —
    per-chunk (chunk_rows, pack) arrays, 1/D the elementwise
    accumulator's memory (the torchrec ROWWISE_ADAGRAD layout, the
    de-facto production DLRM optimizer)."""

    acc: Tuple[jax.Array, ...]


def init_emb_state(config: DLRMConfig, optimizer: str, emb,
                   init_acc: float = 0.0):
    if optimizer == "sgd":
        return ()
    if optimizer == "adagrad":
        if isinstance(emb, (tuple, list)):
            return EmbAdagradState(acc=tuple(
                jnp.full(c.shape, init_acc, jnp.float32) for c in emb))
        return EmbAdagradState(
            acc=(jnp.full(emb.shape, init_acc, jnp.float32),))
    if optimizer == "rowwise_adagrad":
        assert isinstance(emb, (tuple, list)), \
            "rowwise_adagrad requires engine (chunked) storage"
        return EmbRowwiseAdagradState(acc=tuple(
            jnp.full((c.shape[0], config.pack), init_acc, jnp.float32)
            for c in emb))
    raise ValueError(f"unknown optimizer {optimizer!r}")


def clip_by_global_norm(max_norm, grads):
    """Scale a gradient pytree by ``min(1, max_norm / ||grads||_2)``.

    The norm is taken over EVERYTHING the step's autodiff produced —
    dense-tower grads plus the embedding cotangent in whatever
    decomposition the step uses (per-hit gathered rows, pooled (B,T,D),
    dense small-table grads).  Per-hit embedding entries therefore count
    once per hit, exactly like the gradient of the unrolled lookup —
    NOT the deduped parameter-space gradient (summing duplicates first
    would cost an argsort per step; torchrec's clipping makes the same
    choice).

    What it does and does NOT stabilize (measured,
    tests/test_grad_clip.py): under SGD the update is lr*g, so clipping
    directly bounds the step (hot-lr runs that blow into the BCE clamp
    train normally with a tight clip).  Adagrad-family sparse steps are
    g*rsqrt(acc(g^2)) — INVARIANT to gradient scale — so clipping does
    not substitute for lr choice there (at fs=128 lr=0.05 saturates the
    interaction inputs and lr=0.002 trains); it still bounds the dense towers and
    one-off outlier batches once accumulators are warm.  Returns
    (clipped_grads, global_norm)."""
    leaves = jax.tree.leaves(grads)
    sq = sum(jnp.sum(jnp.square(g.astype(jnp.float32))) for g in leaves)
    gnorm = jnp.sqrt(sq)
    scale = jnp.minimum(1.0, max_norm / jnp.maximum(gnorm, 1e-12))
    return jax.tree.map(
        lambda g: (g.astype(jnp.float32) * scale).astype(g.dtype),
        grads), gnorm


def dense_optimizer(optimizer: str, lr):
    """optax transform for the dense (MLP) parameters.  ``lr`` may be a
    float or an optax schedule.  rowwise_adagrad applies to EMBEDDING
    rows only — dense params get elementwise adagrad (torchrec does the
    same: rowwise is a table-sharding-era memory optimization)."""
    assert optax is not None, "optax required"
    if optimizer == "sgd":
        return optax.sgd(lr)
    if optimizer in ("adagrad", "rowwise_adagrad"):
        return optax.adagrad(lr, initial_accumulator_value=0.0, eps=1e-10)
    raise ValueError(f"unknown optimizer {optimizer!r}")


def make_schedule(base_lr: float, *, schedule: str = "constant",
                  warmup_steps: int = 0, decay_start: int = 0,
                  decay_steps: int = 0, end_lr_scale: float = 0.0):
    """Learning-rate schedule factory (MLPerf DLRM uses linear warmup +
    polynomial decay; the reference uses a constant lr).

    Returns a callable step -> lr usable by optax and by the sparse update
    (evaluate it on the step counter and pass the scalar as ``lr``).
    """
    assert optax is not None, "optax required"
    if schedule == "constant":
        return optax.constant_schedule(base_lr)
    if schedule == "warmup_poly_decay":
        fns = []
        bounds = []
        if warmup_steps > 0:
            fns.append(optax.linear_schedule(0.0, base_lr, warmup_steps))
            bounds.append(warmup_steps)
        hold = max(decay_start - warmup_steps, 0)
        if hold:
            fns.append(optax.constant_schedule(base_lr))
            bounds.append(decay_start)
        fns.append(optax.polynomial_schedule(
            base_lr, base_lr * end_lr_scale, power=2,
            transition_steps=max(decay_steps, 1)))
        if len(fns) == 1:
            return fns[0]
        return optax.join_schedules(fns, bounds)
    raise ValueError(f"unknown schedule {schedule!r}")


def _dedup_rows(ids: jax.Array, rows: jax.Array):
    """Sum rows of duplicate ids; returns (ids', rows') of the same static
    shape where surplus slots carry id -1 (dropped by scatter mode='drop')
    and zero rows.  Thin unwrap of ops/embedding.dedup_sparse_grad (the
    SparseIndexer analog)."""
    out = emb_ops.dedup_sparse_grad(emb_ops.SparseGrad(ids, rows))
    return out.ids, out.rows


def apply_adagrad_chunked(emb, state: EmbAdagradState, ids: jax.Array,
                          d_rows: jax.Array, lr, config: DLRMConfig,
                          tables=None, eps: float = 1e-10,
                          d_rows_scaled=None):
    """Exact sparse Adagrad on the chunked stack.

    Per unique hit row r (duplicates pre-summed): ``acc[r] += g^2`` then
    ``w[r] -= lr * g / (sqrt(acc[r]) + eps)`` — elementwise, matching
    optax.adagrad on a dense gradient restricted to hit rows.

    ``d_rows_scaled``: optional pre-lr-scaled gradient rows for the
    COALESCED BLOCK path with a per-micro-step lr schedule: the dedup then
    sums (g, lr_k*g) jointly per key, the accumulator folds in
    ``(sum g)^2`` and the weight step applies ``sum(lr_k*g) * rsqrt(...)``
    — for a row hit in exactly one micro-step this is that step's exact
    update.  ``lr`` is ignored for the row update when given.
    """
    if tables is None:
        tables = tuple(range(config.num_tables))
    new_emb = list(emb)
    new_acc = list(state.acc)
    d = config.feature_size
    for c, pos, ts in emb_ops.chunk_groups(config, tuple(tables)):
        ids_g = ids[:, pos] if ids.ndim == 2 else ids[:, pos, :]
        d_g = d_rows[:, pos] if d_rows.ndim == 3 else d_rows[:, pos, :, :]
        phys, slot = emb_ops.chunk_translate(ids_g, config, ts)
        # flatten to logical row granularity: key = phys * pack + slot
        pack = config.pack
        key = (phys * pack + slot).reshape(-1)
        g = d_g.reshape(-1, d).astype(jnp.float32)
        if d_rows_scaled is not None:
            s_g = (d_rows_scaled[:, pos] if d_rows_scaled.ndim == 3
                   else d_rows_scaled[:, pos, :, :])
            # twin payload through ONE dedup: per-key sums of g and lr*g
            g = jnp.concatenate(
                [g, s_g.reshape(-1, d).astype(jnp.float32)], axis=-1)
        key_u, g_u = _dedup_rows(key, g)
        if d_rows_scaled is not None:
            g_u, gs_u = g_u[:, :d], g_u[:, d:]
        phys_u = jnp.where(key_u >= 0, key_u // pack, -1)
        slot_u = jnp.where(key_u >= 0, key_u % pack, 0)
        # gather current accumulator rows, fold in g^2
        acc_rows = emb_ops.chunk_gather(new_acc[c], phys_u, slot_u, config)
        acc_new = acc_rows + g_u * g_u
        delta_acc = g_u * g_u
        with jax.named_scope("adagrad_acc_update"):
            new_acc[c] = emb_ops.chunk_apply_sgd(
                new_acc[c], phys_u, slot_u, delta_acc, -1.0, config)
        # matches optax.scale_by_rss: g * rsqrt(acc + eps), 0 where acc == 0
        rs = jnp.where(acc_new > 0, jax.lax.rsqrt(acc_new + eps), 0.0)
        with jax.named_scope("adagrad_row_update"):
            if d_rows_scaled is not None:
                new_emb[c] = emb_ops.chunk_apply_sgd(
                    new_emb[c], phys_u, slot_u, gs_u * rs, 1.0, config)
            else:
                new_emb[c] = emb_ops.chunk_apply_sgd(
                    new_emb[c], phys_u, slot_u, g_u * rs, lr, config)
    return tuple(new_emb), EmbAdagradState(acc=tuple(new_acc))


def apply_adagrad_dense_g(emb, state: EmbAdagradState, ids: jax.Array,
                          d_rows: jax.Array, lr, config: DLRMConfig,
                          tables=None, eps: float = 1e-10,
                          d_rows_scaled=None):
    """Exact sparse Adagrad via a DENSE per-chunk gradient buffer — the
    fast path for COALESCED BLOCKS.

    Per chunk: scatter-add the raw gradient rows into a zeros buffer G
    (duplicates sum exactly — the dedup-then-apply contract for free),
    then one elementwise pass ``acc += G^2; w -= lr * G * rsqrt(acc+eps)``
    over the whole chunk.  Untouched rows have G == 0 and round-trip
    unchanged, so the result is bit-equivalent to
    :func:`apply_adagrad_chunked` without its argsort, accumulator gather,
    or second scatter.  Cost: ONE scatter (same as SGD) + ~5 chunk-sized
    memory passes + a chunk-sized f32 transient — which AMORTIZES over a
    K-step block while the argsort grows with K*B.

    ``d_rows_scaled``: see :func:`apply_adagrad_chunked` (per-micro-step
    lr schedules); adds a second dense buffer.
    """
    if tables is None:
        tables = tuple(range(config.num_tables))
    new_emb = list(emb)
    new_acc = list(state.acc)
    for c, pos, ts in emb_ops.chunk_groups(config, tuple(tables)):
        ids_g = ids[:, pos] if ids.ndim == 2 else ids[:, pos, :]
        d_g = d_rows[:, pos] if d_rows.ndim == 3 else d_rows[:, pos, :, :]
        phys, slot = emb_ops.chunk_translate(ids_g, config, ts)
        w = new_emb[c].shape[1]

        def densify(rows):
            g = rows.astype(jnp.float32)
            if config.pack > 1:
                g = emb_ops.expand_slots(g, slot, config)
            return jnp.zeros((new_emb[c].shape[0], w), jnp.float32).at[
                phys.reshape(-1)].add(g.reshape(-1, w), mode="drop")

        with jax.named_scope("adagrad_densify_g"):
            G = densify(d_g)
        acc_new = new_acc[c] + G * G
        rs = jnp.where(acc_new > 0, jax.lax.rsqrt(acc_new + eps), 0.0)
        step = d_rows_scaled
        if step is not None:
            s_g = (step[:, pos] if step.ndim == 3 else step[:, pos, :, :])
            with jax.named_scope("adagrad_densify_scaled"):
                Gs = densify(s_g)
            upd = Gs * rs
        else:
            upd = (lr * G) * rs
        with jax.named_scope("adagrad_dense_apply"):
            new_emb[c] = (new_emb[c]
                          - upd.astype(new_emb[c].dtype)).astype(
                              new_emb[c].dtype)
        new_acc[c] = acc_new
    return tuple(new_emb), EmbAdagradState(acc=tuple(new_acc))


def split_tables_by_chunk_bytes(config: DLRMConfig, tables,
                                max_bytes: int):
    """Partition ``tables`` by their storage CHUNK's byte size: tables in
    chunks <= ``max_bytes`` (where full-chunk elementwise passes are
    cheap) vs tables in bigger chunks.  Whole chunks stay together —
    both apply fns operate per chunk."""
    small, big = [], []
    itemsize = jnp.dtype(config.embedding_dtype).itemsize
    for c, pos, ts in emb_ops.chunk_groups(config, tuple(tables)):
        rows, width = config.emb_shapes[c]
        (small if rows * width * itemsize <= max_bytes else big).extend(ts)
    return tuple(small), tuple(big)


def apply_adagrad_hybrid(emb, state: EmbAdagradState, ids: jax.Array,
                         d_rows: jax.Array, lr, config: DLRMConfig,
                         tables=None, eps: float = 1e-10,
                         d_rows_scaled=None,
                         dense_g_max_bytes: int = 400 << 20,
                         rowwise: bool = False):
    """Exact sparse Adagrad with PER-CHUNK implementation selection.

    The two exact implementations have complementary cost shapes:
      * dedup (:func:`apply_adagrad_chunked`): argsort over the chunk's
        ids + accumulator gather + 2 scatters — cost scales with the
        chunk's ID COUNT, independent of chunk size.  Right for the deep
        sparse chunks (100s of MB, few ids each).
      * dense-G (:func:`apply_adagrad_dense_g`): one scatter + ~6
        full-chunk elementwise passes — cost scales with CHUNK BYTES,
        independent of collisions.  Right for the small/mid chunks (the
        16 MB shared chunks holding the collision-heavy tables, where the
        dedup argsort is most expensive and full passes are ~free).
    This selects per chunk by ``dense_g_max_bytes`` and runs both.  Both
    are exact (dedup-then-apply semantics), so the split is purely a
    performance choice; results are independent of the threshold.  The
    400 MB default (dense-G for every chunk except the three biggest of
    Kaggle fs=16) was tuned on the previous accelerator and is not yet
    measured on the GPU; dense-G chunks also compile much faster (the
    per-chunk argsorts dominate XLA compile time)."""
    if tables is None:
        tables = tuple(range(config.num_tables))
    dg_tabs, dd_tabs = split_tables_by_chunk_bytes(config, tables,
                                                   dense_g_max_bytes)
    pos_of = {t: i for i, t in enumerate(tables)}

    def cols(arr, ts):
        idx = jnp.asarray([pos_of[t] for t in ts])
        return jnp.take(arr, idx, axis=1)

    dense_fn = (apply_rowwise_adagrad_dense_g if rowwise
                else apply_adagrad_dense_g)
    dedup_fn = (apply_rowwise_adagrad_chunked if rowwise
                else apply_adagrad_chunked)
    if dg_tabs:
        emb, state = dense_fn(
            emb, state, cols(ids, dg_tabs), cols(d_rows, dg_tabs), lr,
            config, dg_tabs, eps=eps,
            d_rows_scaled=(cols(d_rows_scaled, dg_tabs)
                           if d_rows_scaled is not None else None))
    if dd_tabs:
        emb, state = dedup_fn(
            emb, state, cols(ids, dd_tabs), cols(d_rows, dd_tabs), lr,
            config, dd_tabs, eps=eps,
            d_rows_scaled=(cols(d_rows_scaled, dd_tabs)
                           if d_rows_scaled is not None else None))
    return emb, state


def apply_adagrad_dense_table(table: jax.Array, acc: jax.Array,
                              grad: jax.Array, lr, eps: float = 1e-10):
    """Adagrad on a whole (small) table with a dense gradient (same
    formula as optax.scale_by_rss)."""
    acc_new = acc + grad.astype(jnp.float32) ** 2
    step = grad * jnp.where(acc_new > 0, jax.lax.rsqrt(acc_new + eps), 0.0)
    return (table - lr * step.astype(table.dtype)).astype(table.dtype), \
        acc_new


# -- row-wise Adagrad (the torchrec ROWWISE_ADAGRAD analog) -------------------
#
# One accumulator scalar per logical ROW: acc[r] += mean_D(g_r^2), then
# w[r] -= lr * g_r * rsqrt(acc[r] + eps) — 1/D the optimizer memory of
# elementwise Adagrad (135 MB vs 2.16 GB at Kaggle fs=16) with the same
# per-row adaptivity; the de-facto production DLRM embedding optimizer.
# Duplicate-id semantics follow the same dedup-then-apply contract: a
# row's contributions are summed BEFORE the nonlinear update.

def apply_rowwise_adagrad_chunked(emb, state: EmbRowwiseAdagradState,
                                  ids: jax.Array, d_rows: jax.Array, lr,
                                  config: DLRMConfig, tables=None,
                                  eps: float = 1e-10, d_rows_scaled=None):
    """Exact sparse row-wise Adagrad on the chunked stack (dedup path);
    mirrors :func:`apply_adagrad_chunked` with a (chunk_rows, pack)
    scalar-per-row accumulator."""
    if tables is None:
        tables = tuple(range(config.num_tables))
    new_emb = list(emb)
    new_acc = list(state.acc)
    d = config.feature_size
    pack = config.pack
    for c, pos, ts in emb_ops.chunk_groups(config, tuple(tables)):
        ids_g = ids[:, pos] if ids.ndim == 2 else ids[:, pos, :]
        d_g = d_rows[:, pos] if d_rows.ndim == 3 else d_rows[:, pos, :, :]
        phys, slot = emb_ops.chunk_translate(ids_g, config, ts)
        key = (phys * pack + slot).reshape(-1)
        g = d_g.reshape(-1, d).astype(jnp.float32)
        if d_rows_scaled is not None:
            s_g = (d_rows_scaled[:, pos] if d_rows_scaled.ndim == 3
                   else d_rows_scaled[:, pos, :, :])
            g = jnp.concatenate(
                [g, s_g.reshape(-1, d).astype(jnp.float32)], axis=-1)
        key_u, g_u = _dedup_rows(key, g)
        gs_u = None
        if d_rows_scaled is not None:
            g_u, gs_u = g_u[:, :d], g_u[:, d:]
        phys_u = jnp.where(key_u >= 0, key_u // pack, -1)
        slot_u = jnp.where(key_u >= 0, key_u % pack, 0)
        g2m = jnp.mean(g_u * g_u, axis=-1)           # scalar per row
        # flat (rows*pack,) indexing by the logical-row key: 1-D gather +
        # scatter lower far better than 2-D (phys, slot) indexing;
        # surplus slots carry key -1 (dropped) and g2m == 0
        acc_flat = new_acc[c].reshape(-1)
        acc_new = acc_flat[key_u] + g2m
        with jax.named_scope("rowwise_acc_update"):
            new_acc[c] = acc_flat.at[key_u].add(
                g2m, mode="drop").reshape(new_acc[c].shape)
        rs = jnp.where(acc_new > 0, jax.lax.rsqrt(acc_new + eps), 0.0)
        with jax.named_scope("rowwise_row_update"):
            if gs_u is not None:
                new_emb[c] = emb_ops.chunk_apply_sgd(
                    new_emb[c], phys_u, slot_u, gs_u * rs[:, None], 1.0,
                    config)
            else:
                new_emb[c] = emb_ops.chunk_apply_sgd(
                    new_emb[c], phys_u, slot_u, g_u * rs[:, None], lr,
                    config)
    return tuple(new_emb), EmbRowwiseAdagradState(acc=tuple(new_acc))


def apply_rowwise_adagrad_dense_g(emb, state: EmbRowwiseAdagradState,
                                  ids: jax.Array, d_rows: jax.Array, lr,
                                  config: DLRMConfig, tables=None,
                                  eps: float = 1e-10, d_rows_scaled=None):
    """Dense-G row-wise Adagrad (block fast path; see
    :func:`apply_adagrad_dense_g` for the trick): the per-row mean of G^2
    reduces the dense buffer straight into the (chunk_rows, pack)
    accumulator; untouched rows round-trip unchanged."""
    if tables is None:
        tables = tuple(range(config.num_tables))
    new_emb = list(emb)
    new_acc = list(state.acc)
    d = config.feature_size
    pack = config.pack
    for c, pos, ts in emb_ops.chunk_groups(config, tuple(tables)):
        ids_g = ids[:, pos] if ids.ndim == 2 else ids[:, pos, :]
        d_g = d_rows[:, pos] if d_rows.ndim == 3 else d_rows[:, pos, :, :]
        phys, slot = emb_ops.chunk_translate(ids_g, config, ts)
        rows, w = new_emb[c].shape

        def densify(r_):
            g = r_.astype(jnp.float32)
            if pack > 1:
                g = emb_ops.expand_slots(g, slot, config)
            return jnp.zeros((rows, w), jnp.float32).at[
                phys.reshape(-1)].add(g.reshape(-1, w), mode="drop")

        with jax.named_scope("rowwise_densify_g"):
            G = densify(d_g)
        g2m = jnp.mean((G * G).reshape(rows, pack, d), axis=-1)
        acc_new = new_acc[c] + g2m                    # (rows, pack)
        rs = jnp.where(acc_new > 0, jax.lax.rsqrt(acc_new + eps), 0.0)
        rs_full = jnp.broadcast_to(rs[:, :, None],
                                   (rows, pack, d)).reshape(rows, w)
        if d_rows_scaled is not None:
            s_g = (d_rows_scaled[:, pos] if d_rows_scaled.ndim == 3
                   else d_rows_scaled[:, pos, :, :])
            with jax.named_scope("rowwise_densify_scaled"):
                upd = densify(s_g) * rs_full
        else:
            upd = (lr * G) * rs_full
        with jax.named_scope("rowwise_dense_apply"):
            new_emb[c] = (new_emb[c]
                          - upd.astype(new_emb[c].dtype)).astype(
                              new_emb[c].dtype)
        new_acc[c] = acc_new
    return tuple(new_emb), EmbRowwiseAdagradState(acc=tuple(new_acc))


def apply_rowwise_adagrad_dense_table(table: jax.Array, acc: jax.Array,
                                      grad: jax.Array, lr,
                                      eps: float = 1e-10):
    """Row-wise Adagrad on a whole (small) table with a dense gradient:
    ``acc`` is (R,) — one scalar per row."""
    g = grad.astype(jnp.float32)
    acc_new = acc + jnp.mean(g * g, axis=-1)
    rs = jnp.where(acc_new > 0, jax.lax.rsqrt(acc_new + eps), 0.0)
    step = g * rs[:, None]
    return (table - lr * step.astype(table.dtype)).astype(table.dtype), \
        acc_new
