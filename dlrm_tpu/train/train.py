"""Training step and loop.

The reference's training loop (/root/reference/src/train/train.jl:189-293)
is: Zygote pullback → gather grads → work-stealing dense SGD update →
multithreaded compressed sparse embedding update.  The JAX shape of
all of that is ONE jitted train step — forward, backward, dense update, and
sparse scatter-add update fused into a single XLA program with donated
parameter buffers — plus a host-side loop that feeds device-resident batches.

The embedding gradient is computed compressed (d(loss)/d(gathered rows)) via
``sparse_value_and_grad`` and applied as a scatter-add; table gradients are
never densified (reference train.jl:283-290 semantics: per-row contributions
summed, applied once).
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, Iterable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from dlrm_tpu.config import DLRMConfig
from dlrm_tpu.models import dlrm as model_lib
from dlrm_tpu.ops import embedding as emb_ops
from dlrm_tpu.ops.loss import bce_loss
from dlrm_tpu.utils.backend import can_pin_host_outputs


class TrainState(NamedTuple):
    params: dict
    step: jax.Array


def init_train_state(key: jax.Array, config: DLRMConfig) -> TrainState:
    return TrainState(
        params=model_lib.init_params(key, config),
        step=jnp.zeros((), jnp.int32),
    )


def _loss_from_pooled(dense_params, pooled, dense, labels, config):
    return model_lib.loss_from_pooled(dense_params, pooled, dense, labels,
                                      config)


def train_step(params: dict, dense: jax.Array, sparse: jax.Array,
               labels: jax.Array, *, config: DLRMConfig, lr: float):
    """One SGD step; returns (new_params, loss).

    Mixed embedding strategy (ops/embedding.partition_tables): big tables go
    through the gather-outside-grad split so their gradients stay compressed
    (ids, rows) and apply as one scatter-add; small tables are looked up
    inside the differentiated function (ops/embedding.small_table_lookup)
    so their gradient is a small DENSE (R, D) slice applied with a
    contiguous vectorized add — no scatter into the table at all.

    Jit with ``static_argnames=('config', 'lr')`` and donate ``params``.
    """
    small, big = emb_ops.partition_tables(config.table_sizes,
                                          config.small_table_threshold)
    dense_params, emb = model_lib.split_params(params)
    emb_ops.check_storage(emb, config)
    small_dtype = config.compute_dtype

    def table_ids(t):
        return sparse[:, t] if sparse.ndim == 2 else sparse[:, t, :]

    emb_dtype = emb[0].dtype if isinstance(emb, (tuple, list)) else emb.dtype
    flat_big = ids_big = None
    if big:
        ids_big = sparse[:, big] if sparse.ndim == 2 else sparse[:, big, :]
        with jax.named_scope("lookup_gather"):
            if config.is_packed:
                rows_big = emb_ops.gather_tables(emb, ids_big, config, big)
            else:
                off_big = tuple(config.table_offsets[t] for t in big)
                flat_big = emb_ops.translate_ids(ids_big, off_big)
                rows_big = emb_ops.gather_rows(emb, flat_big)
    else:
        rows_big = jnp.zeros((dense.shape[0], 0, config.feature_size),
                             emb_dtype)
    small_tables = tuple(
        emb_ops.get_logical_table(emb, config, t) for t in small)

    def inner(dp, rows_big, small_tables):
        parts = [emb_ops.pool(rows_big)]
        with jax.named_scope("lookup_small"):
            for k, t in enumerate(small):
                parts.append(emb_ops.small_table_lookup(
                    small_tables[k], table_ids(t), small_dtype)[:, None, :])
        pooled = jnp.concatenate(parts, axis=1).astype(emb_dtype)
        pooled = pooled[:, emb_ops.table_order_permutation(small, big), :]
        return _loss_from_pooled(dp, pooled, dense, labels, config)

    loss, (dgrads, d_rows_big, d_smalls) = jax.value_and_grad(
        inner, argnums=(0, 1, 2))(dense_params, rows_big, small_tables)

    with jax.named_scope("dense_update"):
        new_dense = jax.tree.map(
            lambda p, g: (p - lr * g).astype(p.dtype), dense_params, dgrads)
    new_emb = list(emb) if isinstance(emb, (tuple, list)) else emb
    if big:
        with jax.named_scope("sparse_update"):
            if config.is_packed:
                new_emb = list(emb_ops.apply_sgd_chunked(
                    new_emb, ids_big, d_rows_big, lr, config, big))
            else:
                sgrad = emb_ops.SparseGrad(
                    ids=flat_big.reshape(-1),
                    rows=d_rows_big.reshape(-1, d_rows_big.shape[-1]))
                new_emb = emb_ops.apply_sparse_sgd(new_emb, sgrad, lr)
    if small:
        with jax.named_scope("small_table_update"):
            for k, t in enumerate(small):
                upd = (-lr * d_smalls[k]).astype(emb_dtype)
                if config.is_packed:
                    # contiguous add onto the table's packed rows
                    c = config.table_chunk[t]
                    po = config.chunk_table_offsets[t]
                    pn = config.packed_table_rows[t]
                    pad = pn * config.pack - config.table_sizes[t]
                    if pad:
                        upd = jnp.concatenate(
                            [upd, jnp.zeros((pad, upd.shape[1]), upd.dtype)])
                    new_emb[c] = new_emb[c].at[po:po + pn].add(
                        upd.reshape(pn, config.row_width))
                else:
                    off = config.table_offsets[t]
                    new_emb = new_emb.at[
                        off:off + config.table_sizes[t]].add(upd)
    if isinstance(new_emb, list):
        new_emb = tuple(new_emb)
    return model_lib.merge_params(new_dense, new_emb), loss


def make_jit_train_step(config: DLRMConfig, lr) -> Callable:
    """Jitted SGD step.  ``lr`` may be a float (constant) or a schedule
    (callable step -> lr, e.g. train.optim.make_schedule): the learning
    rate enters the compiled program as a runtime scalar, so one program
    serves every step."""
    jitted = jax.jit(
        lambda p, d, s, l, lr_val: train_step(p, d, s, l, config=config,
                                              lr=lr_val),
        donate_argnums=(0,))
    if not callable(lr):
        def step(p, d, s, l):
            return jitted(p, d, s, l, jnp.float32(lr))

        # the compiled program behind the step, for lower()/compile()
        step.lower = lambda p, d, s, l: jitted.lower(p, d, s, l,
                                                     jnp.float32(lr))
        return step

    def run(p, d, s, l):
        lr_val = jnp.float32(lr(run.step))
        run.step += 1
        return jitted(p, d, s, l, lr_val)

    run.step = 0  # set before resuming from a checkpoint
    return run


# -- pluggable-optimizer step (SGD / sparse Adagrad) -------------------------

def init_opt_state(params: dict, *, config: DLRMConfig, optimizer: str,
                   lr: float) -> dict:
    """Optimizer state pytree: optax state for the dense params, chunked
    accumulators (same storage layout as the tables) for the embeddings."""
    from dlrm_tpu.train import optim

    dense_params, emb = model_lib.split_params(params)
    tx = optim.dense_optimizer(optimizer, lr)
    return {
        "dense": tx.init(dense_params),
        "emb": optim.init_emb_state(config, optimizer, emb),
        "count": jnp.zeros((), jnp.int32),
    }


def train_step_opt(params: dict, opt_state: dict, dense, sparse, labels, *,
                   config: DLRMConfig, optimizer: str, lr: float,
                   emb_impl: str = "dedup", grad_clip_norm=None):
    """One step with a pluggable optimizer; returns ((params, opt_state),
    loss).

    ``optimizer='sgd'`` reproduces :func:`train_step` exactly.  For
    ``'adagrad'`` the embedding update follows the reference's
    dedup-then-apply contract with exact Adagrad semantics on unique rows
    (train/optim.py), and the accumulator lives in chunked storage so only
    hit rows are touched.

    ``grad_clip_norm``: global-norm clipping over everything autodiff
    produced (optim.clip_by_global_norm) before the updates.
    """
    from dlrm_tpu.train import optim

    small, big = emb_ops.partition_tables(config.table_sizes,
                                          config.small_table_threshold)
    dense_params, emb = model_lib.split_params(params)
    emb_dtype = emb[0].dtype if isinstance(emb, (tuple, list)) else emb.dtype
    assert config.is_packed, "train_step_opt requires engine storage"

    ids_big = None
    if big:
        ids_big = sparse[:, big] if sparse.ndim == 2 else sparse[:, big, :]
        with jax.named_scope("lookup_gather"):
            rows_big = emb_ops.gather_tables(emb, ids_big, config, big)
    else:
        rows_big = jnp.zeros((dense.shape[0], 0, config.feature_size),
                             emb_dtype)
    small_tables = tuple(
        emb_ops.get_logical_table(emb, config, t) for t in small)

    def table_ids(t):
        return sparse[:, t] if sparse.ndim == 2 else sparse[:, t, :]

    def inner(dp, rows_big, small_tables):
        parts = [emb_ops.pool(rows_big)]
        with jax.named_scope("lookup_small"):
            for k, t in enumerate(small):
                parts.append(emb_ops.small_table_lookup(
                    small_tables[k], table_ids(t),
                    config.compute_dtype)[:, None, :])
        pooled = jnp.concatenate(parts, axis=1).astype(emb_dtype)
        pooled = pooled[:, emb_ops.table_order_permutation(small, big), :]
        return _loss_from_pooled(dp, pooled, dense, labels, config)

    loss, (dgrads, d_rows_big, d_smalls) = jax.value_and_grad(
        inner, argnums=(0, 1, 2))(dense_params, rows_big, small_tables)
    if grad_clip_norm is not None:
        with jax.named_scope("grad_clip"):
            (dgrads, d_rows_big, d_smalls), _ = optim.clip_by_global_norm(
                grad_clip_norm, (dgrads, d_rows_big, d_smalls))

    count = opt_state.get("count", jnp.zeros((), jnp.int32))
    lr_t = lr(count) if callable(lr) else lr  # schedule support
    tx = optim.dense_optimizer(optimizer, lr)
    with jax.named_scope("dense_update"):
        updates, new_dense_state = tx.update(dgrads, opt_state["dense"],
                                             dense_params)
        import optax
        new_dense = optax.apply_updates(dense_params, updates)
        new_dense = jax.tree.map(
            lambda p, q: q.astype(p.dtype), dense_params, new_dense)

    new_emb = list(emb)
    emb_state = opt_state["emb"]
    if big:
        with jax.named_scope("sparse_update"):
            if optimizer == "sgd":
                new_emb = list(emb_ops.apply_sgd_chunked(
                    new_emb, ids_big, d_rows_big, lr_t, config, big))
            else:
                rowwise = optimizer == "rowwise_adagrad"
                # exact-adagrad implementation choice (all exact; see
                # optim.apply_adagrad_hybrid for the cost model)
                fn = {
                    "dedup": (optim.apply_rowwise_adagrad_chunked if
                              rowwise else optim.apply_adagrad_chunked),
                    "dense_g": (optim.apply_rowwise_adagrad_dense_g if
                                rowwise else optim.apply_adagrad_dense_g),
                }.get(emb_impl)
                if fn is not None:
                    new_emb, emb_state = fn(new_emb, emb_state, ids_big,
                                            d_rows_big, lr_t, config, big)
                elif emb_impl.startswith("hybrid"):
                    # "hybrid" or "hybrid:<MB>" (per-chunk threshold)
                    mb = (int(emb_impl.split(":", 1)[1])
                          if ":" in emb_impl else 400)
                    new_emb, emb_state = optim.apply_adagrad_hybrid(
                        new_emb, emb_state, ids_big, d_rows_big, lr_t,
                        config, big, rowwise=rowwise,
                        dense_g_max_bytes=mb << 20)
                else:
                    raise ValueError(f"unknown emb_impl {emb_impl!r}")
                new_emb = list(new_emb)
    if small:
        with jax.named_scope("small_table_update"):
            new_acc = (list(emb_state.acc)
                       if optimizer != "sgd" else None)
            for k, t in enumerate(small):
                c = config.table_chunk[t]
                po = config.chunk_table_offsets[t]
                pn = config.packed_table_rows[t]
                pad = pn * config.pack - config.table_sizes[t]
                grad = d_smalls[k]
                if optimizer == "sgd":
                    upd = (-lr_t * grad).astype(emb_dtype)
                    if pad:
                        upd = jnp.concatenate(
                            [upd, jnp.zeros((pad, upd.shape[1]), upd.dtype)])
                    new_emb[c] = new_emb[c].at[po:po + pn].add(
                        upd.reshape(pn, config.row_width))
                    continue
                tab = emb_ops.get_logical_table(tuple(new_emb), config, t)
                n_rows = config.table_sizes[t]
                orig = new_emb[c][po:po + pn].reshape(
                    -1, config.feature_size)
                if optimizer == "rowwise_adagrad":
                    # acc chunk is (chunk_rows, pack): one scalar per
                    # logical row
                    acc_view = new_acc[c][po:po + pn].reshape(-1)[:n_rows]
                    new_tab, new_acc_tab = \
                        optim.apply_rowwise_adagrad_dense_table(
                            tab, acc_view, grad, lr_t)
                    if pad:
                        new_tab = jnp.concatenate(
                            [new_tab, orig[n_rows:]])
                        orig_acc = new_acc[c][po:po + pn].reshape(-1)
                        new_acc_tab = jnp.concatenate(
                            [new_acc_tab, orig_acc[n_rows:]])
                    new_emb[c] = new_emb[c].at[po:po + pn].set(
                        new_tab.reshape(pn, config.row_width))
                    new_acc[c] = new_acc[c].at[po:po + pn].set(
                        new_acc_tab.reshape(pn, config.pack))
                else:
                    acc_view = new_acc[c][po:po + pn].reshape(
                        -1, config.feature_size)[:n_rows]
                    new_tab, new_acc_tab = optim.apply_adagrad_dense_table(
                        tab, acc_view, grad, lr_t)
                    if pad:
                        # pad slots are never read but must round-trip
                        # unchanged (as on every other update path)
                        new_tab = jnp.concatenate(
                            [new_tab, orig[n_rows:]])
                        orig_acc = new_acc[c][po:po + pn].reshape(
                            -1, config.feature_size)
                        new_acc_tab = jnp.concatenate(
                            [new_acc_tab, orig_acc[n_rows:]])
                    new_emb[c] = new_emb[c].at[po:po + pn].set(
                        new_tab.reshape(pn, config.row_width))
                    new_acc[c] = new_acc[c].at[po:po + pn].set(
                        new_acc_tab.reshape(pn, config.row_width))
            if optimizer == "adagrad":
                from dlrm_tpu.train.optim import EmbAdagradState
                emb_state = EmbAdagradState(acc=tuple(new_acc))
            elif optimizer == "rowwise_adagrad":
                from dlrm_tpu.train.optim import EmbRowwiseAdagradState
                emb_state = EmbRowwiseAdagradState(acc=tuple(new_acc))

    new_params = model_lib.merge_params(new_dense, tuple(new_emb))
    new_opt = {"dense": new_dense_state, "emb": emb_state,
               "count": count + 1}
    return (new_params, new_opt), loss


def make_jit_train_step_opt(config: DLRMConfig, *, optimizer: str = "sgd",
                            lr: float = 0.1, emb_impl: str = "dedup",
                            grad_clip_norm=None) -> Callable:
    step = functools.partial(train_step_opt, config=config,
                             optimizer=optimizer, lr=lr,
                             emb_impl=emb_impl,
                             grad_clip_norm=grad_clip_norm)
    return jax.jit(step, donate_argnums=(0, 1))


# -- coalesced K-step block (the BatchUpdater analog) -------------------------

def train_block(params: dict, dense: jax.Array, sparse: jax.Array,
                labels: jax.Array, *, config: DLRMConfig, lr: float,
                block: int = None, grad_clip_norm=None):
    """``block`` SGD micro-steps fused into one jitted program, with the
    big-table scatter updates COALESCED into one scatter-add per storage
    chunk at block end.

    This is the JAX analog of the reference's disabled BatchUpdater
    pipeline (src/model/embedding_update.jl:1-37): there, precompute threads
    aggregate sparse updates in DRAM and writeback threads trickle them into
    the (slow-tier) tables behind the forward pass, deliberately tolerating
    bounded staleness.  Here the same relaxation — the forward of micro-step
    k reads big-table rows as of block entry (stale by < ``block`` steps) —
    buys amortization of the fixed cost of each scatter op across
    ``block`` batches.

    Exactness contract:
      * dense params and small (dense-gradient) tables update every micro-step
        — they are carried, never stale;
      * big-table gradients are computed w.r.t. the stale rows and their
        scatter-adds commute, so when no id repeats across micro-batches the
        block is bit-identical to ``block`` sequential :func:`train_step`
        calls (oracle-tested);
      * ``block=1`` is always exactly :func:`train_step`.

    Args: ``dense`` (K, B, 13), ``sparse`` (K, B, T[, H]), ``labels``
    (K, B).  Returns (new_params, losses (K,)).  ``block`` defaults to
    the leading K of the batch (a sub-K remainder block recompiles once).
    """
    if block is None:
        block = dense.shape[0]
    small, big = emb_ops.partition_tables(config.table_sizes,
                                          config.small_table_threshold)
    dense_params, emb = model_lib.split_params(params)
    emb_ops.check_storage(emb, config)
    assert config.is_packed, "train_block requires engine storage"
    emb_dtype = emb[0].dtype
    # lr may be a scalar (constant) or a (K,) per-micro-step array (LR
    # schedule): then each micro-step's gradient is pre-scaled by its own
    # lr and the coalesced scatter applies with lr=1
    lr_arr = None if jnp.ndim(lr) == 0 else lr

    dp = dense_params
    st = tuple(emb_ops.get_logical_table(emb, config, t) for t in small)
    losses, ids_acc, drows_acc = [], [], []
    for k in range(block):
        d, s, l = dense[k], sparse[k], labels[k]
        ids_big = None
        if big:
            ids_big = s[:, big] if s.ndim == 2 else s[:, big, :]
            with jax.named_scope("lookup_gather"):
                rows_big = emb_ops.gather_tables(emb, ids_big, config, big)
        else:
            rows_big = jnp.zeros((d.shape[0], 0, config.feature_size),
                                 emb_dtype)

        def inner(dp_, rows_big_, st_, s=s, d=d, l=l):
            parts = [emb_ops.pool(rows_big_)]
            with jax.named_scope("lookup_small"):
                for j, t in enumerate(small):
                    idt = s[:, t] if s.ndim == 2 else s[:, t, :]
                    parts.append(emb_ops.small_table_lookup(
                        st_[j], idt, config.compute_dtype)[:, None, :])
            pooled = jnp.concatenate(parts, axis=1).astype(emb_dtype)
            pooled = pooled[:, emb_ops.table_order_permutation(small, big),
                            :]
            return _loss_from_pooled(dp_, pooled, d, l, config)

        loss, (dgrads, d_rows_big, d_smalls) = jax.value_and_grad(
            inner, argnums=(0, 1, 2))(dp, rows_big, st)
        if grad_clip_norm is not None:
            # clip per MICRO-step over the same pytree the per-step path
            # clips: when no id repeats across micro-batches the block
            # stays bit-identical to K sequential clipped train_steps
            from dlrm_tpu.train import optim
            with jax.named_scope("grad_clip"):
                (dgrads, d_rows_big, d_smalls), _ = \
                    optim.clip_by_global_norm(
                        grad_clip_norm, (dgrads, d_rows_big, d_smalls))
        lr_k = lr if lr_arr is None else lr_arr[k]
        with jax.named_scope("dense_update"):
            dp = jax.tree.map(
                lambda p, g: (p - lr_k * g).astype(p.dtype), dp, dgrads)
            st = tuple((t - lr_k * g).astype(t.dtype)
                       for t, g in zip(st, d_smalls))
        losses.append(loss)
        if big:
            ids_acc.append(ids_big)
            drows_acc.append(d_rows_big if lr_arr is None
                             else lr_arr[k] * d_rows_big)

    new_emb = list(emb)
    if big:
        with jax.named_scope("coalesced_sparse_update"):
            ids_cat = jnp.concatenate(ids_acc, axis=0)
            drows_cat = jnp.concatenate(drows_acc, axis=0)
            new_emb = list(emb_ops.apply_sgd_chunked(
                new_emb, ids_cat, drows_cat,
                lr if lr_arr is None else 1.0, config, big))
    with jax.named_scope("small_table_writeback"):
        for j, t in enumerate(small):
            c = config.table_chunk[t]
            po = config.chunk_table_offsets[t]
            pn = config.packed_table_rows[t]
            pad = pn * config.pack - config.table_sizes[t]
            tab = st[j]
            if pad:
                # pad slots are never read but must round-trip unchanged
                # (train_step's .add leaves them alone)
                orig = emb[c][po:po + pn].reshape(-1, config.feature_size)
                tab = jnp.concatenate([tab, orig[config.table_sizes[t]:]])
            new_emb[c] = new_emb[c].at[po:po + pn].set(
                tab.reshape(pn, config.row_width))
    return (model_lib.merge_params(dp, tuple(new_emb)),
            jnp.stack(losses))


def make_jit_train_block(config: DLRMConfig, lr, block: int = None,
                         grad_clip_norm=None) -> Callable:
    """Jitted coalesced block step: f(params, (K,B,13), (K,B,T[,H]),
    (K,B)) -> (params, (K,) losses).  ``lr`` may be a float or a schedule
    (callable step -> lr); schedules enter as a (K,) runtime array."""
    del block  # derived from the batch's leading dim at trace time
    if not callable(lr):
        step = functools.partial(train_block, config=config, lr=lr,
                                 grad_clip_norm=grad_clip_norm)
        return jax.jit(step, donate_argnums=(0,))
    jitted = jax.jit(
        lambda p, d, s, l, lrs: train_block(p, d, s, l, config=config,
                                            lr=lrs,
                                            grad_clip_norm=grad_clip_norm),
        donate_argnums=(0,))

    def run(p, d, s, l):
        k = d.shape[0]
        lrs = jnp.asarray([lr(run.step + i) for i in range(k)], jnp.float32)
        run.step += k
        return jitted(p, d, s, l, lrs)

    run.step = 0  # set before resuming from a checkpoint
    return run


def train_block_opt(params: dict, opt_state: dict, dense: jax.Array,
                    sparse: jax.Array, labels: jax.Array, *,
                    config: DLRMConfig, lr, block: int = None,
                    adagrad_impl: str = "dense_g", unroll: bool = True,
                    optimizer: str = "adagrad", grad_clip_norm=None):
    """Coalesced K-step block with sparse ADAGRAD (see :func:`train_block`
    for the staleness contract — SGD blocks route there).

    Exactness: dense params and small tables get a true per-micro-step
    Adagrad (carried, never stale); big-table gradients are computed
    w.r.t. block-entry rows, accumulated compressed, and applied at block
    end with ONE dedup-then-apply Adagrad per chunk — one argsort + one
    accumulator gather + two scatters per chunk per K steps instead of
    per step (the dominant Adagrad overhead).  When no id
    repeats across micro-batches the block equals K sequential
    :func:`train_step_opt` calls up to mul-reorder ulps; otherwise a
    repeated row gets one accumulator update with the SUMMED gradient
    (bounded staleness < K, the BatchUpdater relaxation).

    ``lr``: float or a traceable schedule step -> lr (evaluated at
    ``opt_state['count'] + k``; the big-table step then dedups the twin
    payload (g, lr_k*g) so each row's weight step uses its own step's lr).
    """
    from dlrm_tpu.train import optim
    import optax

    if block is None:
        block = dense.shape[0]
    small, big = emb_ops.partition_tables(config.table_sizes,
                                          config.small_table_threshold)
    dense_params, emb = model_lib.split_params(params)
    emb_ops.check_storage(emb, config)
    assert config.is_packed, "train_block_opt requires engine storage"
    emb_dtype = emb[0].dtype
    scheduled = callable(lr)
    rowwise = optimizer == "rowwise_adagrad"
    count = opt_state.get("count", jnp.zeros((), jnp.int32))
    tx = optim.dense_optimizer(optimizer, lr)
    small_apply = (optim.apply_rowwise_adagrad_dense_table if rowwise
                   else optim.apply_adagrad_dense_table)

    dp = dense_params
    dense_state = opt_state["dense"]
    emb_state = opt_state["emb"]
    # small tables + their accumulator slices, carried per micro-step
    st = []
    for t in small:
        c = config.table_chunk[t]
        po = config.chunk_table_offsets[t]
        pn = config.packed_table_rows[t]
        if rowwise:  # (chunk_rows, pack) scalar-per-row accumulator
            acc_view = emb_state.acc[c][po:po + pn].reshape(
                -1)[:config.table_sizes[t]]
        else:
            acc_view = emb_state.acc[c][po:po + pn].reshape(
                -1, config.feature_size)[:config.table_sizes[t]]
        st.append((emb_ops.get_logical_table(emb, config, t), acc_view))

    st = tuple(st)

    def micro_step(dp, dense_state, st, d, s, l, lr_k):
        ids_big = None
        if big:
            ids_big = s[:, big] if s.ndim == 2 else s[:, big, :]
            with jax.named_scope("lookup_gather"):
                rows_big = emb_ops.gather_tables(emb, ids_big, config, big)
        else:
            rows_big = jnp.zeros((d.shape[0], 0, config.feature_size),
                                 emb_dtype)

        def inner(dp_, rows_big_, st_tabs):
            parts = [emb_ops.pool(rows_big_)]
            with jax.named_scope("lookup_small"):
                for j, t in enumerate(small):
                    idt = s[:, t] if s.ndim == 2 else s[:, t, :]
                    parts.append(emb_ops.small_table_lookup(
                        st_tabs[j], idt, config.compute_dtype)[:, None, :])
            pooled = jnp.concatenate(parts, axis=1).astype(emb_dtype)
            pooled = pooled[:, emb_ops.table_order_permutation(small, big),
                            :]
            return _loss_from_pooled(dp_, pooled, d, l, config)

        loss, (dgrads, d_rows_big, d_smalls) = jax.value_and_grad(
            inner, argnums=(0, 1, 2))(dp, rows_big,
                                      tuple(tab for tab, _ in st))
        if grad_clip_norm is not None:
            # per-micro-step clip: same pytree as train_step_opt's clip,
            # so no-id-repeat blocks match K sequential clipped steps
            with jax.named_scope("grad_clip"):
                (dgrads, d_rows_big, d_smalls), _ = \
                    optim.clip_by_global_norm(
                        grad_clip_norm, (dgrads, d_rows_big, d_smalls))
        with jax.named_scope("dense_update"):
            updates, dense_state = tx.update(dgrads, dense_state, dp)
            dp = jax.tree.map(lambda p, q: q.astype(p.dtype), dp,
                              optax.apply_updates(dp, updates))
        with jax.named_scope("small_table_update"):
            st = tuple(small_apply(tab, acc, d_smalls[j], lr_k)
                       for j, (tab, acc) in enumerate(st))
        return dp, dense_state, st, loss, ids_big, d_rows_big

    ids_cat = drows_cat = scaled_cat = None
    if not unroll:
        # lax.scan over micro-steps: ~8x faster compile, ~5% slower
        # steady-state than the unrolled loop (no cross-step overlap) —
        # measured 54.9 s / 25.7 ms vs 467 s / 24.4 ms at K=8 Kaggle.
        # (With no big tables the ids/drows outputs are skipped — scan
        # ys cannot carry None — but the micro-steps still scan.)
        def body(carry, xs):
            dp, dense_state, st = carry
            d, s, l, k = xs
            lr_k = lr(count + k) if scheduled else lr
            dp, dense_state, st, loss, ids_big, drb = micro_step(
                dp, dense_state, st, d, s, l, lr_k)
            ys = (loss,)
            if big:
                ys += (ids_big, drb) + (
                    ((lr_k * drb),) if scheduled else ())
            return (dp, dense_state, st), ys

        (dp, dense_state, st), ys = jax.lax.scan(
            body, (dp, dense_state, st),
            (dense, sparse, labels, jnp.arange(block)))
        losses = ys[0]
        if big:
            ids_ys, drb_ys = ys[1], ys[2]
            ids_cat = ids_ys.reshape((-1,) + ids_ys.shape[2:])
            drows_cat = drb_ys.reshape((-1,) + drb_ys.shape[2:])
            if scheduled:
                scaled_cat = ys[3].reshape((-1,) + ys[3].shape[2:])
    else:
        losses, ids_acc, drows_acc, scaled_acc = [], [], [], []
        for k in range(block):
            lr_k = lr(count + k) if scheduled else lr
            dp, dense_state, st, loss, ids_big, drb = micro_step(
                dp, dense_state, st, dense[k], sparse[k], labels[k], lr_k)
            losses.append(loss)
            if big:
                ids_acc.append(ids_big)
                drows_acc.append(drb)
                if scheduled:
                    scaled_acc.append(lr_k * drb)
        losses = jnp.stack(losses)
        if big:
            ids_cat = jnp.concatenate(ids_acc, axis=0)
            drows_cat = jnp.concatenate(drows_acc, axis=0)
            if scheduled:
                scaled_cat = jnp.concatenate(scaled_acc, axis=0)

    new_emb = list(emb)
    if big:
        # dense_g: the block-default — one scatter + elementwise chunk
        # passes, amortized over K (measured 24.4 vs 46.0 ms/step at K=8).
        # dedup: compressed sort-based path, no chunk-sized transient —
        # for memory-constrained configs.
        impls = {
            ("adagrad", "dense_g"): optim.apply_adagrad_dense_g,
            ("adagrad", "dedup"): optim.apply_adagrad_chunked,
            ("rowwise_adagrad", "dense_g"):
                optim.apply_rowwise_adagrad_dense_g,
            ("rowwise_adagrad", "dedup"):
                optim.apply_rowwise_adagrad_chunked,
        }
        apply = impls[(optimizer, adagrad_impl)]
        with jax.named_scope("coalesced_adagrad_update"):
            new_emb, emb_state = apply(
                new_emb, emb_state, ids_cat, drows_cat,
                1.0 if scheduled else lr, config, big,
                d_rows_scaled=scaled_cat)
            new_emb = list(new_emb)
    with jax.named_scope("small_table_writeback"):
        new_acc = list(emb_state.acc)
        for j, t in enumerate(small):
            c = config.table_chunk[t]
            po = config.chunk_table_offsets[t]
            pn = config.packed_table_rows[t]
            pad = pn * config.pack - config.table_sizes[t]
            tab, acc = st[j]
            if pad:
                # pad slots are never read but must round-trip unchanged
                orig = emb[c][po:po + pn].reshape(-1, config.feature_size)
                tab = jnp.concatenate([tab, orig[config.table_sizes[t]:]])
                if rowwise:
                    orig_acc = emb_state.acc[c][po:po + pn].reshape(-1)
                else:
                    orig_acc = emb_state.acc[c][po:po + pn].reshape(
                        -1, config.feature_size)
                acc = jnp.concatenate([acc,
                                       orig_acc[config.table_sizes[t]:]])
            new_emb[c] = new_emb[c].at[po:po + pn].set(
                tab.reshape(pn, config.row_width))
            new_acc[c] = new_acc[c].at[po:po + pn].set(
                acc.reshape(pn, config.pack if rowwise
                            else config.row_width))
        from dlrm_tpu.train.optim import (EmbAdagradState,
                                          EmbRowwiseAdagradState)
        emb_state = (EmbRowwiseAdagradState(acc=tuple(new_acc)) if rowwise
                     else EmbAdagradState(acc=tuple(new_acc)))

    new_params = model_lib.merge_params(dp, tuple(new_emb))
    new_opt = {"dense": dense_state, "emb": emb_state,
               "count": count + block}
    return (new_params, new_opt), losses


def make_jit_train_block_opt(config: DLRMConfig, *, optimizer: str,
                             lr, block: int = None,
                             adagrad_impl: str = "dense_g",
                             unroll: bool = True,
                             grad_clip_norm=None) -> Callable:
    """Jitted Adagrad block step: f(params, opt_state, (K,B,13),
    (K,B,T[,H]), (K,B)) -> ((params, opt_state), (K,) losses).  The
    schedule count lives in opt_state, so no host-side wrapper is needed
    (unlike the SGD block makers).  ``unroll=False`` scans over
    micro-steps: much faster compile, slightly slower steady-state."""
    del block  # derived from the batch's leading dim at trace time
    assert optimizer in ("adagrad", "rowwise_adagrad"), \
        "SGD blocks use make_jit_train_block"
    step = functools.partial(train_block_opt, config=config, lr=lr,
                             adagrad_impl=adagrad_impl, unroll=unroll,
                             optimizer=optimizer,
                             grad_clip_norm=grad_clip_norm)
    return jax.jit(step, donate_argnums=(0, 1))


def sharded_train_step(params: dict, dense: jax.Array, sparse: jax.Array,
                       labels: jax.Array, *, config: DLRMConfig, lr: float,
                       mesh, placement, axis: str = "d"):
    """One hybrid-parallel SGD step (the multi-chip path).

    ``params['emb']`` is the (N, local_rows, D) sharded table stack
    (parallel/embedding.shard_tables); dense/sparse/labels are batch-sharded
    over ``axis``.  Embedding exchange is explicit shard_map all-to-all;
    everything else (MLP compute, psum of data-parallel dense grads) is
    GSPMD-automatic from the input shardings.
    """
    from dlrm_tpu.parallel import embedding as pemb  # local import: no cycle

    dense_params = {"bottom": params["bottom"], "top": params["top"]}
    cs = params.get("emb_cs", ())
    emb_h = params.get("emb_h")
    with jax.named_scope("lookup"):
        pooled = pemb.sharded_lookup(params["emb"], sparse, mesh=mesh,
                                     placement=placement, axis=axis, cs=cs,
                                     emb_h=emb_h,
                                     exchange_dtype=config.exchange_dtype)

    def inner(dp, p):
        return _loss_from_pooled(dp, p, dense, labels, config)

    loss, (dgrads, d_pooled) = jax.value_and_grad(
        inner, argnums=(0, 1))(dense_params, pooled)
    with jax.named_scope("dense_update"):
        new_dense = jax.tree.map(
            lambda p, g: (p - lr * g).astype(p.dtype), dense_params, dgrads)
    with jax.named_scope("sparse_update"):
        new_emb, new_h, new_cs = pemb.sharded_update_sgd(
            params["emb"], sparse, d_pooled, lr, mesh=mesh,
            placement=placement, axis=axis, cs=cs, emb_h=emb_h,
            exchange_dtype=config.exchange_dtype)
    new_params = {"bottom": new_dense["bottom"], "emb": new_emb,
                  "top": new_dense["top"]}
    if "emb_cs" in params:
        new_params["emb_cs"] = new_cs
    if "emb_h" in params:
        new_params["emb_h"] = new_h
    return new_params, loss


def sharded_train_step_opt(params: dict, opt_state: dict, dense, sparse,
                           labels, *, config: DLRMConfig, optimizer: str,
                           lr, mesh, placement, axis: str = "d",
                           grad_clip_norm=None):
    """Hybrid-parallel step with a pluggable optimizer (sgd | adagrad |
    rowwise_adagrad).

    For adagrad the accumulator lives in the same (N, local_rows, W)
    sharded layout as the tables and each shard applies an exact
    dedup-then-apply update to the rows it owns.  Column-sharded tables
    run adagrad on per-lane-slice accumulators (``_cs_adagrad_local``)
    and rowwise via a psum'd full-D row mean (``_cs_rowwise_local``);
    see parallel/embedding.py and tests/test_optim.py per-placement
    oracles.
    """
    from dlrm_tpu.parallel import embedding as pemb
    from dlrm_tpu.train import optim

    dense_params = {"bottom": params["bottom"], "top": params["top"]}
    cs = params.get("emb_cs", ())
    with jax.named_scope("lookup"):
        pooled = pemb.sharded_lookup(params["emb"], sparse, mesh=mesh,
                                     placement=placement, axis=axis, cs=cs,
                                     emb_h=params.get("emb_h"),
                                     exchange_dtype=config.exchange_dtype)

    def inner(dp, p):
        return _loss_from_pooled(dp, p, dense, labels, config)

    loss, (dgrads, d_pooled) = jax.value_and_grad(
        inner, argnums=(0, 1))(dense_params, pooled)
    if grad_clip_norm is not None:
        # GSPMD global arrays here (outside the shard_map bodies): the
        # norm over the batch-sharded d_pooled psums automatically
        with jax.named_scope("grad_clip"):
            (dgrads, d_pooled), _ = optim.clip_by_global_norm(
                grad_clip_norm, (dgrads, d_pooled))

    count = opt_state.get("count", jnp.zeros((), jnp.int32))
    lr_t = lr(count) if callable(lr) else lr
    tx = optim.dense_optimizer(optimizer, lr)
    with jax.named_scope("dense_update"):
        import optax
        updates, new_dense_state = tx.update(dgrads, opt_state["dense"],
                                             dense_params)
        new_dense = optax.apply_updates(dense_params, updates)
        new_dense = jax.tree.map(
            lambda p, q: q.astype(p.dtype), dense_params, new_dense)

    new_opt = {"dense": new_dense_state, "count": count + 1}
    with jax.named_scope("sparse_update"):
        if optimizer == "sgd":
            new_emb, new_h, new_cs = pemb.sharded_update_sgd(
                params["emb"], sparse, d_pooled, lr_t, mesh=mesh,
                placement=placement, axis=axis, cs=cs,
                emb_h=params.get("emb_h"),
                exchange_dtype=config.exchange_dtype)
            new_opt["emb_acc"] = opt_state.get("emb_acc", ())
            new_opt["emb_acc_cs"] = opt_state.get("emb_acc_cs", ())
            new_opt["emb_acc_h"] = opt_state.get("emb_acc_h", ())
        else:
            new_emb, new_acc, new_h, new_acc_h, new_cs, new_acc_cs = \
                pemb.sharded_update_adagrad(
                    params["emb"], opt_state["emb_acc"], sparse, d_pooled,
                    lr_t, mesh=mesh, placement=placement, axis=axis,
                    cs=cs, acc_cs=opt_state.get("emb_acc_cs", ()),
                    emb_h=params.get("emb_h"),
                    acc_h=(None if isinstance(
                        opt_state.get("emb_acc_h", ()), tuple)
                        else opt_state["emb_acc_h"]),
                    rowwise=optimizer == "rowwise_adagrad",
                    exchange_dtype=config.exchange_dtype)
            new_opt["emb_acc"] = new_acc
            new_opt["emb_acc_cs"] = new_acc_cs
            new_opt["emb_acc_h"] = new_acc_h if new_acc_h is not None \
                else ()
    new_params = {"bottom": new_dense["bottom"], "emb": new_emb,
                  "top": new_dense["top"]}
    if "emb_cs" in params:
        new_params["emb_cs"] = new_cs
    if "emb_h" in params:
        new_params["emb_h"] = new_h
    return (new_params, new_opt), loss


def init_sharded_opt_state(params: dict, *, config: DLRMConfig,
                           optimizer: str, lr, mesh, axis: str = "d"
                           ) -> dict:
    """Optimizer state for the sharded step: optax state (replicated) plus
    an Adagrad accumulator in the same sharded layout as params['emb']."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from dlrm_tpu.train import optim

    dense_params = {"bottom": params["bottom"], "top": params["top"]}
    tx = optim.dense_optimizer(optimizer, lr)
    state = {"dense": tx.init(dense_params),
             "count": jnp.zeros((), jnp.int32), "emb_acc": (),
             "emb_acc_cs": (), "emb_acc_h": ()}
    if optimizer == "rowwise_adagrad":
        # one f32 scalar per logical row: (N, local_rows, pack), where
        # pack = row_width / feature_size (lane-packed logical rows)
        n, local_rows, w = params["emb"].shape
        pack = w // config.feature_size
        state["emb_acc"] = jax.device_put(
            jnp.zeros((n, local_rows, pack), jnp.float32),
            NamedSharding(mesh, P(axis)))
        # column-sharded tables: REPLICATED (R,) per table — every shard
        # folds in the identical psum'd full-D row mean
        # (parallel/embedding._cs_rowwise_local); host-resident tables: a
        # (N, host_rows, pack) scalar slab pinned next to the table slab
        state["emb_acc_cs"] = tuple(
            jax.device_put(jnp.zeros((a.shape[1],), jnp.float32),
                           NamedSharding(mesh, P()))
            for a in params.get("emb_cs", ()))
        if "emb_h" in params:
            state["emb_acc_h"] = jax.device_put(
                jnp.zeros(params["emb_h"].shape[:2] + (pack,),
                          jnp.float32),
                NamedSharding(mesh, P(axis), memory_kind="pinned_host"))
    if optimizer == "adagrad":
        acc = jnp.zeros(params["emb"].shape, jnp.float32)
        state["emb_acc"] = jax.device_put(
            acc, NamedSharding(mesh, P(axis)))
        state["emb_acc_cs"] = tuple(
            jax.device_put(jnp.zeros(a.shape, jnp.float32),
                           NamedSharding(mesh, P(axis)))
            for a in params.get("emb_cs", ()))
        if "emb_h" in params:
            state["emb_acc_h"] = jax.device_put(
                jnp.zeros(params["emb_h"].shape, jnp.float32),
                NamedSharding(mesh, P(axis), memory_kind="pinned_host"))
    return state


def sharded_opt_shardings(opt_state: dict, mesh, axis: str = "d"):
    """Shardings pytree for :func:`init_sharded_opt_state`'s output: the
    Adagrad accumulator is sharded like the tables (first axis over the
    mesh), everything else (optax dense state, schedule count) replicated.
    Used to checkpoint/restore the optimizer state alongside the params."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())
    sh = jax.tree.map(lambda _: rep, opt_state)
    if not isinstance(opt_state.get("emb_acc", ()), tuple):
        sh["emb_acc"] = NamedSharding(mesh, P(axis))
    if opt_state.get("emb_acc_cs", ()):
        # rowwise cs accumulators are replicated (R,) vectors; elementwise
        # ones are (N, R, D/N) sharded like the lane slices
        sh["emb_acc_cs"] = tuple(
            (rep if a.ndim == 1 else NamedSharding(mesh, P(axis)))
            for a in opt_state["emb_acc_cs"])
    if not isinstance(opt_state.get("emb_acc_h", ()), tuple):
        sh["emb_acc_h"] = NamedSharding(mesh, P(axis),
                                        memory_kind="pinned_host")
    return sh


def check_mesh_interaction(config: DLRMConfig) -> None:
    """The fused interaction kernel is one device's program: under a mesh
    it would see the global batch.  The sharded paths refuse it."""
    if config.interaction_impl == "fused":
        raise ValueError(
            "interaction_impl='fused' runs on one device's batch; the "
            "sharded path takes 'gram' or 'pairwise'")


def make_sharded_train_step_opt(config: DLRMConfig, *, optimizer: str,
                                lr, mesh, placement, axis: str = "d",
                                grad_clip_norm=None) -> Callable:
    check_mesh_interaction(config)
    step = functools.partial(sharded_train_step_opt, config=config,
                             optimizer=optimizer, lr=lr, mesh=mesh,
                             placement=placement, axis=axis,
                             grad_clip_norm=grad_clip_norm)
    if not placement.host_row_sharded:
        return jax.jit(step, donate_argnums=(0, 1))
    from jax.sharding import NamedSharding, PartitionSpec as P
    from dlrm_tpu.parallel.host_tier import ensure_backend_primed
    ensure_backend_primed()
    if not can_pin_host_outputs():
        # no output placement in pinned_host (the CPU backend): skip
        # donation so pinned-host inputs are not reused for
        # default-memory outputs
        return jax.jit(step)
    pin = NamedSharding(mesh, P(axis), memory_kind="pinned_host")
    out_params = {"bottom": None, "emb": None, "top": None, "emb_h": pin}
    if placement.col_sharded:
        out_params["emb_cs"] = None
    out_opt = {"dense": None, "count": None, "emb_acc": None,
               "emb_acc_cs": None,
               "emb_acc_h": (pin if optimizer in ("adagrad",
                                                  "rowwise_adagrad")
                             else None)}
    return jax.jit(step, donate_argnums=(0, 1),
                   out_shardings=((out_params, out_opt), None))


def sharded_train_block(params: dict, dense: jax.Array, sparse: jax.Array,
                        labels: jax.Array, *, config: DLRMConfig, lr: float,
                        mesh, placement, block: int = None,
                        axis: str = "d", grad_clip_norm=None):
    """Coalesced K-step block on the hybrid-parallel path (see
    :func:`train_block` for the semantics — the BatchUpdater relaxation).

    Per micro-step: sharded lookup (a2a / reduce-scatter collectives) on
    the tables AS OF BLOCK ENTRY, global MLP fwd/bwd (GSPMD psums the
    data-parallel dense grads), exact dense SGD.  The K compressed
    embedding gradients are stacked (K, B, T, D) batch-sharded and applied
    in ONE scatter pass per shard at block end (staleness < K steps).

    Args: ``dense`` (K, B, 13), ``sparse`` (K, B, T[, H]), ``labels``
    (K, B) — batch dim sharded over ``axis``.  Returns (params, (K,)).
    ``block`` defaults to the leading K of the batch.
    """
    if block is None:
        block = dense.shape[0]
    from dlrm_tpu.parallel import embedding as pemb

    dense_params = {"bottom": params["bottom"], "top": params["top"]}
    cs = params.get("emb_cs", ())
    emb_h = params.get("emb_h")
    lr_arr = None if jnp.ndim(lr) == 0 else lr
    dp = dense_params
    losses, d_pooled_acc = [], []
    for k in range(block):
        with jax.named_scope("lookup"):
            pooled = pemb.sharded_lookup(
                params["emb"], sparse[k], mesh=mesh, placement=placement,
                axis=axis, cs=cs, emb_h=emb_h,
                exchange_dtype=config.exchange_dtype)

        def inner(dp_, p_, k=k):
            return _loss_from_pooled(dp_, p_, dense[k], labels[k], config)

        lr_k = lr if lr_arr is None else lr_arr[k]
        loss, (dgrads, d_pooled) = jax.value_and_grad(
            inner, argnums=(0, 1))(dp, pooled)
        if grad_clip_norm is not None:
            # per-micro-step clip over the same (dense grads, pooled
            # grad) pytree sharded_train_step_opt clips — the norm is
            # global (GSPMD reduces over the batch-sharded d_pooled)
            from dlrm_tpu.train import optim
            with jax.named_scope("grad_clip"):
                (dgrads, d_pooled), _ = optim.clip_by_global_norm(
                    grad_clip_norm, (dgrads, d_pooled))
        with jax.named_scope("dense_update"):
            dp = jax.tree.map(
                lambda p, g: (p - lr_k * g).astype(p.dtype), dp, dgrads)
        losses.append(loss)
        d_pooled_acc.append(d_pooled if lr_arr is None
                            else lr_arr[k] * d_pooled)

    with jax.named_scope("coalesced_sparse_update"):
        d_stack = jnp.stack(d_pooled_acc)  # (K, B, T, D), dim 1 sharded
        new_emb, new_h, new_cs = pemb.sharded_update_sgd(
            params["emb"], sparse, d_stack,
            lr if lr_arr is None else 1.0, mesh=mesh,
            placement=placement, axis=axis, cs=cs, emb_h=emb_h,
            block_leading=True, exchange_dtype=config.exchange_dtype)
    new_params = {"bottom": dp["bottom"], "emb": new_emb,
                  "top": dp["top"]}
    if "emb_cs" in params:
        new_params["emb_cs"] = new_cs
    if "emb_h" in params:
        new_params["emb_h"] = new_h
    return new_params, jnp.stack(losses)


def make_sharded_train_block(config: DLRMConfig, lr, mesh, placement,
                             block: int = None, axis: str = "d",
                             grad_clip_norm=None) -> Callable:
    del block  # derived from the batch's leading dim at trace time
    check_mesh_interaction(config)
    jit_kw = dict(donate_argnums=(0,))
    if placement.host_row_sharded:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from dlrm_tpu.parallel.host_tier import ensure_backend_primed
        ensure_backend_primed()
        if not can_pin_host_outputs():
            # no output placement in pinned_host (the CPU backend): skip
            # donation so pinned-host inputs are not reused for
            # default-memory outputs
            jit_kw = {}
        else:
            out_params = {"bottom": None, "emb": None, "top": None,
                          "emb_h": NamedSharding(
                              mesh, P(axis), memory_kind="pinned_host")}
            if placement.col_sharded:
                out_params["emb_cs"] = None
            jit_kw["out_shardings"] = (out_params, None)
    if not callable(lr):
        step = functools.partial(sharded_train_block, config=config, lr=lr,
                                 mesh=mesh, placement=placement, axis=axis,
                                 grad_clip_norm=grad_clip_norm)
        return jax.jit(step, **jit_kw)
    jitted = jax.jit(
        lambda p, d, s, l, lrs: sharded_train_block(
            p, d, s, l, config=config, lr=lrs, mesh=mesh,
            placement=placement, axis=axis,
            grad_clip_norm=grad_clip_norm),
        **jit_kw)

    def run(p, d, s, l):
        k = d.shape[0]
        lrs = jnp.asarray([lr(run.step + i) for i in range(k)], jnp.float32)
        run.step += k
        return jitted(p, d, s, l, lrs)

    run.step = 0
    return run


def sharded_train_block_opt(params: dict, opt_state: dict, dense, sparse,
                            labels, *, config: DLRMConfig, lr, mesh,
                            placement, block: int = None, axis: str = "d",
                            unroll: bool = True,
                            optimizer: str = "adagrad",
                            grad_clip_norm=None):
    """Coalesced K-step ADAGRAD block on the hybrid-parallel path: per
    micro-step sharded lookup (tables as of block entry) + per-micro-step
    dense Adagrad; the K compressed pooled gradients are stacked and
    applied at block end with ONE dedup-then-apply Adagrad per shard
    (:func:`dlrm_tpu.parallel.embedding.sharded_update_adagrad` with
    ``block_leading`` — the dedup sums a key's gradient across micro-steps
    AND DCN replicas before the nonlinear accumulator update).

    Scheduled lr: per micro-step lr_k enters via the twin (g, lr_k*g)
    payload (concatenated on the feature dim so every collective carries
    both halves at once; split at the apply points — see
    sharded_update_adagrad's ``d_pooled_scaled``).
    """
    from dlrm_tpu.parallel import embedding as pemb
    from dlrm_tpu.train import optim
    import optax

    if block is None:
        block = dense.shape[0]
    scheduled = callable(lr)
    dense_params = {"bottom": params["bottom"], "top": params["top"]}
    cs = params.get("emb_cs", ())
    emb_h = params.get("emb_h")
    count = opt_state.get("count", jnp.zeros((), jnp.int32))
    tx = optim.dense_optimizer(optimizer, lr)
    dp = dense_params
    dense_state = opt_state["dense"]

    def micro_step(dp, dense_state, d, s, l):
        with jax.named_scope("lookup"):
            pooled = pemb.sharded_lookup(
                params["emb"], s, mesh=mesh, placement=placement,
                axis=axis, cs=cs, emb_h=emb_h,
                exchange_dtype=config.exchange_dtype)

        def inner(dp_, p_):
            return _loss_from_pooled(dp_, p_, d, l, config)

        loss, (dgrads, d_pooled) = jax.value_and_grad(
            inner, argnums=(0, 1))(dp, pooled)
        if grad_clip_norm is not None:
            # per-micro-step clip, same pytree as sharded_train_step_opt
            with jax.named_scope("grad_clip"):
                (dgrads, d_pooled), _ = optim.clip_by_global_norm(
                    grad_clip_norm, (dgrads, d_pooled))
        with jax.named_scope("dense_update"):
            updates, new_dense_state = tx.update(dgrads, dense_state, dp)
            dp = jax.tree.map(lambda p, q: q.astype(p.dtype), dp,
                              optax.apply_updates(dp, updates))
        return dp, new_dense_state, loss, d_pooled

    def lr_at(k):
        return lr(count + k) if scheduled else lr

    if unroll:
        losses, d_pooled_acc, scaled_acc = [], [], []
        for k in range(block):
            dp, dense_state, loss, d_pooled = micro_step(
                dp, dense_state, dense[k], sparse[k], labels[k])
            losses.append(loss)
            d_pooled_acc.append(d_pooled)
            if scheduled:
                scaled_acc.append(lr_at(k) * d_pooled)
        losses = jnp.stack(losses)
        d_stack = jnp.stack(d_pooled_acc)  # (K, B, T, D), dim 1 sharded
        scaled_stack = jnp.stack(scaled_acc) if scheduled else None
    else:
        # lax.scan over micro-steps (shard_map composes under scan):
        # much faster first compile, slightly slower steady-state
        def body(carry, xs):
            dp, dense_state = carry
            d, s, l, k = xs
            dp, dense_state, loss, d_pooled = micro_step(
                dp, dense_state, d, s, l)
            ys = (loss, d_pooled) + (
                ((lr_at(k) * d_pooled),) if scheduled else ())
            return (dp, dense_state), ys

        (dp, dense_state), ys = jax.lax.scan(
            body, (dp, dense_state),
            (dense, sparse, labels, jnp.arange(block)))
        losses, d_stack = ys[0], ys[1]
        scaled_stack = ys[2] if scheduled else None

    with jax.named_scope("coalesced_adagrad_update"):
        new_emb, new_acc, new_h, new_acc_h, new_cs, new_acc_cs = \
            pemb.sharded_update_adagrad(
                params["emb"], opt_state["emb_acc"], sparse, d_stack,
                1.0 if scheduled else lr,
                mesh=mesh, placement=placement, axis=axis, cs=cs,
                acc_cs=opt_state.get("emb_acc_cs", ()), emb_h=emb_h,
                acc_h=(None if isinstance(opt_state.get("emb_acc_h", ()),
                                          tuple)
                       else opt_state["emb_acc_h"]),
                block_leading=True, d_pooled_scaled=scaled_stack,
                rowwise=optimizer == "rowwise_adagrad",
                exchange_dtype=config.exchange_dtype)
    new_opt = {"dense": dense_state, "count": count + block,
               "emb_acc": new_acc, "emb_acc_cs": new_acc_cs,
               "emb_acc_h": new_acc_h if new_acc_h is not None else ()}
    new_params = {"bottom": dp["bottom"], "emb": new_emb, "top": dp["top"]}
    if "emb_cs" in params:
        new_params["emb_cs"] = new_cs
    if "emb_h" in params:
        new_params["emb_h"] = new_h
    return (new_params, new_opt), losses


def make_sharded_train_block_opt(config: DLRMConfig, *, optimizer: str,
                                 lr, mesh, placement, block: int = None,
                                 axis: str = "d",
                                 unroll: bool = True,
                                 grad_clip_norm=None) -> Callable:
    del block  # derived from the batch's leading dim at trace time
    check_mesh_interaction(config)
    assert optimizer in ("adagrad", "rowwise_adagrad"), \
        "SGD blocks use make_sharded_train_block"
    step = functools.partial(sharded_train_block_opt, config=config, lr=lr,
                             mesh=mesh, placement=placement, axis=axis,
                             unroll=unroll, optimizer=optimizer,
                             grad_clip_norm=grad_clip_norm)
    if not placement.host_row_sharded:
        return jax.jit(step, donate_argnums=(0, 1))
    from jax.sharding import NamedSharding, PartitionSpec as P
    from dlrm_tpu.parallel.host_tier import ensure_backend_primed
    ensure_backend_primed()
    if not can_pin_host_outputs():
        # no output placement in pinned_host (the CPU backend): skip
        # donation so pinned-host inputs are not reused for
        # default-memory outputs
        return jax.jit(step)
    pin = NamedSharding(mesh, P(axis), memory_kind="pinned_host")
    out_params = {"bottom": None, "emb": None, "top": None, "emb_h": pin}
    if placement.col_sharded:
        out_params["emb_cs"] = None
    out_opt = {"dense": None, "count": None, "emb_acc": None,
               "emb_acc_cs": None, "emb_acc_h": pin}
    return jax.jit(step, donate_argnums=(0, 1),
                   out_shardings=((out_params, out_opt), None))


def make_sharded_train_step(config: DLRMConfig, lr: float, mesh, placement,
                            axis: str = "d") -> Callable:
    """Jitted hybrid train step with explicit in/out shardings."""
    from dlrm_tpu.parallel.mesh import batch_sharding, param_shardings

    check_mesh_interaction(config)
    from jax.sharding import NamedSharding, PartitionSpec as P

    step = functools.partial(sharded_train_step, config=config, lr=lr,
                             mesh=mesh, placement=placement, axis=axis)
    bs = batch_sharding(mesh, axis)

    def shardings_for(params):
        return param_shardings(mesh, params, axis)

    if placement.host_row_sharded:
        from dlrm_tpu.parallel.host_tier import ensure_backend_primed
        ensure_backend_primed()
    if not placement.host_row_sharded:
        jitted = jax.jit(step, donate_argnums=(0,))
    elif can_pin_host_outputs():
        # pin the host stack's OUTPUT back to pinned_host so it never
        # round-trips through HBM between steps (donated in, pinned out)
        out_params = {
            "bottom": None, "emb": None, "top": None,
            "emb_h": NamedSharding(mesh, P(axis),
                                   memory_kind="pinned_host"),
        }
        if placement.col_sharded:
            out_params["emb_cs"] = None
        jitted = jax.jit(step, donate_argnums=(0,),
                         out_shardings=(out_params, None))
    else:
        # no output placement in pinned_host (the CPU backend, see
        # utils/backend.can_pin_host_outputs); skip donation so the
        # pinned-host input is not reused for a default-memory output
        jitted = jax.jit(step)

    def run(params, dense, sparse, labels):
        return jitted(params, dense, sparse, labels)

    run.shardings_for = shardings_for
    run.batch_sharding = bs
    return run


def train(params: dict, data: Iterable, *, config: DLRMConfig,
          lr: float, maxiters: Optional[int] = None,
          callback: Optional[Callable[[int, float], None]] = None,
          sync_every: int = 1) -> Dict[str, Any]:
    """Host loop over batches; the analog of ``train!`` (train.jl:189-240).

    Returns per-iteration wall-clock times (ns) and losses, like the
    reference.  ``data`` yields dicts with keys dense/sparse/labels.

    ``sync_every``: fetch the loss (a device->host sync) every N steps
    instead of every step.  The default 1 matches the reference's
    per-iteration timing contract, but each fetch costs a host round-trip
    (~13 ms of a 31 ms Kaggle step through a real network) — embedders
    doing throughput runs should raise it.  With N > 1,
    losses/iteration_times carry one entry per SYNCED step
    (iteration_times = mean ns/step over the window) and the callback
    fires on those steps only (step index of the synced step).
    """
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    step_fn = make_jit_train_step(config, lr)
    losses = []
    iteration_times = []
    count = 0
    pending = None
    start = time.perf_counter_ns()

    def sync(loss, window):
        nonlocal start
        loss = float(loss)  # syncs (reference: per-iteration timing)
        now = time.perf_counter_ns()
        iteration_times.append((now - start) // window)
        start = now
        losses.append(loss)
        if callback is not None:
            callback(count - 1, loss)

    for batch in data:
        params, loss = step_fn(params, batch["dense"], batch["sparse"],
                               batch["labels"])
        count += 1
        if count % sync_every == 0:
            sync(loss, sync_every)
            pending = None
        else:
            pending = loss
        if maxiters is not None and count >= maxiters:
            break
    if pending is not None:  # stream end between sync points: final loss
        sync(pending, count % sync_every)  # tail window < sync_every steps
    return {"params": params, "losses": losses,
            "iteration_times": iteration_times}
