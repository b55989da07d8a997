"""Two-tier embedding storage: HBM + host memory (the CachedArrays analog).

The reference trains with embedding tables deliberately evicted to a slow
memory tier (Optane PMM) managed by CachedArrays.jl — a local/remote heap
with explicit migration and a read/write permission state machine
(/root/reference/src/DLRM.jl:47-67, src/cachedarrays.jl; SURVEY.md §2.2).
Here the same capability — "tables bigger than device memory" — maps to
**host-memory-resident table shards with on-demand row movement**:

* The stacked embedding array is split into a **device tier** (HBM) and a
  **host tier** (``pinned_host`` memory kind), chosen by ``plan_tiers`` to
  fit an HBM budget (largest tables spill first, like the reference evicting
  its big tables to the remote heap).
* Inside the ONE jitted train step, host-tier lookups move the batch's ids
  to host memory, run a raw ``lax.gather`` as sub-program scheduled on the
  host (``compute_on("device_host")``), and stream only the gathered rows
  (B·T_host·D, a few MB) over PCIe to the device — never the tables.
* The sparse SGD update runs ``lax.scatter_add`` host-side the same way, so
  gradients also cross PCIe compressed.  XLA overlaps the host gather of
  step N+1's spilled rows with device compute via its async host-offload
  streams — the role of the reference's producer/consumer BatchUpdater
  pipeline (src/model/embedding_update.jl, SURVEY §2.4 P4) without the
  locked queue: the compiler owns the schedule.
* The permission state machine (readable/writable/release) has no analog:
  XLA owns buffer lifetime; donation replaces "release".

Raw ``lax.gather``/``lax.scatter_add`` (PROMISE_IN_BOUNDS) are used instead
of ``jnp.take``/``.at[]`` because the jnp wrappers materialize clamping
constants in the default memory space, which poisons host-memory-space type
checking.  Correctness relies on the data pipeline's reindex guaranteeing
in-range ids (data/criteo.py).

**Layout: host-tier stacks cross the jit boundary FLAT (1-D).**  A 2-D
pinned-host carry can get a device-tiled layout at the jit boundary
while the host scatter produces a host-linear one, and XLA then stages
the whole stack through the device to convert between them every step.
A 1-D buffer has one layout everywhere, so the stacks (tables and
Adagrad accumulator slabs) are carried flat and bitcast-reshaped to
(rows, width) inside the ``compute_on`` regions.  The remaining
linear-in-stack cost is the functional host scatter itself
(``compute_on`` region outputs do not alias donated inputs, unlike
XLA:CPU's in-place donated scatters).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import compute_on

from dlrm_tpu.config import DLRMConfig
from dlrm_tpu.utils.backend import can_pin_host_outputs


_BACKEND_PRIMED = False


def ensure_backend_primed() -> None:
    """Work around a JAX lazy-initialization quirk: if the FIRST jit
    compiled in a process mixes memory spaces (pinned_host operands inside
    the program), abstract evaluation drops the input's memory space and
    tracing fails with "memory_space of all inputs ... must be the same".
    Any prior successful jit compilation initializes the machinery.  Call
    before building a program that touches pinned_host."""
    global _BACKEND_PRIMED
    if _BACKEND_PRIMED:
        return
    jax.jit(lambda x: x + 1)(jnp.zeros((1,), jnp.float32)
                             ).block_until_ready()
    _BACKEND_PRIMED = True


def host_memory_supported(device=None) -> bool:
    """True if the backend exposes a pinned_host memory space."""
    device = device or jax.devices()[0]
    return "pinned_host" in {m.kind for m in device.addressable_memories()}


# -- tier planning --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TierPlan:
    """Static assignment of tables to the device or host tier.

    ``device_tables``/``host_tables``: global table indices per tier, in
    global order.  Each tier stacks its tables row-wise (like the global
    stack in ops/embedding.py); ``*_offsets`` are row offsets inside the
    tier stack.
    """

    table_sizes: Tuple[int, ...]
    feature_size: int
    device_tables: Tuple[int, ...]
    host_tables: Tuple[int, ...]

    @property
    def device_offsets(self) -> Tuple[int, ...]:
        return self._offsets(self.device_tables)

    @property
    def host_offsets(self) -> Tuple[int, ...]:
        return self._offsets(self.host_tables)

    def _offsets(self, tables) -> Tuple[int, ...]:
        off, out = 0, []
        for t in tables:
            out.append(off)
            off += self.table_sizes[t]
        return tuple(out)

    @property
    def device_rows(self) -> int:
        return sum(self.table_sizes[t] for t in self.device_tables)

    @property
    def host_rows(self) -> int:
        return sum(self.table_sizes[t] for t in self.host_tables)


def plan_tiers(config: DLRMConfig, hbm_budget_bytes: Optional[int],
               bytes_per_elem: Optional[int] = None) -> TierPlan:
    """Assign tables to tiers under an HBM byte budget.

    Largest tables spill to host first (the reference evicts its big tables
    to the remote heap, src/DLRM.jl:64-67).  ``hbm_budget_bytes=None`` keeps
    everything on device (an all-device TierPlan).
    """
    if bytes_per_elem is None:
        bytes_per_elem = jnp.dtype(config.embedding_dtype).itemsize
    row_bytes = config.feature_size * bytes_per_elem
    sizes = config.table_sizes
    if hbm_budget_bytes is None:
        return TierPlan(sizes, config.feature_size, tuple(range(len(sizes))),
                        ())
    order = sorted(range(len(sizes)), key=lambda t: sizes[t])  # small first
    used = 0
    device, host = [], []
    for t in order:
        b = sizes[t] * row_bytes
        if used + b <= hbm_budget_bytes:
            device.append(t)
            used += b
        else:
            host.append(t)
    return TierPlan(sizes, config.feature_size,
                    tuple(sorted(device)), tuple(sorted(host)))


def device_subconfig(plan: TierPlan, config: DLRMConfig
                     ) -> Optional[DLRMConfig]:
    """DLRMConfig describing ONLY the device-tier tables.

    The device tier stores its tables in the PRODUCTION engine format
    (lane-packed chunked storage, ops/embedding.py) under this
    sub-config, so its updates are per-chunk scatters rather than a
    full-stack pass.  Table order inside the sub-config is
    ``plan.device_tables`` (global order); ids are per-table local, so
    selecting the device columns of ``sparse`` feeds the engine
    directly.  Returns None when no tables live on device."""
    if not plan.device_tables:
        return None
    return dataclasses.replace(
        config, table_sizes=tuple(config.table_sizes[t]
                                  for t in plan.device_tables))


def split_tiers(emb: np.ndarray, plan: TierPlan, config: DLRMConfig,
                device=None):
    """Split the global (R, D) stack into tier storage and place it:
    device tier as ENGINE CHUNKS (lane-packed, device memory), host tier
    as one FLAT pinned_host array."""
    from dlrm_tpu.ops import embedding as emb_ops

    device = device or jax.devices()[0]
    if isinstance(emb, (tuple, list)):
        emb = emb_ops.unpack_tables(tuple(np.asarray(c) for c in emb),
                                    config)
    emb = np.asarray(emb)
    d = emb.shape[1]

    def stack(tables):
        if not tables:
            return np.zeros((0, d), emb.dtype)
        return np.concatenate(
            [emb[config.table_offsets[t]:
                 config.table_offsets[t] + config.table_sizes[t]]
             for t in tables], axis=0)

    dev_cfg = device_subconfig(plan, config)
    if dev_cfg is None:
        emb_dev = ()
    else:
        emb_dev = tuple(
            jax.device_put(c, device)
            for c in emb_ops.pack_tables(stack(plan.device_tables),
                                         dev_cfg))
    # host tier carried FLAT across the jit boundary (module docstring)
    host_np = stack(plan.host_tables).reshape(-1)
    emb_host = jax.device_put(host_np, _host_sharding(device))
    return emb_dev, emb_host


def merge_tiers(emb_dev, emb_host, plan: TierPlan, config: DLRMConfig
                ) -> np.ndarray:
    """Inverse of split_tiers: reassemble the global (R, D) stack on host.
    Accepts engine-chunk (round-5) or legacy (R_dev, D) device storage,
    and the flat (round-5) or legacy (N, D) host layout."""
    from dlrm_tpu.ops import embedding as emb_ops

    if isinstance(emb_dev, (tuple, list)):
        dev_cfg = device_subconfig(plan, config)
        dev = (np.asarray(emb_ops.unpack_tables(
            tuple(np.asarray(c) for c in emb_dev), dev_cfg))
            if dev_cfg is not None
            else np.zeros((0, config.feature_size), np.float32))
    else:
        dev = np.asarray(emb_dev)
    host = np.asarray(emb_host).reshape(-1, config.feature_size)
    out = np.zeros((config.total_rows, config.feature_size), dev.dtype
                   if dev.size else host.dtype)
    for tables, stackarr, offs in (
            (plan.device_tables, dev, plan.device_offsets),
            (plan.host_tables, host, plan.host_offsets)):
        for t, lo in zip(tables, offs):
            go = config.table_offsets[t]
            n = config.table_sizes[t]
            out[go:go + n] = stackarr[lo:lo + n]
    return out


# -- raw gather / scatter (memory-space clean) ----------------------------------

def _raw_gather(table, flat_ids):
    dnums = lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(0,), start_index_map=(0,))
    return lax.gather(table, flat_ids[:, None], dnums,
                      slice_sizes=(1, table.shape[1]),
                      mode=lax.GatherScatterMode.PROMISE_IN_BOUNDS)


def _raw_scatter_add(table, flat_ids, updates):
    dnums = lax.ScatterDimensionNumbers(
        update_window_dims=(1,), inserted_window_dims=(0,),
        scatter_dims_to_operand_dims=(0,))
    return lax.scatter_add(table, flat_ids[:, None], updates, dnums,
                           mode=lax.GatherScatterMode.PROMISE_IN_BOUNDS)


def _tier_ids(sparse, tables, offsets, block_leading: bool = False):
    """(B, T[, H]) — or (K, B, T[, H]) with ``block_leading`` — global
    sparse ids -> flat row ids into a tier stack."""
    t_axis = 2 if block_leading else 1
    idx = [slice(None)] * t_axis + [tables]
    ids = sparse[tuple(idx)]
    offs = jnp.asarray(offsets, ids.dtype)
    # offsets broadcast over the trailing H axis when multi-hot
    ids = ids + (offs if ids.ndim == t_axis + 1 else offs[:, None])
    return ids


def host_tier_gather(emb_host, flat_ids, width: int):
    """Gather rows from the FLAT host-resident stack; returns
    device-resident rows.  flat_ids: any shape; result
    flat_ids.shape + (width,).  The (rows, width) view is materialized
    inside the host region, where a reshape of a linear buffer is a
    bitcast (module docstring)."""
    shape = flat_ids.shape
    # the no-op re-annotation pins the table's aval to host memory space;
    # trace-time inference can drop the tag when other jit inputs were
    # placed from a different thread (see parallel/embedding.py)
    emb_host = jax.device_put(emb_host, jax.memory.Space.Host)
    ids_h = jax.device_put(flat_ids.reshape(-1), jax.memory.Space.Host)
    with compute_on.compute_on("device_host"):
        rows = _raw_gather(emb_host.reshape(-1, width), ids_h)
    rows = jax.device_put(rows, jax.memory.Space.Device)
    return rows.reshape(shape + (width,))


def host_tier_scatter_add(emb_host, flat_ids, updates, width: int):
    """Scatter-add updates into the FLAT host-resident stack (host
    compute); updates stream host-ward compressed and the result returns
    flat (no layout conversion at the jit boundary)."""
    emb_host = jax.device_put(emb_host, jax.memory.Space.Host)
    ids_h = jax.device_put(flat_ids.reshape(-1), jax.memory.Space.Host)
    upd_h = jax.device_put(
        updates.reshape(-1, updates.shape[-1]).astype(emb_host.dtype),
        jax.memory.Space.Host)
    with compute_on.compute_on("device_host"):
        new = _raw_scatter_add(emb_host.reshape(-1, width), ids_h,
                               upd_h).reshape(emb_host.shape)
    return new


# -- tiered lookup / train step --------------------------------------------------

def tiered_lookup(emb_dev, emb_host, sparse, plan: TierPlan,
                  config: DLRMConfig) -> jax.Array:
    """Pooled (B, T, D) lookup across both tiers (inference path).
    Device tier is engine storage under the device sub-config."""
    from dlrm_tpu.ops import embedding as emb_ops

    parts = []
    order = []
    if plan.device_tables:
        dev_cfg = device_subconfig(plan, config)
        dts = list(plan.device_tables)
        dev_ids = sparse[:, dts] if sparse.ndim == 2 else sparse[:, dts, :]
        parts.append(emb_ops.mixed_lookup(emb_dev, dev_ids, dev_cfg))
        order += dts
    if plan.host_tables:
        ids = _tier_ids(sparse, list(plan.host_tables), plan.host_offsets)
        rows = host_tier_gather(emb_host, ids, config.feature_size)
        parts.append(rows if rows.ndim == 3 else jnp.sum(rows, axis=2))
        order += list(plan.host_tables)
    stacked = jnp.concatenate(
        [p.astype(jnp.dtype(config.embedding_dtype)) for p in parts],
        axis=1)
    inv = np.argsort(np.asarray(order))
    return jnp.take(stacked, jnp.asarray(inv), axis=1)


def _tier_forward_backward(dense_params, emb_dev, emb_host, dense, sparse,
                           labels, *, config: DLRMConfig, plan: TierPlan,
                           host_rows=None):
    """Shared two-tier lookup + loss + backward for the tiered steps
    (the one place the tier-gather / pooled-order / value_and_grad logic
    lives — the SGD, block, pipelined, and optimizer steps all call it).

    Round 5: the device tier is PRODUCTION ENGINE storage under
    :func:`device_subconfig` — its lookups follow the engine's mixed
    strategy (big tables: compressed gathered-row grads via one fused
    lane-packed gather per chunk; small tables: a differentiable gather
    with dense (R, D) grads), exactly like train.train_step.

    ``host_rows``: pre-gathered host-tier rows (the pipelined/block
    paths' payload); ``None`` gathers from ``emb_host`` inline.

    Returns ``(loss, dgrads, d_rows_big, d_smalls, d_host, ids_dev_big,
    ids_host)``: the device grads in the engine decomposition
    (``ids_dev_big`` are per-table LOCAL ids into the sub-config's
    ``big`` tables), ``d_host`` the grad w.r.t. the host-tier rows."""
    from dlrm_tpu.models import dlrm as model_lib
    from dlrm_tpu.ops import embedding as emb_ops

    emb_dtype = jnp.dtype(config.embedding_dtype)
    B = dense.shape[0]
    dev_cfg = device_subconfig(plan, config)
    small, big = (), ()
    dev_sparse = ids_dev_big = None
    small_tabs = ()
    rows_big = jnp.zeros((B, 0, config.feature_size), emb_dtype)
    if dev_cfg is not None:
        emb_ops.check_storage(emb_dev, dev_cfg)
        dts = list(plan.device_tables)
        dev_sparse = (sparse[:, dts] if sparse.ndim == 2
                      else sparse[:, dts, :])
        small, big = emb_ops.partition_tables(
            dev_cfg.table_sizes, dev_cfg.small_table_threshold)
        if big:
            ids_dev_big = (dev_sparse[:, big] if dev_sparse.ndim == 2
                           else dev_sparse[:, big, :])
            with jax.named_scope("lookup_device_gather"):
                rows_big = emb_ops.gather_tables(emb_dev, ids_dev_big,
                                                 dev_cfg, big)
        small_tabs = tuple(emb_ops.get_logical_table(emb_dev, dev_cfg, t)
                           for t in small)
    ids_host = None
    if plan.host_tables:
        ids_host = _tier_ids(sparse, list(plan.host_tables),
                             plan.host_offsets)
        if host_rows is None:
            with jax.named_scope("lookup_host_tier"):
                host_rows = host_tier_gather(emb_host, ids_host,
                                             config.feature_size)
    else:
        host_rows = jnp.zeros((B, 0, config.feature_size), emb_dtype)

    # pooled column order: [dev big..., dev small..., host...] -> global
    order = ([plan.device_tables[t] for t in big]
             + [plan.device_tables[t] for t in small]
             + list(plan.host_tables))
    inv = jnp.asarray(np.argsort(np.asarray(order)))

    def inner(dp, rows_big_, small_tabs_, host_rows_):
        parts = [emb_ops.pool(rows_big_)]
        with jax.named_scope("lookup_small"):
            for j, t in enumerate(small):
                idt = (dev_sparse[:, t] if dev_sparse.ndim == 2
                       else dev_sparse[:, t, :])
                parts.append(emb_ops.small_table_lookup(
                    small_tabs_[j], idt, config.compute_dtype
                    )[:, None, :])
        parts.append(host_rows_ if host_rows_.ndim == 3
                     else jnp.sum(host_rows_, axis=2))
        pooled = jnp.concatenate(
            [p.astype(emb_dtype) for p in parts], axis=1)
        pooled = jnp.take(pooled, inv, axis=1)
        # the shared loss closure: config.remat covers this path too
        return model_lib.loss_from_pooled(dp, pooled, dense, labels,
                                          config)

    loss, (dgrads, d_rows_big, d_smalls, d_host) = jax.value_and_grad(
        inner, argnums=(0, 1, 2, 3))(dense_params, rows_big, small_tabs,
                                     host_rows)
    return (loss, dgrads, d_rows_big, d_smalls, d_host, ids_dev_big,
            ids_host)


def _small_sgd_add(new_emb, dev_cfg, small, d_smalls, lr):
    """Contiguous dense SGD adds for the small (dense-gradient) tables onto their
    chunk slices (shared by _device_sgd_apply and tiered_train_block —
    pad slots get zero updates and round-trip unchanged).  Mutates and
    returns ``new_emb`` (a list of chunks)."""
    emb_dtype = new_emb[0].dtype
    for j, t in enumerate(small):
        upd = (-lr * d_smalls[j]).astype(emb_dtype)
        c = dev_cfg.table_chunk[t]
        po = dev_cfg.chunk_table_offsets[t]
        pn = dev_cfg.packed_table_rows[t]
        pad = pn * dev_cfg.pack - dev_cfg.table_sizes[t]
        if pad:
            upd = jnp.concatenate(
                [upd, jnp.zeros((pad, upd.shape[1]), upd.dtype)])
        new_emb[c] = new_emb[c].at[po:po + pn].add(
            upd.reshape(pn, dev_cfg.row_width))
    return new_emb


def _device_sgd_apply(emb_dev, dev_cfg, ids_dev_big, d_rows_big, d_smalls,
                      lr):
    """train_step's mixed SGD update on the device sub-config storage:
    one scatter per chunk for big tables, contiguous dense adds for the
    small tables."""
    from dlrm_tpu.ops import embedding as emb_ops

    small, big = emb_ops.partition_tables(dev_cfg.table_sizes,
                                          dev_cfg.small_table_threshold)
    new_emb = list(emb_dev)
    if big:
        new_emb = list(emb_ops.apply_sgd_chunked(
            new_emb, ids_dev_big, d_rows_big, lr, dev_cfg, big))
    return tuple(_small_sgd_add(new_emb, dev_cfg, small, d_smalls, lr))


def tiered_train_step(params, dense, sparse, labels, *, config: DLRMConfig,
                      lr: float, plan: TierPlan):
    """One SGD step with two-tier tables; params = {bottom, top, emb_dev
    (engine chunks), emb_host (flat pinned)}.  Embedding grads stay
    compressed on both tiers."""
    dense_params = {"bottom": params["bottom"], "top": params["top"]}
    emb_dev, emb_host = params["emb_dev"], params["emb_host"]

    (loss, dgrads, d_rows_big, d_smalls, d_host, ids_dev_big,
     ids_host) = _tier_forward_backward(
        dense_params, emb_dev, emb_host, dense, sparse, labels,
        config=config, plan=plan)

    with jax.named_scope("dense_update"):
        new_dense = jax.tree.map(
            lambda p, g: (p - lr * g).astype(p.dtype), dense_params, dgrads)
    new_dev, new_host = emb_dev, emb_host
    if plan.device_tables:
        with jax.named_scope("device_tier_update"):
            new_dev = _device_sgd_apply(
                emb_dev, device_subconfig(plan, config), ids_dev_big,
                d_rows_big, d_smalls, lr)
    if plan.host_tables:
        with jax.named_scope("host_tier_update"):
            new_host = host_tier_scatter_add(emb_host, ids_host,
                                             -lr * d_host,
                                             config.feature_size)
    return ({"bottom": new_dense["bottom"], "top": new_dense["top"],
             "emb_dev": new_dev, "emb_host": new_host}, loss)


def tiered_train_block(params, dense, sparse, labels, *,
                       config: DLRMConfig, lr: float, plan: TierPlan,
                       block: int = None):
    """``block`` tiered SGD micro-steps fused into one program with the
    HOST-TIER work coalesced to ONE gather + ONE scatter per block, and
    the DEVICE tier's big-table scatters coalesced to one per chunk per
    block (train.train_block's relaxation, applied per tier).

    Why: the functional host scatter copies the whole pinned stack
    (linear in stack bytes — compute_on outputs do not alias donated
    inputs), and each host call carries a fixed overhead.  Amortizing both over K steps is
    the same lever the reference's BatchUpdater applies to its slow PMM
    tier (src/model/embedding_update.jl:1-37: aggregate updates in DRAM,
    trickle to the slow tier behind the forward pass).

    Exactness contract (mirrors train_block):
      * dense params and the device tier's SMALL (dense-gradient) tables update
        every micro-step — carried, never stale;
      * device BIG-table and host-tier rows are read as of block entry
        (stale < ``block``) and their commuting scatter-adds coalesce at
        block end, so with no row repeat across micro-batches the block
        is bit-identical to K sequential :func:`tiered_train_step` calls
        (oracle-tested);
      * ``block=1`` is exactly :func:`tiered_train_step`.

    Args: ``dense`` (K, B, 13), ``sparse`` (K, B, T[, H]), ``labels``
    (K, B).  Returns (new_params, (K,) losses).
    """
    from dlrm_tpu.ops import embedding as emb_ops

    if block is None:
        block = dense.shape[0]
    dense_params = {"bottom": params["bottom"], "top": params["top"]}
    emb_dev, emb_host = params["emb_dev"], params["emb_host"]
    dev_cfg = device_subconfig(plan, config)
    small, big = (), ()
    if dev_cfg is not None:
        small, big = emb_ops.partition_tables(
            dev_cfg.table_sizes, dev_cfg.small_table_threshold)

    host_rows_all = ids_host_all = None
    if plan.host_tables:
        ids_host_all = _tier_ids(sparse, list(plan.host_tables),
                                 plan.host_offsets, block_leading=True)
        with jax.named_scope("host_tier_block_gather"):
            # ONE host call for all K micro-batches' rows
            host_rows_all = host_tier_gather(emb_host, ids_host_all,
                                             config.feature_size)

    # device small tables carried exactly; big tables stale-within-block
    new_dev = list(emb_dev) if dev_cfg is not None else []
    dp = dense_params
    losses, ids_big_acc, d_big_acc, d_host_acc = [], [], [], []
    for k in range(block):
        (loss, dgrads, d_rows_big, d_smalls, d_host, ids_dev_big,
         _) = _tier_forward_backward(
            dp, tuple(new_dev), emb_host, dense[k], sparse[k], labels[k],
            config=config, plan=plan,
            host_rows=(host_rows_all[k] if plan.host_tables else None))
        with jax.named_scope("dense_update"):
            dp = jax.tree.map(
                lambda p, g: (p - lr * g).astype(p.dtype), dp, dgrads)
        if dev_cfg is not None and small:
            # small tables update per micro-step (contiguous adds)
            with jax.named_scope("small_table_update"):
                new_dev = _small_sgd_add(new_dev, dev_cfg, small,
                                         d_smalls, lr)
        if big:
            ids_big_acc.append(ids_dev_big)
            d_big_acc.append(d_rows_big)
        if plan.host_tables:
            d_host_acc.append(d_host)
        losses.append(loss)

    if big:
        with jax.named_scope("device_block_scatter"):
            ids_cat = jnp.concatenate(ids_big_acc, axis=0)
            d_cat = jnp.concatenate(d_big_acc, axis=0)
            new_dev = list(emb_ops.apply_sgd_chunked(
                new_dev, ids_cat, d_cat, lr, dev_cfg, big))

    new_host = emb_host
    if plan.host_tables:
        with jax.named_scope("host_tier_block_scatter"):
            # ONE commuting scatter-add for the whole block
            d_all = jnp.stack(d_host_acc)  # (K, B, Th[, H], D)
            new_host = host_tier_scatter_add(
                emb_host, ids_host_all, -lr * d_all, config.feature_size)
    return ({"bottom": dp["bottom"], "top": dp["top"],
             "emb_dev": tuple(new_dev), "emb_host": new_host},
            jnp.stack(losses))


def make_tiered_train_block(config: DLRMConfig, lr: float, plan: TierPlan,
                            block: int = None, device=None,
                            pin_host_output: Optional[bool] = None):
    """Jitted coalesced tiered block (see make_tiered_train_step for the
    host-output pinning rationale)."""
    del block  # derived from the batch's leading dim at trace time
    ensure_backend_primed()
    device = device or jax.devices()[0]
    if pin_host_output is None:
        pin_host_output = can_pin_host_outputs(device)
    step = functools.partial(tiered_train_block, config=config, lr=lr,
                             plan=plan)
    if not pin_host_output:
        return jax.jit(step)
    sh_host = jax.sharding.SingleDeviceSharding(device,
                                                memory_kind="pinned_host")
    out_shardings = ({"bottom": None, "top": None, "emb_dev": None,
                      "emb_host": sh_host}, None)
    return jax.jit(step, donate_argnums=(0,), out_shardings=out_shardings)


def tiered_train_step_pipelined(params, pref_rows, dense, sparse, labels,
                                sparse_next, *, config: DLRMConfig,
                                lr: float, plan: TierPlan):
    """One SGD step with SOFTWARE-PIPELINED host-tier prefetch: the
    host-tier rows for THIS batch arrive as ``pref_rows`` (gathered by the
    PREVIOUS program), and this program's LAST host op gathers batch
    N+1's rows from the freshly-updated host stack.

    This is the reference BatchUpdater's reason to exist
    (src/model/embedding_update.jl:1-37 — hide slow-tier latency behind
    compute) in XLA terms: because the next-batch gather reads the
    UPDATED stack, it is ordered after this step's scatter by data
    dependency — the prefetched rows are always EXACT (no conflict mask
    or re-gather-merge needed; a row written by step N and read by N+1
    flows through new_host).  The device-side forward/backward never
    waits on a host gather at program START; the gather for N+1 runs on
    the host offload stream concurrently with this program's dense
    updates and the inter-step host work.

    Returns ((new_params, next_pref_rows), loss).  Drive it with
    :func:`prime_host_prefetch` for batch 0 and a one-batch-lookahead
    iterator (run.py --host-prefetch)."""
    dense_params = {"bottom": params["bottom"], "top": params["top"]}
    emb_dev, emb_host = params["emb_dev"], params["emb_host"]

    # host rows prefetched by the PREVIOUS step ride in as pref_rows
    (loss, dgrads, d_rows_big, d_smalls, d_host, ids_dev_big,
     ids_host) = _tier_forward_backward(
        dense_params, emb_dev, emb_host, dense, sparse, labels,
        config=config, plan=plan, host_rows=pref_rows)

    with jax.named_scope("dense_update"):
        new_dense = jax.tree.map(
            lambda p, g: (p - lr * g).astype(p.dtype), dense_params,
            dgrads)
    new_dev, new_host = emb_dev, emb_host
    if plan.device_tables:
        with jax.named_scope("device_tier_update"):
            new_dev = _device_sgd_apply(
                emb_dev, device_subconfig(plan, config), ids_dev_big,
                d_rows_big, d_smalls, lr)
    next_pref = pref_rows
    if plan.host_tables:
        with jax.named_scope("host_tier_update"):
            new_host = host_tier_scatter_add(emb_host, ids_host,
                                             -lr * d_host,
                                             config.feature_size)
        ids_next = _tier_ids(sparse_next, list(plan.host_tables),
                             plan.host_offsets)
        with jax.named_scope("host_tier_prefetch_next"):
            # reads new_host -> ordered after the scatter: always exact
            next_pref = host_tier_gather(new_host, ids_next,
                                         config.feature_size)
    new_params = {"bottom": new_dense["bottom"], "top": new_dense["top"],
                  "emb_dev": new_dev, "emb_host": new_host}
    return (new_params, next_pref), loss


def make_tiered_pipelined_step(config: DLRMConfig, lr: float,
                               plan: TierPlan, device=None,
                               pin_host_output: Optional[bool] = None):
    """Jitted pipelined two-tier SGD step (see make_tiered_train_step for
    the host-output pinning rationale; the prefetched rows live in DEVICE
    memory — they are this batch's working set)."""
    ensure_backend_primed()
    device = device or jax.devices()[0]
    if pin_host_output is None:
        pin_host_output = can_pin_host_outputs(device)
    step = functools.partial(tiered_train_step_pipelined, config=config,
                             lr=lr, plan=plan)
    if not pin_host_output:
        return jax.jit(step)
    sh_host = jax.sharding.SingleDeviceSharding(device,
                                                memory_kind="pinned_host")
    out_shardings = ((({"bottom": None, "top": None, "emb_dev": None,
                        "emb_host": sh_host}), None), None)
    # NO donation here (unlike the other tiered makers): donating into
    # the pipelined program, whose tail gather reads the freshly-scattered
    # host stack, crashed the compiler this step was first built with;
    # not yet retried on the GPU.  Cost: the device tier and pinned stack
    # are transiently 2x resident.
    return jax.jit(step, out_shardings=out_shardings)


def prime_host_prefetch(emb_host, sparse, plan: TierPlan):
    """Gather batch 0's host-tier rows (the pipeline preamble); jitted by
    the caller's first use — one extra host gather per RUN, not per
    step."""
    ids = _tier_ids(sparse, list(plan.host_tables), plan.host_offsets)
    return jax.jit(host_tier_gather,
                   static_argnums=(2,))(emb_host, ids, plan.feature_size)


def _adagrad_rows(acc_rows, g, eps: float = 1e-10):
    """Elementwise Adagrad on deduped rows: returns (delta_acc, step_rows)
    with the same semantics as train/optim.apply_adagrad_chunked;
    the caller applies the learning rate (w -= lr * step_rows)."""
    acc_new = acc_rows + g * g
    step = g * jnp.where(acc_new > 0, jax.lax.rsqrt(acc_new + eps), 0.0)
    return g * g, step


def _rowwise_rows(acc_sel, g, eps: float = 1e-10):
    """ROW-WISE Adagrad on deduped rows: ``acc_sel`` is the (M,) scalar
    accumulator per row; returns (delta_acc (M,), step_rows (M, D)) —
    acc += mean_D(g^2), step = g * rsqrt(acc'+eps) (same contract as
    train/optim.apply_rowwise_adagrad_chunked)."""
    g2m = jnp.mean(g * g, axis=-1)
    acc_new = acc_sel + g2m
    step = g * jnp.where(acc_new > 0,
                         jax.lax.rsqrt(acc_new + eps), 0.0)[:, None]
    return g2m, step


def _device_tier_opt_apply(emb_dev, acc, dev_cfg, ids_dev_big, d_rows_big,
                           d_smalls, *, optimizer, lr_t):
    """Exact Adagrad-family update on the device tier's ENGINE storage:
    big tables via the production per-chunk hybrid (dedup-then-apply),
    small tables via dense-table Adagrad on their chunk views.
    ``acc`` is the tuple of per-chunk accumulators; returns
    (new_emb_dev, new_acc)."""
    from dlrm_tpu.ops import embedding as emb_ops
    from dlrm_tpu.train import optim

    rowwise = optimizer == "rowwise_adagrad"
    small, big = emb_ops.partition_tables(dev_cfg.table_sizes,
                                          dev_cfg.small_table_threshold)
    state = (optim.EmbRowwiseAdagradState(acc=tuple(acc)) if rowwise
             else optim.EmbAdagradState(acc=tuple(acc)))
    new_emb = list(emb_dev)
    if big:
        new_emb, state = optim.apply_adagrad_hybrid(
            new_emb, state, ids_dev_big,
            d_rows_big.astype(jnp.float32), lr_t, dev_cfg, big,
            rowwise=rowwise)
        new_emb = list(new_emb)
    new_acc = list(state.acc)
    small_apply = (optim.apply_rowwise_adagrad_dense_table if rowwise
                   else optim.apply_adagrad_dense_table)
    d = dev_cfg.feature_size
    for j, t in enumerate(small):
        c = dev_cfg.table_chunk[t]
        po = dev_cfg.chunk_table_offsets[t]
        pn = dev_cfg.packed_table_rows[t]
        n = dev_cfg.table_sizes[t]
        tab = new_emb[c][po:po + pn].reshape(-1, d)[:n]
        acc_view = (new_acc[c][po:po + pn].reshape(-1)[:n] if rowwise
                    else new_acc[c][po:po + pn].reshape(-1, d)[:n])
        tab2, acc2 = small_apply(tab, acc_view, d_smalls[j], lr_t)
        pad = pn * dev_cfg.pack - n
        if pad:
            # pad slots are never read but must round-trip unchanged
            orig = new_emb[c][po:po + pn].reshape(-1, d)
            tab2 = jnp.concatenate([tab2, orig[n:]])
            orig_acc = (new_acc[c][po:po + pn].reshape(-1) if rowwise
                        else new_acc[c][po:po + pn].reshape(-1, d))
            acc2 = jnp.concatenate([acc2, orig_acc[n:]])
        new_emb[c] = new_emb[c].at[po:po + pn].set(
            tab2.reshape(pn, dev_cfg.row_width))
        new_acc[c] = new_acc[c].at[po:po + pn].set(
            acc2.reshape(pn, dev_cfg.pack if rowwise
                         else dev_cfg.row_width))
    return tuple(new_emb), tuple(new_acc)


def _host_tier_opt_apply(emb_host, acc, flat_ids, g, *, optimizer, lr_t,
                         config):
    """Dedup-then-apply Adagrad on the HOST tier stack: returns
    (new_emb_host, new_acc).  One accumulator gather + two host scatters;
    only the deduped (ids, g), g^2 and step rows cross PCIe."""
    from dlrm_tpu.ops import embedding as emb_ops

    out = emb_ops.dedup_sparse_grad(emb_ops.SparseGrad(flat_ids, g))
    ids_u, g_u = out.ids, out.rows
    # clamp the -1 surplus slots to row 0 with zero updates (host
    # scatters run PROMISE_IN_BOUNDS, no 'drop' mode)
    valid = (ids_u >= 0)[:, None]
    ids_u = jnp.maximum(ids_u, 0)
    g_u = g_u * valid
    rowwise = optimizer == "rowwise_adagrad"
    accw = 1 if rowwise else config.feature_size
    acc_rows = host_tier_gather(acc, ids_u, accw)
    if rowwise:
        # acc is a flat (host_rows,) pinned scalar slab — 1/D the
        # slow-tier optimizer bytes AND 1/D the PCIe traffic of the
        # accumulator round-trip
        d_acc, step_rows = _rowwise_rows(acc_rows[:, 0], g_u)
        d_acc = d_acc[:, None]
    else:
        d_acc, step_rows = _adagrad_rows(acc_rows, g_u)
    new_acc = host_tier_scatter_add(acc, ids_u, d_acc, accw)
    new_host = host_tier_scatter_add(emb_host, ids_u, -lr_t * step_rows,
                                     config.feature_size)
    return new_host, new_acc


def tiered_train_step_opt(params, opt_state, dense, sparse, labels, *,
                          config: DLRMConfig, optimizer: str, lr,
                          plan: TierPlan):
    """Two-tier step with a pluggable optimizer (sgd | adagrad).

    The Adagrad accumulator lives tier-matched: a device-resident slab for
    the device tier, a pinned-host slab for the host tier (updated with
    host-side gather/scatter like the tables themselves — the reference
    keeps optimizer work on the PMM tier's writeback threads the same way,
    src/model/embedding_update.jl).  Duplicate ids are deduped before the
    nonlinear accumulator update (dedup-then-apply contract).
    """
    from dlrm_tpu.train import optim
    import optax

    dense_params = {"bottom": params["bottom"], "top": params["top"]}
    emb_dev, emb_host = params["emb_dev"], params["emb_host"]

    (loss, dgrads, d_rows_big, d_smalls, d_host, ids_dev_big,
     ids_host) = _tier_forward_backward(
        dense_params, emb_dev, emb_host, dense, sparse, labels,
        config=config, plan=plan)

    count = opt_state["count"]
    lr_t = lr(count) if callable(lr) else lr
    tx = optim.dense_optimizer(optimizer, lr)
    with jax.named_scope("dense_update"):
        updates, new_dense_state = tx.update(dgrads, opt_state["dense"],
                                             dense_params)
        new_dense = optax.apply_updates(dense_params, updates)
        new_dense = jax.tree.map(
            lambda p, q: q.astype(p.dtype), dense_params, new_dense)

    new_dev, new_host = emb_dev, emb_host
    new_opt = {"dense": new_dense_state, "count": count + 1,
               "dev_acc": opt_state.get("dev_acc", ()),
               "host_acc": opt_state.get("host_acc", ())}
    if plan.device_tables:
        dev_cfg = device_subconfig(plan, config)
        if optimizer == "sgd":
            with jax.named_scope("device_tier_update"):
                new_dev = _device_sgd_apply(emb_dev, dev_cfg, ids_dev_big,
                                            d_rows_big, d_smalls, lr_t)
        else:
            with jax.named_scope("device_tier_adagrad"):
                new_dev, new_opt["dev_acc"] = _device_tier_opt_apply(
                    emb_dev, opt_state["dev_acc"], dev_cfg, ids_dev_big,
                    d_rows_big, d_smalls, optimizer=optimizer, lr_t=lr_t)
    if plan.host_tables:
        if optimizer == "sgd":
            with jax.named_scope("host_tier_update"):
                new_host = host_tier_scatter_add(emb_host, ids_host,
                                                 -lr_t * d_host,
                                                 config.feature_size)
        else:
            with jax.named_scope("host_tier_adagrad"):
                new_host, new_opt["host_acc"] = _host_tier_opt_apply(
                    emb_host, opt_state["host_acc"],
                    ids_host.reshape(-1),
                    d_host.reshape(-1, d_host.shape[-1]
                                   ).astype(jnp.float32),
                    optimizer=optimizer, lr_t=lr_t, config=config)
    return ({"bottom": new_dense["bottom"], "top": new_dense["top"],
             "emb_dev": new_dev, "emb_host": new_host}, new_opt), loss


def tiered_train_block_opt(params, opt_state, dense, sparse, labels, *,
                           config: DLRMConfig, optimizer: str, lr,
                           plan: TierPlan, block: int = None):
    """Coalesced K-step two-tier block with Adagrad-family optimizers
    (see :func:`tiered_train_block` for the host-coalescing rationale —
    SGD blocks route there).

    Exactness contract (mirrors train_block_opt):
      * dense params and the DEVICE tier get a true per-micro-step
        dedup-then-apply Adagrad — carried, never stale;
      * host-tier rows for all K micro-batches are gathered ONCE at
        block entry (stale < K), the K compressed gradients are deduped
        ACROSS the whole block, and ONE accumulator-gather + two host
        scatters apply at block end — a repeated host row gets one
        accumulator update with its block-summed gradient (the same
        bounded-staleness relaxation as the device blocks);
      * with no host-row repeat across micro-batches the block equals K
        sequential :func:`tiered_train_step_opt` calls up to
        mul-reorder ulps (oracle-tested).

    ``lr`` must be a constant (scheduled tiered blocks are not built).
    """
    from dlrm_tpu.train import optim
    import optax

    if block is None:
        block = dense.shape[0]
    dense_params = {"bottom": params["bottom"], "top": params["top"]}
    emb_dev, emb_host = params["emb_dev"], params["emb_host"]
    count = opt_state["count"]
    tx = optim.dense_optimizer(optimizer, lr)

    host_rows_all = ids_host_all = None
    if plan.host_tables:
        ids_host_all = _tier_ids(sparse, list(plan.host_tables),
                                 plan.host_offsets, block_leading=True)
        with jax.named_scope("host_tier_block_gather"):
            host_rows_all = host_tier_gather(emb_host, ids_host_all,
                                             config.feature_size)

    dp = dense_params
    dense_state = opt_state["dense"]
    new_dev = emb_dev
    dev_cfg = device_subconfig(plan, config)
    dev_acc = opt_state.get("dev_acc", ())
    losses, d_rows_acc = [], []
    for k in range(block):
        (loss, dgrads, d_rows_big, d_smalls, d_host, ids_dev_big,
         _) = _tier_forward_backward(
            dp, new_dev, emb_host, dense[k], sparse[k], labels[k],
            config=config, plan=plan,
            host_rows=(host_rows_all[k] if plan.host_tables else None))
        with jax.named_scope("dense_update"):
            updates, dense_state = tx.update(dgrads, dense_state, dp)
            dp = jax.tree.map(lambda p, q: q.astype(p.dtype), dp,
                              optax.apply_updates(dp, updates))
        if plan.device_tables:
            with jax.named_scope("device_tier_adagrad"):
                new_dev, dev_acc = _device_tier_opt_apply(
                    new_dev, dev_acc, dev_cfg, ids_dev_big, d_rows_big,
                    d_smalls, optimizer=optimizer, lr_t=lr)
        if plan.host_tables:
            d_rows_acc.append(d_host)
        losses.append(loss)

    new_host = emb_host
    host_acc = opt_state.get("host_acc", ())
    if plan.host_tables:
        with jax.named_scope("host_tier_block_adagrad"):
            d_all = jnp.stack(d_rows_acc)  # (K, B, Th[, H], D)
            new_host, host_acc = _host_tier_opt_apply(
                emb_host, host_acc, ids_host_all.reshape(-1),
                d_all.reshape(-1, d_all.shape[-1]).astype(jnp.float32),
                optimizer=optimizer, lr_t=lr, config=config)
    new_opt = {"dense": dense_state, "count": count + block,
               "dev_acc": dev_acc, "host_acc": host_acc}
    return ({"bottom": dp["bottom"], "top": dp["top"],
             "emb_dev": new_dev, "emb_host": new_host}, new_opt), \
        jnp.stack(losses)


def make_tiered_train_block_opt(config: DLRMConfig, *, optimizer: str,
                                lr, plan: TierPlan, block: int = None,
                                device=None,
                                pin_host_output: Optional[bool] = None):
    """Jitted coalesced tiered optimizer block (see
    make_tiered_train_step_opt for the host-output pinning rationale)."""
    del block  # derived from the batch's leading dim at trace time
    assert optimizer in ("adagrad", "rowwise_adagrad"), \
        "SGD tiered blocks use make_tiered_train_block"
    assert not callable(lr), "scheduled tiered blocks are not built"
    ensure_backend_primed()
    device = device or jax.devices()[0]
    if pin_host_output is None:
        pin_host_output = can_pin_host_outputs(device)
    step = functools.partial(tiered_train_block_opt, config=config,
                             optimizer=optimizer, lr=lr, plan=plan)
    if not pin_host_output:
        return jax.jit(step)
    sh_host = jax.sharding.SingleDeviceSharding(device,
                                                memory_kind="pinned_host")
    opt_sh = {"dense": None, "count": None, "dev_acc": None,
              "host_acc": sh_host}
    out_shardings = (({"bottom": None, "top": None, "emb_dev": None,
                       "emb_host": sh_host}, opt_sh), None)
    return jax.jit(step, donate_argnums=(0, 1),
                   out_shardings=out_shardings)


def init_tiered_opt_state(params: dict, *, config: DLRMConfig,
                          optimizer: str, lr, plan: TierPlan,
                          device=None) -> dict:
    """Optimizer state with tier-matched Adagrad accumulator slabs."""
    from dlrm_tpu.train import optim

    device = device or jax.devices()[0]
    dense_params = {"bottom": params["bottom"], "top": params["top"]}
    tx = optim.dense_optimizer(optimizer, lr)
    state = {"dense": tx.init(dense_params),
             "count": jnp.zeros((), jnp.int32),
             "dev_acc": (), "host_acc": ()}
    if optimizer in ("adagrad", "rowwise_adagrad"):
        # device tier: the PRODUCTION engine accumulator layout (per-chunk
        # arrays under the device sub-config; rowwise = (chunk_rows, pack)
        # scalar-per-row).  host tier: flat pinned slab, 1-D across the
        # jit boundary like the tables (module docstring); rowwise = one
        # f32 scalar per row (1/D the slow-tier optimizer bytes).
        dev_cfg = device_subconfig(plan, config)
        if dev_cfg is not None:
            state["dev_acc"] = tuple(
                jax.device_put(a, device)
                for a in optim.init_emb_state(
                    dev_cfg, optimizer, params["emb_dev"]).acc)
        host_rows = params["emb_host"].size // config.feature_size
        host_shape = ((host_rows * config.feature_size,)
                      if optimizer == "adagrad"
                      else (host_rows,))
        state["host_acc"] = jax.device_put(
            jnp.zeros(host_shape, jnp.float32), _host_sharding(device))
    return state


def make_tiered_train_step_opt(config: DLRMConfig, *, optimizer: str, lr,
                               plan: TierPlan, device=None,
                               pin_host_output: Optional[bool] = None):
    """Jitted two-tier pluggable-optimizer step (see make_tiered_train_step
    for the host-output pinning rationale)."""
    ensure_backend_primed()
    device = device or jax.devices()[0]
    if pin_host_output is None:
        pin_host_output = can_pin_host_outputs(device)
    step = functools.partial(tiered_train_step_opt, config=config,
                             optimizer=optimizer, lr=lr, plan=plan)
    if not pin_host_output:
        return jax.jit(step)
    sh_host = jax.sharding.SingleDeviceSharding(device,
                                                memory_kind="pinned_host")
    opt_sh = {"dense": None, "count": None, "dev_acc": None,
              "host_acc": (sh_host if optimizer in
                           ("adagrad", "rowwise_adagrad") else None)}
    out_shardings = (({"bottom": None, "top": None, "emb_dev": None,
                       "emb_host": sh_host}, opt_sh), None)
    return jax.jit(step, donate_argnums=(0, 1),
                   out_shardings=out_shardings)


def make_tiered_train_step(config: DLRMConfig, lr: float, plan: TierPlan,
                           device=None, pin_host_output: Optional[bool] = None):
    """Jitted two-tier step.  Where the backend can place jit outputs in
    pinned_host (utils/backend.can_pin_host_outputs), the host-tier stack
    stays pinned in host memory across steps (donated in, pinned out).
    The CPU backend cannot (no annotate_device_placement custom call), so
    there the updated host stack round-trips through default memory —
    same numerics, used only by tests."""
    ensure_backend_primed()
    device = device or jax.devices()[0]
    if pin_host_output is None:
        pin_host_output = can_pin_host_outputs(device)
    step = functools.partial(tiered_train_step, config=config, lr=lr,
                             plan=plan)
    if not pin_host_output:
        # Without output pinning, donation would try to reuse the pinned
        # input buffer for a device-memory output (hard abort on CPU).
        return jax.jit(step)
    sh_host = jax.sharding.SingleDeviceSharding(device,
                                                memory_kind="pinned_host")
    out_shardings = ({"bottom": None, "top": None, "emb_dev": None,
                      "emb_host": sh_host}, None)
    return jax.jit(step, donate_argnums=(0,), out_shardings=out_shardings)


def init_tiered_params(params: dict, plan: TierPlan, config: DLRMConfig,
                       device=None) -> dict:
    """{bottom, emb, top} -> {bottom, top, emb_dev, emb_host} placed."""
    emb_dev, emb_host = split_tiers(params["emb"], plan, config,
                                    device)
    return {"bottom": jax.device_put(params["bottom"], device),
            "top": jax.device_put(params["top"], device),
            "emb_dev": emb_dev, "emb_host": emb_host}


def _host_sharding(device):
    """The host tier's placement: ``pinned_host`` memory on ``device``.
    A backend without that memory space has no host tier at all."""
    if not host_memory_supported(device):
        raise ValueError(
            f"device {device} exposes no pinned_host memory space; the "
            "host tier needs one")
    return jax.sharding.SingleDeviceSharding(device,
                                             memory_kind="pinned_host")


def place_tiered(restored: dict, device=None, plan: TierPlan = None,
                 config: DLRMConfig = None) -> dict:
    """Checkpoint-restored (host numpy) tiered params -> placed: device
    tier (engine chunks) + MLPs in HBM, host tier back in pinned_host.
    The checkpoint itself is memory-space-agnostic (orbax fetches to
    host on save).  Legacy round-4 layouts convert on restore: a 2-D
    (R_dev, D) device stack packs into engine chunks (needs ``plan`` +
    ``config``), an (N, D) host stack flattens to the 1-D carry."""
    from dlrm_tpu.ops import embedding as emb_ops

    device = device or jax.devices()[0]
    dev = restored["emb_dev"]
    if isinstance(dev, (tuple, list)):
        dev = tuple(jax.device_put(np.asarray(c), device) for c in dev)
    else:
        dev = np.asarray(dev)
        if dev.ndim == 2 and plan is not None and config is not None:
            dev_cfg = device_subconfig(plan, config)
            dev = (tuple(jax.device_put(c, device)
                         for c in emb_ops.pack_tables(dev, dev_cfg))
                   if dev_cfg is not None else ())
        else:
            dev = jax.device_put(dev, device)
    return {
        "bottom": jax.device_put(restored["bottom"], device),
        "top": jax.device_put(restored["top"], device),
        "emb_dev": dev,
        "emb_host": jax.device_put(
            np.asarray(restored["emb_host"]).reshape(-1),
            _host_sharding(device)),
    }


def place_tiered_opt(restored: dict, device=None) -> dict:
    """Placed tiered optimizer state: the host-tier Adagrad accumulator
    slab returns to pinned_host (flattened to the 1-D carry), everything
    else to device memory."""
    device = device or jax.devices()[0]
    out = {k: jax.device_put(v, device) for k, v in restored.items()
           if k != "host_acc"}
    ha = restored.get("host_acc", ())
    out["host_acc"] = (jax.device_put(np.asarray(ha).reshape(-1),
                                      _host_sharding(device))
                       if not isinstance(ha, tuple) else ha)
    return out
