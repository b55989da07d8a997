"""Phase telemetry: the reference's callback system reborn for XLA.

The reference wraps every forward stage in ``callback(cb, :sym, f, x...)``
with a Zygote adjoint that fires ``:sym_back`` on the reverse pass
(/root/reference/src/model/model.jl:130-166), and the training loop emits
:start/:grads_done/:weight_update_done/:embedding_update_done
(train/train.jl:216-292).  Under jit that decomposition doesn't exist at
runtime — XLA fuses the whole step — so this module provides BOTH:

1. **Profiler scopes** (production path): every stage in models/dlrm.py is
   wrapped in ``jax.named_scope``; ``trace()`` captures a profiler trace
   where the per-phase timing shows up at zero steady-state cost.
2. **InstrumentedTrainer** (diagnostic path): one train step executed as
   separately-jitted stages chained by hand-held VJPs, each synchronized and
   timed, firing the reference's exact symbols (:lookup, :bottom_mlp,
   :interaction, :top_mlp, :loss, then :loss_back ... :lookup_back,
   :weight_update_done, :embedding_update_done).  Slower per step (sync per
   phase) but gives the step-time breakdown BASELINE.md asks for.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Dict, List

import jax
import jax.numpy as jnp

from dlrm_tpu.config import DLRMConfig


def donothing(sym: str) -> None:  # reference default cb (utils.jl:27)
    del sym


class Recorder:
    """Timestamps every phase symbol; summarizes ns per phase.

    Attach only AFTER one warm-up step of the trainer: each phase's
    first execution includes its jit trace+compile (hundreds of ms), so
    recording from a cold trainer folds compile time into the phase
    means.  ``cmd_instrument`` passes a no-op callback for step 0 for
    exactly this reason."""

    def __init__(self):
        self.events: List[tuple] = []

    def __call__(self, sym: str) -> None:
        self.events.append((sym, time.perf_counter_ns()))

    def phase_durations(self) -> Dict[str, List[int]]:
        """ns between consecutive events, attributed to the later symbol."""
        out: Dict[str, List[int]] = collections.defaultdict(list)
        for (prev_sym, t0), (sym, t1) in zip(self.events, self.events[1:]):
            if sym != "start":
                out[sym].append(t1 - t0)
        return dict(out)

    def summary(self) -> Dict[str, float]:
        return {sym: sum(v) / len(v) / 1e6  # mean ms
                for sym, v in self.phase_durations().items()}


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace capturing the named_scope phase breakdown."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class InstrumentedTrainer:
    """Stage-by-stage train step with per-phase host timing.

    Each phase is its own jitted program synchronized before the callback
    fires — the morally-exact port of the reference's telemetry protocol.
    Numerics match train.train_step for f32 configs with gather-path
    tables; two DOCUMENTED deviations keep the phases clean: (1) the
    :lookup/:embedding_update phases use the plain full-gather/scatter
    strategy for ALL tables (the production step routes tables under
    ``small_table_threshold`` through the dense-gradient small-table path
    instead), and (2) under ``compute_dtype=bfloat16`` the full-gather
    lookup skips the small-table path's cast, so bf16 runs are
    phase-representative, not bit-identical.  For exact production numbers use train.train_step;
    for zero-cost production profiling use the named_scope trace().

    Timing caveat: each phase is its own jitted program timed by ONE
    ``block_until_ready`` + ``perf_counter``, so phases cannot overlap
    or fuse as they do inside the one-program step: treat phase ms as
    upper bounds (bench.py's step windows are the throughput ground
    truth).
    """

    def __init__(self, config: DLRMConfig, lr: float):
        from dlrm_tpu.models.dlrm import forward_from_pooled  # noqa: F401
        from dlrm_tpu.ops import embedding as emb_ops
        from dlrm_tpu.ops.interaction import dot_interaction
        from dlrm_tpu.ops.loss import bce_loss
        from dlrm_tpu.ops.mlp import mlp_apply

        self.config = config
        self.lr = lr

        # Stage forwards and stage VJPs are separate jitted programs (jit
        # cannot return a closure); each _back stage rematerializes its
        # forward inside the VJP.  This path is for diagnostics;
        # production steps use the single fused jit in train/train.py.
        # The config's interaction impl and compute dtype are honored;
        # see the class docstring for the two documented deviations from
        # train_step (full-gather lookup for all tables).
        cd = config.compute_dtype
        cd = None if cd == config.weight_dtype else cd

        def bottom_f(bp, dense):
            return mlp_apply(bp, dense, final="relu", compute_dtype=cd)

        def inter_f(x, y):
            if config.interaction_impl == "fused":
                from dlrm_tpu.ops.interaction_triton import \
                    fused_dot_interaction
                return fused_dot_interaction(x, y.astype(x.dtype),
                                             config.interaction_pad_to)
            if config.interaction_impl == "pairwise":
                from dlrm_tpu.ops.interaction import dot_interaction_pairwise
                return dot_interaction_pairwise(x, y.astype(x.dtype),
                                                config.interaction_pad_to)
            return dot_interaction(x, y.astype(x.dtype),
                                   config.interaction_pad_to)

        def top_f(tp, z):
            return mlp_apply(tp, z, final="sigmoid",
                             compute_dtype=cd)[:, 0]

        self._lookup = jax.jit(
            lambda emb, ids: emb_ops.pool(
                emb_ops.gather_tables(emb, ids, config)))
        self._bottom = jax.jit(bottom_f)
        self._bottom_bwd = jax.jit(
            lambda bp, dense, ct: jax.vjp(
                lambda b: bottom_f(b, dense), bp)[1](ct)[0])
        self._interaction = jax.jit(inter_f)
        self._interaction_bwd = jax.jit(
            lambda x, y, ct: jax.vjp(inter_f, x, y)[1](ct))
        self._top = jax.jit(top_f)
        self._top_bwd = jax.jit(
            lambda tp, z, ct: jax.vjp(top_f, tp, z)[1](ct))
        self._loss = jax.jit(bce_loss)
        self._loss_bwd = jax.jit(
            lambda out, labels: jax.grad(bce_loss)(out, labels))
        self._sgd = jax.jit(
            lambda p, g, lr: jax.tree.map(
                lambda a, b: (a - lr * b).astype(a.dtype), p, g))
        self._emb_sgd = jax.jit(
            lambda emb, ids, d_pooled, lr: self._apply_emb(
                emb, ids, d_pooled, lr))

    def _apply_emb(self, emb, ids, d_pooled, lr):
        from dlrm_tpu.ops import embedding as emb_ops
        config = self.config
        if ids.ndim == 3:  # multi-hot: pooled grad broadcasts to each hit
            d_rows = jnp.broadcast_to(
                d_pooled[:, :, None, :], ids.shape + (d_pooled.shape[-1],))
        else:
            d_rows = d_pooled
        if config.is_packed:
            return emb_ops.apply_sgd_chunked(emb, ids, d_rows, lr, config)
        flat = emb_ops.translate_ids(ids, config.table_offsets)
        grad = emb_ops.SparseGrad(
            ids=flat.reshape(-1),
            rows=d_rows.reshape(-1, d_rows.shape[-1]))
        return emb_ops.apply_sparse_sgd(emb, grad, lr)

    def step(self, params: dict, batch: dict,
             cb: Callable[[str], None] = donothing):
        """One instrumented step; fires the reference's phase symbols."""
        sync = jax.block_until_ready
        dense = jnp.asarray(batch["dense"])
        sparse = jnp.asarray(batch["sparse"])
        labels = jnp.asarray(batch["labels"])
        lr = jnp.float32(self.lr)
        cb("start")

        pooled = sync(self._lookup(params["emb"], sparse)); cb("lookup")
        x = sync(self._bottom(params["bottom"], dense)); cb("bottom_mlp")
        z = sync(self._interaction(x, pooled)); cb("interaction")
        out = sync(self._top(params["top"], z)); cb("top_mlp")
        loss = sync(self._loss(out, labels)); cb("loss")

        dout = sync(self._loss_bwd(out, labels)); cb("loss_back")
        dtop, dz = self._top_bwd(params["top"], z, dout)
        sync(dz); cb("top_mlp_back")
        dx, d_pooled = self._interaction_bwd(x, pooled, dz)
        sync(d_pooled); cb("interaction_back")
        dbot = sync(self._bottom_bwd(params["bottom"], dense, dx))
        cb("bottom_mlp_back")
        cb("lookup_back")  # compressed grad == d_pooled; nothing to compute
        cb("grads_done")

        new_bottom = sync(self._sgd(params["bottom"], dbot, lr))
        new_top = sync(self._sgd(params["top"], dtop, lr))
        cb("weight_update_done")
        new_emb = sync(self._emb_sgd(params["emb"], sparse, d_pooled, lr))
        cb("embedding_update_done")
        cb("update_done")
        return ({"bottom": new_bottom, "emb": new_emb, "top": new_top},
                float(loss))
