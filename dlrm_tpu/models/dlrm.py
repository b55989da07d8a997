"""The DLRM model: parameter pytree, initialization, forward pass.

Mirrors the reference's model container and forward
(/root/reference/src/model/model.jl:116-166):

    dense (B,13) ──► bottom MLP ──┐
                                  ├─► dot interaction ─► top MLP ─► sigmoid
    sparse ids (B,T[,H]) ─ lookup ┘

Parameters are a plain pytree::

    {"bottom": [{"w","b"}...], "emb": (total_rows, D), "top": [{"w","b"}...]}

with all embedding tables stacked into one array (see ops/embedding.py) so a
whole batch is one fused gather.  Stage boundaries are wrapped in
``jax.named_scope`` — the JAX analog of the reference's zero-cost
callback telemetry (model.jl:130-166): scopes show up in ``jax.profiler``
traces for per-phase timing without perturbing compilation.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from dlrm_tpu.config import DLRMConfig
from dlrm_tpu.ops import embedding as emb_ops
from dlrm_tpu.ops.interaction import dot_interaction
from dlrm_tpu.ops.mlp import init_mlp, mlp_apply


def init_params(key: jax.Array, config: DLRMConfig,
                emb_init: str = "scaled_uniform") -> dict:
    """Initialize the full parameter pytree.

    MLP weights: Glorot normal, zero bias (model.jl:58-59).
    Embeddings: U(-1/sqrt(rows), 1/sqrt(rows)) per table — the reference's
    ScaledUniform (model.jl:61-65), same as the PyTorch DLRM reference.
    """
    kb, kt, ke = jax.random.split(key, 3)
    bottom = init_mlp(kb, config.bottom_mlp_sizes, config.weight_dtype)
    top = init_mlp(kt, config.full_top_mlp_sizes, config.weight_dtype)
    if emb_init == "scaled_uniform":
        # One fused device op for the whole stacked table: uniform(-1, 1)
        # scaled per-row by 1/sqrt(table_rows).  Equivalent in distribution
        # to per-table U(-1/sqrt(rows), 1/sqrt(rows)) but avoids 26 separate
        # inits + a multi-GB concatenate.  Initialized directly in storage
        # layout (lane-packed when config.is_packed): tables own whole
        # physical rows, so the per-row scale is constant per physical row.
        import numpy as np
        inv_sqrt = 1.0 / np.sqrt(np.asarray(config.table_sizes, np.float32))

        def _chunk_scale(c):
            """Per-physical-row scale for chunk c (tables own whole rows)."""
            reps, vals = [], []
            for t in range(config.num_tables):
                if config.table_chunk[t] == c:
                    reps.append(config.packed_table_rows[t])
                    vals.append(inv_sqrt[t])
            return np.repeat(np.asarray(vals, np.float32), reps)

        import functools

        @functools.partial(jax.jit, static_argnames=("shape",))
        def _init_one(key, scale, shape):
            # generate directly in the storage dtype for sub-f32 tables:
            # a full-chunk f32 temporary would double the deepest Kaggle
            # fs=128 chunk's footprint (5.2 GB transient next to 8.6 GB
            # of bf16 tables) during init
            dt = jnp.dtype(config.embedding_dtype)
            if dt.itemsize < 4:
                u = jax.random.uniform(key, shape, dt,
                                       minval=-1.0, maxval=1.0)
                return u * scale[:, None].astype(dt)
            u = jax.random.uniform(key, shape, jnp.float32,
                                   minval=-1.0, maxval=1.0)
            return (u * scale[:, None]).astype(config.embedding_dtype)

        if config.is_packed:
            keys = jax.random.split(ke, config.num_chunks)
            emb = tuple(
                _init_one(keys[c], jnp.asarray(_chunk_scale(c)),
                          config.emb_shapes[c])
                for c in range(config.num_chunks))
        else:
            row_scale = np.repeat(inv_sqrt,
                                  config.table_sizes).astype(np.float32)
            emb = _init_one(ke, jnp.asarray(row_scale),
                            (config.total_rows, config.feature_size))
    elif emb_init == "zeros":
        if config.is_packed:
            emb = tuple(jnp.zeros(s, config.embedding_dtype)
                        for s in config.emb_shapes)
        else:
            emb = jnp.zeros((config.total_rows, config.feature_size),
                            config.embedding_dtype)
    else:
        raise ValueError(emb_init)
    return {"bottom": bottom, "emb": emb, "top": top}


def forward_from_pooled(dense_params: dict, pooled: jax.Array,
                        dense: jax.Array, config: DLRMConfig) -> jax.Array:
    """Forward pass given already-pooled embedding vectors (B, T, D).

    This split (lookup outside, rest inside) is what lets training compute
    compressed sparse embedding gradients — see
    ops/embedding.sparse_value_and_grad.
    """
    cd = config.compute_dtype
    cd = None if cd == dense_params["bottom"][0]["w"].dtype else cd
    with jax.named_scope("bottom_mlp"):
        x = mlp_apply(dense_params["bottom"], dense, final="relu",
                      compute_dtype=cd)
    with jax.named_scope("interaction"):
        if config.interaction_impl == "fused":
            from dlrm_tpu.ops.interaction_triton import fused_dot_interaction
            z = fused_dot_interaction(x, pooled.astype(x.dtype),
                                      pad_to=config.interaction_pad_to)
        elif config.interaction_impl == "pairwise":
            from dlrm_tpu.ops.interaction import dot_interaction_pairwise
            z = dot_interaction_pairwise(x, pooled.astype(x.dtype),
                                         pad_to=config.interaction_pad_to)
        else:
            z = dot_interaction(x, pooled.astype(x.dtype),
                                pad_to=config.interaction_pad_to)
    with jax.named_scope("top_mlp"):
        out = mlp_apply(dense_params["top"], z, final="sigmoid",
                        compute_dtype=cd)
    return out[:, 0]


def loss_from_pooled(dense_params: dict, pooled: jax.Array,
                     dense: jax.Array, labels: jax.Array,
                     config: DLRMConfig) -> jax.Array:
    """BCE loss of the dense tower given pooled embeddings — the ONE
    loss closure every training path (single-chip, sharded, blocks,
    two-tier) must use, so ``config.remat`` covers them all.

    remat: jax.checkpoint around the dense tower recomputes the
    interaction + MLP activations (the largest per-batch buffers) on
    backward instead of storing them — the standard FLOPs-for-HBM trade
    for big batches / feature sizes.  Semantically the identity (grad
    parity tested)."""
    from dlrm_tpu.ops.loss import bce_loss

    if config.remat:
        def fwd(dp, p, d):
            return forward_from_pooled(dp, p, d, config)

        out = jax.checkpoint(fwd)(dense_params, pooled, dense)
    else:
        out = forward_from_pooled(dense_params, pooled, dense, config)
    return bce_loss(out, labels)


def forward(params: dict, dense: jax.Array, sparse: jax.Array,
            config: DLRMConfig) -> jax.Array:
    """Full forward: (dense (B,13), sparse ids (B,T[,H])) -> CTR (B,).

    Equivalent to the reference's ``(D::DLRMModel)(dense, sparse)``
    (model.jl:152-166).
    """
    emb_ops.check_storage(params["emb"], config)
    with jax.named_scope("lookup"):
        pooled = emb_ops.mixed_lookup(params["emb"], sparse, config)
    dense_params = {"bottom": params["bottom"], "top": params["top"]}
    return forward_from_pooled(dense_params, pooled, dense, config)


def split_params(params: dict):
    """(dense_params, emb) — the two halves train steps treat differently."""
    return {"bottom": params["bottom"], "top": params["top"]}, params["emb"]


def merge_params(dense_params: dict, emb: jax.Array) -> dict:
    return {"bottom": dense_params["bottom"], "emb": emb,
            "top": dense_params["top"]}


def get_table(params_or_emb, config: DLRMConfig, i: int) -> jax.Array:
    """Table ``i`` as a logical (rows, D) array, from either storage layout
    (plain stacked or lane-packed)."""
    emb = params_or_emb["emb"] if isinstance(params_or_emb, dict) \
        else params_or_emb
    return emb_ops.get_logical_table(emb, config, i)
