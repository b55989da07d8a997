"""Dot-product feature interaction (pure-jnp implementation).

The DLRM interaction (/root/reference/src/model/interact.jl): stack the
bottom-MLP output with the pooled embedding vectors into T = (B, F, d) where
``F = num_tables*feature_size/bottom_out + 1``, compute the Gram matrix
Z = T Tᵀ (B, F, F), take the strictly-lower-triangular entries (row-major
(i, j) order with i > j — equal to the reference's column-major upper
triangle, interact.jl:26-31/64-75), and concatenate them after the bottom-MLP
output, optionally zero-padding the tail to a width multiple
(``POST_INTERACTION_PAD_TO_MUL``, model.jl:32 / interact.jl:351-355).

This is the oracle implementation (the analog of the reference's
``dot_interaction_reference``, interact.jl:7-31); the fused GPU kernel in
``interaction_triton.py`` is tested against it forward and backward.

The Gram matrix is a batched matmul; the triangular extraction is a static
gather over the flattened (F*F) axis (the indices are compile-time
constants).  Both materialize (B, F, F) tensors in device memory, which
is what the fused kernel avoids.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def tril_flat_indices(f: int) -> np.ndarray:
    """Flattened indices of the strictly-lower triangle of an (f, f) matrix,
    ordered (1,0), (2,0), (2,1), (3,0), ... — the DLRM pair order."""
    li, lj = np.tril_indices(f, k=-1)
    return (li * f + lj).astype(np.int32)


def stack_features(x: jax.Array, feats: jax.Array) -> jax.Array:
    """Build the interaction input T = (B, F, d).

    ``x``: bottom-MLP output (B, d) with d = bottom_out.
    ``feats``: pooled embeddings (B, T, fs).  When fs != d the embedding block
    is re-chunked into d-wide features (the reference's size math,
    model.jl:220-221, guarantees T*fs % d == 0).
    """
    b, d = x.shape
    emb = feats.reshape(b, -1, d)
    return jnp.concatenate([x[:, None, :], emb], axis=1)


def _pad_width(out: jax.Array, pad_to: int) -> jax.Array:
    width = out.shape[1]
    padded = pad_to * ((width + pad_to - 1) // pad_to)
    if padded != width:
        out = jnp.pad(out, ((0, 0), (0, padded - width)))
    return out


def dot_interaction(x: jax.Array, feats: jax.Array, pad_to: int = 1
                    ) -> jax.Array:
    """Interaction output (B, bottom_out + F(F-1)/2 + padding).

    Gram-matrix formulation (batched matmul + static triangular gather).
    """
    t = stack_features(x, feats)
    b, f, _ = t.shape
    z = jnp.einsum(
        "bfd,bgd->bfg", t, t, preferred_element_type=jnp.float32
    ).astype(t.dtype)
    zflat = z.reshape(b, f * f)[:, tril_flat_indices(f)]
    return _pad_width(jnp.concatenate([x, zflat], axis=1), pad_to)


def dot_interaction_pairwise(x: jax.Array, feats: jax.Array, pad_to: int = 1
                             ) -> jax.Array:
    """Elementwise formulation: compute only the P needed pair dot
    products as elementwise multiply + reduce over D (no F x F Gram
    matrix).

    zflat[b, p] = sum_d T[b, i_p, d] * T[b, j_p, d].  Trades the Gram
    batched matmul for elementwise work that XLA fuses.
    """
    t = stack_features(x, feats)
    b, f, _ = t.shape
    li, lj = np.tril_indices(f, k=-1)
    prod = (t[:, li, :].astype(jnp.float32)
            * t[:, lj, :].astype(jnp.float32))
    zflat = jnp.sum(prod, axis=-1).astype(t.dtype)
    return _pad_width(jnp.concatenate([x, zflat], axis=1), pad_to)
