"""MLP forward (XLA-fused dense stack).

The reference routes all dense math through Intel oneDNN C++ primitives
(OneDNN.Dense, /root/reference/src/model/model.jl:85) with opaque blocked
layouts.  Here the equivalent is simply ``x @ w + b`` under jit: XLA hands
the matmul to cuBLAS or its own generated kernel and fuses the bias add +
activation into the epilogue — there is no user-visible layout concept to
manage.

Weights are stored (in, out) so the forward is row-major ``x @ w``.
Activation scheme mirrors create_mlp (model.jl:72-93): the bottom MLP is ReLU
on every layer; the top MLP is ReLU on all but the last, which is linear
followed by sigmoid.
"""

from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp


def init_mlp(key: jax.Array, sizes: Sequence[int], dtype=jnp.float32
             ) -> List[dict]:
    """Glorot-normal weights (std = sqrt(2 / (fan_in + fan_out)), the
    reference's GlorotNormal, model.jl:58-59), zero biases."""
    layers = []
    for i in range(len(sizes) - 1):
        key, sub = jax.random.split(key)
        fan_in, fan_out = sizes[i], sizes[i + 1]
        std = jnp.sqrt(2.0 / (fan_in + fan_out))
        w = (jax.random.normal(sub, (fan_in, fan_out), jnp.float32) * std)
        layers.append({
            "w": w.astype(dtype),
            "b": jnp.zeros((fan_out,), dtype),
        })
    return layers


def mlp_apply(layers, x: jax.Array, *, final: str,
              compute_dtype=None) -> jax.Array:
    """Apply a dense stack.  ``final`` is the last layer's activation:
    'relu' (bottom MLP) or 'sigmoid' (top MLP, linear + sigmoid)."""
    n = len(layers)
    if compute_dtype is not None:
        x = x.astype(compute_dtype)
    for i, layer in enumerate(layers):
        w, b = layer["w"], layer["b"]
        if compute_dtype is not None:
            w = w.astype(compute_dtype)
            b = b.astype(compute_dtype)
        x = jnp.dot(x, w, preferred_element_type=jnp.float32)
        x = (x + b.astype(jnp.float32))
        last = i == n - 1
        if not last or final == "relu":
            x = jax.nn.relu(x)
        else:
            x = jax.nn.sigmoid(x)
        if compute_dtype is not None and not last:
            x = x.astype(compute_dtype)
    return x
