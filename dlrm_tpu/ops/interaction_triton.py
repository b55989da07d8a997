"""Fused dot interaction for the GPU, written for Pallas's Triton route.

What it saves: the gram formulation (ops/interaction.dot_interaction)
materializes the stacked features T = (B, F, D), the (B, F, F) gram and,
on backward, a (B, F, F) cotangent, each a round trip through device
memory.  Here one program handles one example: it loads the example's F
feature rows (the bottom-MLP output and the pooled embeddings, read where
they lie, never stacked), forms the F x F gram on the tensor cores, and
stores only the strictly-lower triangle into the output row.  The backward
program reads the triangle of the output cotangent back into an F x F tile,
symmetrizes it and multiplies by the same rows.  So the kernel moves what
the algorithm needs and nothing else: T in, the (B, D + F(F-1)/2) output
out, and on backward T and the cotangent in, dT out.

Layout on the card: F is padded to ``F_PAD`` = the next power of two (at
least 16, the smallest tile a Triton dot takes); padded rows load as zeros
and are masked out of every store.  D must be a power of two and at least
16.  Arithmetic follows ``jax.default_matmul_precision`` like any other
product: TF32 by default on Hopper, IEEE float32 under "highest".

There is no interpret fallback: off the GPU, pass ``interpret=True``
explicitly (the tests do) or the Triton lowering refuses.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from dlrm_tpu.ops.interaction import _pad_width

NUM_WARPS = 4


def _f_pad(f: int) -> int:
    return max(16, int(pl.next_power_of_2(f)))


def supported(num_features: int, d: int) -> bool:
    """True when the kernel takes F = ``num_features`` rows of width ``d``
    (power-of-two ``d`` >= 16, F <= 64 so a tile stays in registers)."""
    return d >= 16 and d & (d - 1) == 0 and 2 <= num_features <= 64


def _row_index(rows, valid, n_rows: int, d: int):
    """Broadcast (rows, cols) index arrays addressing whole rows of an
    (n_rows, d) ref.  Rows that are not ``valid`` get the out-of-bounds
    row ``n_rows``: the caller masks them, the card then never touches
    them, and interpret mode drops a store there (a clamped index would
    instead rewrite a real row)."""
    return (jnp.where(valid, rows, n_rows)[:, None],
            jnp.arange(d)[None, :])


def _rows(x_ref, feats_ref, f_pad: int):
    """(f_pad, D) tile of T's rows: row 0 the bottom-MLP output, rows
    1..T the pooled embeddings, zeros below."""
    t = feats_ref.shape[0]
    d = x_ref.shape[0]
    r = jnp.arange(f_pad)
    m = (r >= 1) & (r <= t)
    rows, cols = _row_index(r - 1, m, t, d)
    emb = plgpu.load(feats_ref.at[rows, cols],
                     mask=jnp.broadcast_to(m[:, None], (f_pad, d)),
                     other=0.0)
    x = x_ref[...]
    return jnp.where((r == 0)[:, None], x[None, :], emb).astype(jnp.float32)


def _tril_offsets(d: int, f: int, f_pad: int):
    """Position in the output row of pair (i, j), i > j, in DLRM order
    (1,0), (2,0), (2,1), ... after the D leading entries, and the mask of
    the pairs that exist; the others point one past the row (see
    :func:`_row_index`)."""
    i = jnp.arange(f_pad)[:, None]
    j = jnp.arange(f_pad)[None, :]
    m = (j < i) & (i < f)
    return jnp.where(m, d + i * (i - 1) // 2 + j, d + f * (f - 1) // 2), m


def _fwd_kernel(x_ref, feats_ref, out_ref, *, f_pad):
    d = x_ref.shape[0]
    f = feats_ref.shape[0] + 1
    t = _rows(x_ref, feats_ref, f_pad)
    z = pl.dot(t, t, trans_b=True)  # (f_pad, f_pad)
    off, m = _tril_offsets(d, f, f_pad)
    out_ref[pl.ds(0, d)] = x_ref[...]
    plgpu.store(out_ref.at[off], z.astype(out_ref.dtype), mask=m)


def _bwd_kernel(x_ref, feats_ref, g_ref, dx_ref, dfeats_ref, *, f_pad):
    d = x_ref.shape[0]
    n_t = feats_ref.shape[0]
    f = n_t + 1
    t = _rows(x_ref, feats_ref, f_pad)
    off, m = _tril_offsets(d, f, f_pad)
    low = plgpu.load(g_ref.at[off], mask=m, other=0.0).astype(
        jnp.float32)
    sym = low + low.T
    dt = pl.dot(sym, t)  # (f_pad, D)
    r = jnp.arange(f_pad)
    dx = g_ref[pl.ds(0, d)].astype(jnp.float32) + jnp.sum(
        jnp.where((r == 0)[:, None], dt, 0.0), axis=0)
    dx_ref[...] = dx.astype(dx_ref.dtype)
    rm = (r >= 1) & (r <= n_t)
    plgpu.store(dfeats_ref.at[_row_index(r - 1, rm, n_t, d)],
                dt.astype(dfeats_ref.dtype),
                mask=jnp.broadcast_to(rm[:, None], (f_pad, d)))


def _call(kernel, out_shape, name, interpret):
    return pl.pallas_call(
        kernel, out_shape=out_shape, grid=(), interpret=interpret,
        name=name, backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS))


def _forward(x, feats, interpret):
    b, d = x.shape
    f = feats.shape[1] + 1
    width = d + f * (f - 1) // 2
    kernel = functools.partial(_fwd_kernel, f_pad=_f_pad(f))
    call = _call(kernel, jax.ShapeDtypeStruct((width,), x.dtype),
                 "dot_interaction_fwd", interpret)
    return jax.vmap(call)(x, feats)


def _backward(x, feats, g, interpret):
    f = feats.shape[1] + 1
    kernel = functools.partial(_bwd_kernel, f_pad=_f_pad(f))
    call = _call(kernel,
                 (jax.ShapeDtypeStruct(x.shape[1:], x.dtype),
                  jax.ShapeDtypeStruct(feats.shape[1:], feats.dtype)),
                 "dot_interaction_bwd", interpret)
    return jax.vmap(call)(x, feats, g)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _fused(x, feats, interpret):
    return _forward(x, feats, interpret)


def _fused_fwd(x, feats, interpret):
    return _forward(x, feats, interpret), (x, feats)


def _fused_bwd(interpret, res, g):
    x, feats = res
    return _backward(x, feats, g, interpret)


_fused.defvjp(_fused_fwd, _fused_bwd)


def fused_dot_interaction(x: jax.Array, feats: jax.Array, pad_to: int = 1,
                          *, interpret: bool = False) -> jax.Array:
    """Drop-in for :func:`dlrm_tpu.ops.interaction.dot_interaction`: ``x``
    (B, D) bottom-MLP output, ``feats`` (B, T, D) pooled embeddings (the
    feature width must equal D; the config's re-chunking of other widths
    is done by the caller).  Differentiable in both arguments."""
    b, d = x.shape
    feats = feats.reshape(b, -1, d)
    if not supported(feats.shape[1] + 1, d):
        raise ValueError(
            f"fused interaction needs a power-of-two D >= 16 and at most "
            f"64 features; got D={d}, F={feats.shape[1] + 1}")
    return _pad_width(_fused(x, feats, interpret), pad_to)


def min_bytes(batch: int, num_features: int, d: int,
              itemsize: int = 4) -> dict:
    """The least device-memory traffic any fused kernel can move for one
    forward and one backward at these shapes: forward reads T and writes
    the output; backward reads T and the output cotangent and writes dT."""
    t_bytes = batch * num_features * d * itemsize
    out_bytes = batch * (d + num_features * (num_features - 1) // 2) \
        * itemsize
    return {"forward": t_bytes + out_bytes,
            "backward": 2 * t_bytes + out_bytes,
            "total": 3 * t_bytes + 2 * out_bytes}


