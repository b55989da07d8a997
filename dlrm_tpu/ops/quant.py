"""int8 post-training quantization of embedding tables (serving path).

The reference has no quantized-inference story (its tables are f32; the
BF16-embeddings experiment halves them, /root/reference: README.md:19 and
the `experiments` wrappers).  The Kaggle fs=128 stack is 17.3 GB in f32
and 8.6 GB in bf16; symmetric per-row int8 brings it to ~4.4 GB (+
scales), quartering gather-side memory traffic versus f32, and the
Terabyte-vocabulary stack (~451 GB f32) to ~113 GB.

Scheme: symmetric per-LOGICAL-row scales, ``scale = max|row| * (1/127)``
(multiplication by the pre-rounded f32 reciprocal, NOT division: XLA's
algebraic simplifier rewrites division by a literal inside a fused
program, so only the multiplication form is bit-stable between the
jitted device quantizer and its numpy host twin — a tested contract),
``q = round(row / scale)`` clipped to [-127, 127].  Per-logical-row (not
per-physical-row) matters under lane packing: one physical row holds
``config.pack`` unrelated logical rows whose magnitudes differ by their
1/sqrt(table_rows) init scale.  Worst-case elementwise error is
``max|row| / 254`` (~0.4% relative), which leaves CTR scores within ~1e-3
of the f32 model (tested; tighten with QAT if a deployment ever needs it).

``QuantEmb`` is a pytree mirroring the engine storage: one int8
``(rows, row_width)`` array per chunk plus one ``(rows, pack)`` scale
array.  ``ops.embedding.mixed_lookup``/``check_storage`` dispatch on it,
so ``models.dlrm.forward`` — and therefore ``evaluate``/``predict`` —
serve a quantized model with no other code aware of it.  Training never
sees this type (quantization is post-training, applied at load time by
``run.py --quantize-tables int8``).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dlrm_tpu.ops import embedding as emb_ops

# pre-rounded f32 reciprocal of 127; both quantizer twins multiply by
# this (division by a literal is not bit-stable under XLA fusion)
_INV127 = np.float32(1.0) / np.float32(127.0)


@jax.tree_util.register_pytree_node_class
class QuantEmb:
    """Quantized stand-in for the embedding storage pytree.

    chunks: per-chunk int8 ``(rows, row_width)`` — same geometry as
      ``config.emb_shapes`` (plain storage quantizes as one pseudo-chunk).
    scales: per-chunk ``(rows, pack)`` dequantization scales, one per
      LOGICAL row (``pack`` logical rows share each physical row).

    Deliberately NOT a NamedTuple: every storage-layout branch in
    ops/embedding.py tests ``isinstance(emb, (tuple, list))`` for the
    engine chunk tuple, and a NamedTuple would silently match.
    """

    __slots__ = ("chunks", "scales")

    def __init__(self, chunks: Tuple[jax.Array, ...],
                 scales: Tuple[jax.Array, ...]):
        self.chunks = tuple(chunks)
        self.scales = tuple(scales)

    def tree_flatten(self):
        return (self.chunks, self.scales), (len(self.chunks),)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def __repr__(self):
        return (f"QuantEmb({len(self.chunks)} chunks, "
                f"{table_bytes(self)} bytes)")


def _quant_logical_rows(x: jax.Array):
    """(N, pack, D) float -> (int8 rows, (N, pack) scales).

    All-zero rows get scale 1 (quantize to exact zeros) instead of a 0/0.
    """
    amax = jnp.max(jnp.abs(x), axis=-1)
    # multiply by the pre-rounded reciprocal (see module docstring: the
    # division form is not bit-stable under XLA fusion)
    scale = jnp.where(amax > 0, amax * _INV127, 1.0)
    q = jnp.clip(jnp.round(x / scale[..., None]), -127, 127)
    return q.astype(jnp.int8), scale


def _quant_chunk_body(c, pack, d):
    x = c.astype(jnp.float32).reshape(c.shape[0], pack, d)
    q, s = _quant_logical_rows(x)
    return q.reshape(c.shape[0], pack * d), s


# One jitted program per chunk: eager (op-by-op) quantization of a big
# chunk materializes several full f32 transients back to back (the cast,
# the divide, the round, the clip — ~4x 5.2 GB for the fs=128 deep chunk)
# and OOMs a 16 GB chip; fused, the peak is one f32 image of the chunk
# plus the int8 output.  The donating twin additionally frees the source
# chunk's buffer inside the call — the capacity-constrained load path.
_quant_chunk = jax.jit(_quant_chunk_body, static_argnums=(1, 2))
_quant_chunk_donate = jax.jit(_quant_chunk_body, static_argnums=(1, 2),
                              donate_argnums=(0,))


def quantize_emb(emb, config, scale_dtype=jnp.float32,
                 donate: bool = False) -> QuantEmb:
    """Quantize either storage layout (engine chunk tuple or plain
    ``(total_rows, D)`` stack) into a :class:`QuantEmb`.

    ``donate=True`` frees each source chunk's device buffer as it is
    quantized (the caller's ``emb`` arrays become invalid) — use when the
    full-precision stack + the int8 stack don't fit HBM together."""
    emb_ops.check_storage(emb, config)
    d = config.feature_size
    kernel = _quant_chunk_donate if donate else _quant_chunk
    if isinstance(emb, (tuple, list)):
        pack = config.pack
        chunks, scales = [], []
        for c in emb:
            q, s = kernel(c, pack, d)
            chunks.append(q)
            scales.append(s.astype(scale_dtype))
        return QuantEmb(tuple(chunks), tuple(scales))
    q, s = kernel(emb, 1, d)
    return QuantEmb((q.reshape(emb.shape),), (s.astype(scale_dtype),))


def quantize_params(params: dict, config) -> dict:
    """Params pytree with ``emb`` replaced by its int8 quantization."""
    return {"bottom": params["bottom"],
            "emb": quantize_emb(params["emb"], config),
            "top": params["top"]}


def _quant_logical_rows_np(x: np.ndarray):
    """numpy twin of :func:`_quant_logical_rows` — same f32 arithmetic,
    same round-half-to-even, so host and device quantization are
    bit-identical (tested)."""
    amax = np.max(np.abs(x), axis=-1)
    scale = np.where(amax > 0, amax * _INV127,
                     np.float32(1.0)).astype(np.float32)
    q = np.clip(np.round(x / scale[..., None]), -127, 127)
    return q.astype(np.int8), scale


def quantize_emb_host(emb, config, scale_dtype=np.float32) -> QuantEmb:
    """Host-side (numpy) quantization — the serving load path.

    The whole point of int8 serving is models whose f32/bf16 tables do
    NOT fit device memory (the Terabyte vocabulary: ~451 GB f32), so
    the full-precision stack must never be device_put: checkpoints
    restore as numpy host arrays, this quantizes them chunk-at-a-time in
    host memory, and only the int8 chunks + scales go to the device.
    Bit-identical to :func:`quantize_emb` on the same input."""
    d = config.feature_size
    chunks_in = emb if isinstance(emb, (tuple, list)) else (emb,)
    pack = config.pack if isinstance(emb, (tuple, list)) else 1
    chunks, scales = [], []
    for c in chunks_in:
        x = np.asarray(c, dtype=np.float32).reshape(c.shape[0], pack, d)
        q, s = _quant_logical_rows_np(x)
        chunks.append(q.reshape(c.shape[0], pack * d))
        scales.append(s.astype(scale_dtype))
    out = QuantEmb(tuple(chunks), tuple(scales))
    check_quant_storage(out, config)
    return out


def quantize_sharded_stack(sharded: np.ndarray, pack: int, d: int,
                           scale_dtype=np.float32):
    """Quantize a sharded (N, local_rows, pack*D) table stack host-side:
    returns (int8 stack, (N, local_rows, pack) scales).

    Scales are per LOGICAL row, so a row quantizes identically wherever
    its physical row lives (engine chunk, shard stack) — padding/trash
    rows are all-zero and get scale 1.  This is the Terabyte serving
    enabler: fs=128 tables are ~451 GB f32 / ~225 GB bf16 — more than
    four 80 GB cards hold — vs ~113 GB int8+scales."""
    n, r, w = sharded.shape
    x = np.asarray(sharded, dtype=np.float32).reshape(n, r, pack, d)
    q, s = _quant_logical_rows_np(x)
    return q.reshape(n, r, w), s.astype(scale_dtype)


def quantize_col_shards(cs_arrays, scale_dtype=np.float32):
    """Quantize column-sharded (N, R_t, D/N) lane slices host-side:
    per-(shard, row) scales over the slice's lanes — finer than the
    whole-row scale (each shard scales its own lanes), so cs tables
    quantize slightly BETTER sharded than unsharded.  Returns
    (int8 slices, (N, R_t) scales), one pair per table."""
    qs, ss = [], []
    for a in cs_arrays:
        x = np.asarray(a, dtype=np.float32)
        amax = np.max(np.abs(x), axis=-1)
        scale = np.where(amax > 0, amax * _INV127,
                         np.float32(1.0)).astype(np.float32)
        q = np.clip(np.round(x / scale[..., None]), -127, 127)
        qs.append(q.astype(np.int8))
        ss.append(scale.astype(scale_dtype))
    return tuple(qs), tuple(ss)


def check_quant_storage(qemb: QuantEmb, config) -> None:
    """Trace-time geometry guard (the QuantEmb arm of check_storage)."""
    shapes = tuple(tuple(c.shape) for c in qemb.chunks)
    if shapes != config.emb_shapes:
        raise ValueError(
            f"quantized chunk shapes {shapes} do not match the config's "
            f"{config.emb_shapes}; re-quantize from storage built under "
            "this config")
    pack = config.pack if config.is_packed else 1
    for c, s in zip(qemb.chunks, qemb.scales):
        if c.dtype != jnp.int8:
            raise ValueError(f"quantized chunks must be int8, got {c.dtype}")
        if s.shape != (c.shape[0], pack):
            raise ValueError(
                f"scale shape {s.shape} != {(c.shape[0], pack)}; scales are "
                "per logical row: (chunk_rows, pack)")


def dequantize_emb(qemb: QuantEmb, config, dtype=jnp.float32):
    """Full dequantization back to the matching storage layout (test
    oracle / interop escape hatch — serving never materializes this)."""
    d = config.feature_size
    if config.is_packed:
        out = []
        for c, s in zip(qemb.chunks, qemb.scales):
            x = c.astype(jnp.float32).reshape(c.shape[0], config.pack, d)
            out.append((x * s.astype(jnp.float32)[..., None])
                       .reshape(c.shape).astype(dtype))
        return tuple(out)
    c, s = qemb.chunks[0], qemb.scales[0]
    return (c.astype(jnp.float32) * s.astype(jnp.float32)).astype(dtype)


def quant_get_logical_table(qemb: QuantEmb, config, t: int,
                            dtype=jnp.float32) -> jax.Array:
    """Table ``t`` dequantized to a logical (rows, D) array."""
    d = config.feature_size
    if config.is_packed:
        c = config.table_chunk[t]
        po = config.chunk_table_offsets[t]
        pn = config.packed_table_rows[t]
        q = qemb.chunks[c][po:po + pn].reshape(pn, config.pack, d)
        s = qemb.scales[c][po:po + pn]
        x = q.astype(jnp.float32) * s.astype(jnp.float32)[..., None]
        return x.reshape(pn * config.pack, d)[:config.table_sizes[t]
                                              ].astype(dtype)
    off = config.table_offsets[t]
    n = config.table_sizes[t]
    q = qemb.chunks[0][off:off + n]
    s = qemb.scales[0][off:off + n]
    return (q.astype(jnp.float32) * s.astype(jnp.float32)).astype(dtype)


def quant_gather_tables(qemb: QuantEmb, ids: jax.Array, config,
                        tables=None, dtype=jnp.float32) -> jax.Array:
    """Un-pooled dequantizing gather: ids (B, T[, H]) -> ids.shape + (D,).

    Mirrors ``embedding.gather_tables``: one fused int8 take per chunk
    (half the HBM bytes of a bf16 gather) plus one tiny scale take, then
    dequantize and slot-extract in f32.
    """
    if tables is None:
        tables = tuple(range(config.num_tables))
    tables = tuple(tables)
    d = config.feature_size
    if not config.is_packed:
        offs = tuple(config.table_offsets[t] for t in tables)
        flat = emb_ops.translate_ids(ids, offs)
        q = jnp.take(qemb.chunks[0], flat, axis=0)
        s = jnp.take(qemb.scales[0], flat, axis=0)
        return (q.astype(jnp.float32) * s.astype(jnp.float32)).astype(dtype)
    parts, order = [], []
    for c, pos, ts in emb_ops.chunk_groups(config, tables):
        ids_g = ids[:, pos] if ids.ndim == 2 else ids[:, pos, :]
        phys, slot = emb_ops.chunk_translate(ids_g, config, ts)
        q = jnp.take(qemb.chunks[c], phys, axis=0)  # (..., pack*D) int8
        s = jnp.take(qemb.scales[c], phys, axis=0)  # (..., pack)
        if config.pack == 1:
            rows = q.astype(jnp.float32)
            scale = s[..., 0]
        else:
            # slot-select FIRST (the shared exact slot extraction), THEN one
            # scale multiply per OUTPUT element — not pack multiplies on
            # a (..., pack, D) f32 dequant of all packed neighbors
            rows = emb_ops.extract_slots(q, slot, config).astype(
                jnp.float32)
            scale = jnp.take_along_axis(s, slot[..., None],
                                        axis=-1)[..., 0]
        parts.append(rows * scale.astype(jnp.float32)[..., None])
        order.extend(pos)
    if len(parts) == 1 and order == list(range(len(tables))):
        return parts[0].astype(dtype)
    stacked = jnp.concatenate(parts, axis=1)
    inv = np.argsort(np.asarray(order))
    return jnp.take(stacked, jnp.asarray(inv), axis=1).astype(dtype)


def quant_mixed_lookup(qemb: QuantEmb, ids: jax.Array, config) -> jax.Array:
    """Pooled lookup from quantized storage, same strategy split as
    ``embedding.mixed_lookup``: int8 gather + dequant for big tables,
    dequantize-whole + gather for small ones (small tables
    are at most ``small_table_threshold`` rows — dequantizing them whole
    is cheaper than per-id scale plumbing).  Output is f32 (serving
    activations; the dense tower's compute_dtype applies downstream)."""
    small, big = emb_ops.partition_tables(config.table_sizes,
                                          config.small_table_threshold)
    if not small:
        return emb_ops.pool(quant_gather_tables(qemb, ids, config))
    parts = []
    if big:
        ids_big = ids[:, big] if ids.ndim == 2 else ids[:, big, :]
        parts.append(emb_ops.pool(
            quant_gather_tables(qemb, ids_big, config, big)))
    for t in small:
        tab = quant_get_logical_table(qemb, config, t)
        idt = ids[:, t] if ids.ndim == 2 else ids[:, t, :]
        parts.append(emb_ops.small_table_lookup(tab, idt,
                                                jnp.float32)[:, None, :])
    stacked = jnp.concatenate(parts, axis=1)
    perm = emb_ops.table_order_permutation(small, big)
    return stacked[:, perm, :]


def table_bytes(qemb: QuantEmb) -> int:
    """Total storage footprint (data + scales) in bytes."""
    return sum(int(np.prod(c.shape)) * c.dtype.itemsize for c in qemb.chunks
               ) + sum(int(np.prod(s.shape)) * s.dtype.itemsize
                       for s in qemb.scales)
