"""Lane-packed, chunked table storage: oracle tests against the plain layout.

The engine storage format (PACK = 128 // D logical rows per 128-lane
physical row, whole tables binned into <= chunk_budget_bytes chunks —
ops/embedding.py) is a pure storage decision: every operation must produce
identical results to the plain (R, D) stacked layout.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import dlrm_tpu
from dlrm_tpu.data import synthetic
from dlrm_tpu.ops import embedding as emb_ops


def _config(n_hot=1, fs=16, chunk_budget=4096):
    """Tiny chunk budget so multiple chunks are exercised."""
    c = dlrm_tpu.tiny_config(num_tables=5, rows=32, feature_size=fs,
                             n_hot=n_hot)
    # ragged sizes so per-table packing padding is exercised (33 % 8 != 0)
    return dataclasses.replace(c, table_sizes=(33, 7, 64, 129, 40),
                               chunk_budget_bytes=chunk_budget)


def test_geometry():
    c = _config()
    assert c.pack == 8 and c.is_packed
    assert c.packed_table_rows == (5, 1, 8, 17, 5)
    # 4096-byte budget = 8 physical rows of 512 B; FFD by packed rows
    # desc (17, 8, 5, 5, 1): 17 -> own oversize chunk 0; 8 -> chunk 1
    # (exactly full); 5 -> chunk 2; second 5 doesn't fit anywhere ->
    # chunk 3; 1 first-fits chunk 2 (5+1=6 <= 8).  Assert the exact
    # deterministic binning so an FFD regression (e.g. one-table-per-
    # chunk, which would still satisfy a weak num_chunks bound) fails.
    assert c.table_chunk == (2, 2, 1, 0, 3)
    assert c.num_chunks == 4
    assert c.chunk_rows == (17, 8, 6, 5)
    # every chunk except oversize tables fits the budget
    row_bytes = c.row_width * 4
    for ci, rows in enumerate(c.chunk_rows):
        tables = [t for t in range(c.num_tables) if c.table_chunk[t] == ci]
        if len(tables) > 1:
            assert rows * row_bytes <= c.chunk_budget_bytes
    assert sum(c.chunk_rows) == c.packed_total_rows
    assert all(w == 128 for (_, w) in c.emb_shapes)
    c1 = dataclasses.replace(c, packed_tables=False)
    assert c1.pack == 1 and not c1.is_packed
    c3 = dataclasses.replace(c, feature_size=48)  # 48 doesn't divide 128
    assert c3.pack == 1 and c3.row_width == 48  # chunked, unpacked rows


def test_pack_unpack_roundtrip(rng):
    c = _config()
    logical = rng.normal(size=(c.total_rows, c.feature_size)).astype(
        np.float32)
    packed = emb_ops.pack_tables(logical, c)
    assert isinstance(packed, tuple) and len(packed) == c.num_chunks
    for arr, shape in zip(packed, c.emb_shapes):
        assert arr.shape == shape
    np.testing.assert_array_equal(emb_ops.unpack_tables(packed, c), logical)
    # jax-array path too
    packed_j = emb_ops.pack_tables(jnp.asarray(logical), c)
    np.testing.assert_array_equal(np.asarray(
        emb_ops.unpack_tables(packed_j, c)), logical)
    # per-table logical view
    for t in range(c.num_tables):
        off = c.table_offsets[t]
        np.testing.assert_array_equal(
            np.asarray(emb_ops.get_logical_table(packed, c, t)),
            logical[off:off + c.table_sizes[t]])


@pytest.mark.parametrize("n_hot", [1, 3])
def test_chunked_gather_matches_plain(n_hot, rng):
    c = _config(n_hot=n_hot)
    logical = rng.normal(size=(c.total_rows, c.feature_size)).astype(
        np.float32)
    packed = jax.tree.map(jnp.asarray, emb_ops.pack_tables(logical, c))
    batch = synthetic.random_batch(rng, c, 64)
    ids = jnp.asarray(batch["sparse"])

    want = emb_ops.gather_rows(jnp.asarray(logical),
                               emb_ops.translate_ids(ids, c.table_offsets))
    got = emb_ops.gather_tables(packed, ids, c)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # subset of tables, arbitrary order
    subset = (3, 0, 4)
    ids_s = ids[:, subset] if ids.ndim == 2 else ids[:, subset, :]
    want_s = np.asarray(want)[:, list(subset)]
    got_s = emb_ops.gather_tables(packed, ids_s, c, subset)
    np.testing.assert_array_equal(np.asarray(got_s), want_s)


@pytest.mark.parametrize("n_hot", [1, 2])
def test_chunked_sgd_matches_plain(n_hot, rng):
    """Scatter-add SGD on chunked storage == plain, including duplicate ids
    (same logical row twice AND different logical rows sharing a physical
    row)."""
    c = _config(n_hot=n_hot)
    logical = rng.normal(size=(c.total_rows, c.feature_size)).astype(
        np.float32)
    batch = synthetic.random_batch(rng, c, 64)
    sparse = np.asarray(batch["sparse"]).copy()
    sparse[1] = sparse[0]          # duplicate logical rows
    if n_hot == 1:
        sparse[2, 0] = 0
        sparse[3, 0] = 1           # same physical row, different slots
    ids = jnp.asarray(sparse)
    shape = ids.shape + (c.feature_size,)
    d_rows = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    lr = 0.5

    flat = emb_ops.translate_ids(ids, c.table_offsets)
    want = emb_ops.apply_sparse_sgd(
        jnp.asarray(logical),
        emb_ops.SparseGrad(flat.reshape(-1),
                           d_rows.reshape(-1, c.feature_size)), lr)

    got_packed = emb_ops.apply_sgd_chunked(
        jax.tree.map(jnp.asarray, emb_ops.pack_tables(logical, c)),
        ids, d_rows, lr, c)
    got = emb_ops.unpack_tables(
        tuple(np.asarray(x) for x in got_packed), c)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def test_chunked_vs_plain_train_step(rng):
    """Full train steps agree between storage layouts."""
    c = _config()
    cp = dataclasses.replace(c, packed_tables=False)
    params_packed = dlrm_tpu.init_params(jax.random.key(0), c)
    # deep-copy shared leaves: both steps donate their params
    params_plain = {
        "bottom": jax.tree.map(jnp.copy, params_packed["bottom"]),
        "emb": jnp.asarray(emb_ops.unpack_tables(
            tuple(np.asarray(x) for x in params_packed["emb"]), c)),
        "top": jax.tree.map(jnp.copy, params_packed["top"]),
    }
    batch = synthetic.random_batch(rng, c, 32)
    args = (jnp.asarray(batch["dense"]), jnp.asarray(batch["sparse"]),
            jnp.asarray(batch["labels"]))
    step_p = dlrm_tpu.make_jit_train_step(c, 0.1)
    step_l = dlrm_tpu.make_jit_train_step(cp, 0.1)
    new_p, loss_p = step_p(params_packed, *args)
    new_l, loss_l = step_l(params_plain, *args)
    np.testing.assert_allclose(float(loss_p), float(loss_l), atol=1e-6)
    np.testing.assert_allclose(
        emb_ops.unpack_tables(
            tuple(np.asarray(x) for x in new_p["emb"]), c),
        np.asarray(new_l["emb"]), atol=1e-5)


def test_translate_ids_nhot_equals_num_tables(rng):
    """Regression: (B, T, H) vs (B, T) must disambiguate by RANK — when
    n_hot == num_tables a last-axis length test routes per-table offsets
    along the hot axis, silently gathering from the wrong tables."""
    c = dlrm_tpu.tiny_config(num_tables=3, rows=50, feature_size=8, n_hot=3)
    logical = rng.normal(size=(c.total_rows, c.feature_size)).astype(
        np.float32)
    ids = np.stack([rng.integers(0, 50, size=(16, 3)) for _ in range(3)],
                   axis=1).astype(np.int32)      # (B=16, T=3, H=3)
    flat = emb_ops.translate_ids(jnp.asarray(ids), c.table_offsets)
    # table axis is dim 1: every id of table t must land in table t's range
    for t in range(3):
        off = c.table_offsets[t]
        vals = np.asarray(flat)[:, t, :]
        assert vals.min() >= off and vals.max() < off + 50, t
    # pooled lookup equals a per-table manual oracle
    got = emb_ops.pool(emb_ops.gather_rows(jnp.asarray(logical), flat))
    for t in range(3):
        off = c.table_offsets[t]
        want = logical[off + ids[:, t]].sum(axis=1)
        np.testing.assert_allclose(np.asarray(got)[:, t], want, atol=1e-6)


# -- exact lane-slot selection ----------------------------------------------
# Slot extraction and expansion are selects, not one-hot matmuls: a matmul
# would run in TF32 at the GPU's default precision and round stored values.
# Bit patterns with full mantissas (and an int8 stack) must come back
# unchanged whatever the matmul precision.

@pytest.mark.parametrize("pack,dtype", [(2, jnp.float32), (8, jnp.float32),
                                        (16, jnp.float32),
                                        (8, jnp.bfloat16), (8, jnp.int8)])
def test_extract_slots_returns_stored_bits(pack, dtype, rng):
    d = 128 // pack
    if dtype == jnp.int8:
        rows = rng.integers(-127, 128, size=(64, pack * d))
    else:
        rows = rng.normal(size=(64, pack * d))
    rows = jnp.asarray(rows, dtype)
    slot = jnp.asarray(rng.integers(0, pack, size=64), jnp.int32)
    with jax.default_matmul_precision("default"):
        got = jax.jit(lambda g, s: emb_ops.extract_slots(
            g, s, pack=pack, d=d))(rows, slot)
    want = np.asarray(rows).reshape(64, pack, d)[np.arange(64),
                                                  np.asarray(slot)]
    assert got.dtype == rows.dtype
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("pack", [2, 8, 16])
def test_expand_slots_places_rows_exactly(pack, rng):
    d = 128 // pack
    upd = jnp.asarray(rng.normal(size=(32, 3, d)), jnp.float32)
    slot = jnp.asarray(rng.integers(0, pack, size=(32, 3)), jnp.int32)
    with jax.default_matmul_precision("default"):
        out = np.asarray(emb_ops.expand_slots(upd, slot, pack=pack))
    out = out.reshape(32, 3, pack, d)
    s = np.asarray(slot)
    for b in range(32):
        for t in range(3):
            np.testing.assert_array_equal(out[b, t, s[b, t]],
                                          np.asarray(upd)[b, t])
            others = np.delete(out[b, t], s[b, t], axis=0)
            assert not others.any()
    # expand then extract is the identity on the rows, bit for bit
    back = emb_ops.extract_slots(jnp.asarray(out.reshape(32, 3, -1)),
                                 slot, pack=pack, d=d)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(upd))


def test_small_table_lookup_is_a_gather(rng):
    """Small tables: stored rows back bit for bit (f32), multi-hot sums in
    f32, and a dense table gradient that sums duplicate ids."""
    tab = jnp.asarray(rng.normal(size=(7, 16)), jnp.float32)
    ids = jnp.asarray([0, 3, 3, 6, 3], jnp.int32)
    with jax.default_matmul_precision("default"):
        got = emb_ops.small_table_lookup(tab, ids, jnp.float32)
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(tab)[np.asarray(ids)])
        g = jax.grad(lambda t: emb_ops.small_table_lookup(
            t, ids, jnp.float32).sum())(tab)
    np.testing.assert_array_equal(np.asarray(g)[:, 0],
                                  [1, 0, 0, 3, 0, 0, 1])
    hot = jnp.asarray([[0, 3], [6, 6]], jnp.int32)
    np.testing.assert_allclose(
        np.asarray(emb_ops.small_table_lookup(tab, hot, jnp.float32)),
        np.asarray(tab)[[0, 6]] + np.asarray(tab)[[3, 6]], rtol=1e-6)


def test_mixed_lookup_returns_stored_rows_bit_for_bit(rng):
    """The whole engine lookup (packed gather + slot extract + small-table
    gather) at default precision equals indexing the logical tables."""
    c = dataclasses.replace(_config(), small_table_threshold=40)
    params = dlrm_tpu.init_params(jax.random.key(3), c)
    batch = synthetic.random_batch(rng, c, 64)
    with jax.default_matmul_precision("default"):
        got = jax.jit(lambda e, s: emb_ops.mixed_lookup(e, s, c))(
            params["emb"], jnp.asarray(batch["sparse"]))
    logical = np.asarray(emb_ops.unpack_tables(params["emb"], c))
    want = logical[batch["sparse"] + np.asarray(c.table_offsets)]
    np.testing.assert_array_equal(np.asarray(got), want)
