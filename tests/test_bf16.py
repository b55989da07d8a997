"""bfloat16 embedding storage and compute-dtype paths.

The reference's @setup experiment runs BF16 embeddings on a BF16-capable
CPU path (/root/reference/src/DLRM.jl:60-67, OneDNN.BFloat16 in
src/cachedarrays.jl:6-19); on the GPU bf16 halves memory traffic.  Contract:
the engine runs end-to-end with bf16 tables (storage halves, updates
accumulate in f32 before the cast) and tracks the f32 model within bf16
resolution.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

import dlrm_tpu
from dlrm_tpu.data import synthetic
from dlrm_tpu.ops import embedding as emb_ops


def _config(**kw):
    c = dlrm_tpu.tiny_config(num_tables=5, rows=64, feature_size=8)
    return dataclasses.replace(c, table_sizes=(33, 7, 64, 129, 40),
                               small_table_threshold=16,
                               chunk_budget_bytes=4096, **kw)


def test_bf16_storage_trains_and_tracks_f32():
    cf = _config()
    cb = _config(embedding_dtype=jnp.bfloat16)
    params_f = dlrm_tpu.init_params(jax.random.key(0), cf)
    # same values, bf16 storage.  NOTE: chunk assignment depends on the
    # storage dtype's bytes (chunk_budget_bytes), so converting dtypes means
    # unpack -> cast -> REPACK under the target config, never a raw cast of
    # the chunk arrays.
    logical = emb_ops.unpack_tables(
        jax.tree.map(np.asarray, params_f["emb"]), cf)
    params_b = {
        "bottom": jax.tree.map(jnp.copy, params_f["bottom"]),
        "emb": jax.tree.map(jnp.asarray, emb_ops.pack_tables(
            logical.astype(jnp.bfloat16), cb)),
        "top": jax.tree.map(jnp.copy, params_f["top"]),
    }
    assert all(c.dtype == jnp.bfloat16 for c in params_b["emb"])

    rng = np.random.default_rng(0)
    batch = synthetic.random_batch(rng, cf, 64)
    args = (jnp.asarray(batch["dense"]), jnp.asarray(batch["sparse"]),
            jnp.asarray(batch["labels"]))
    step_f = dlrm_tpu.make_jit_train_step(cf, 0.1)
    step_b = dlrm_tpu.make_jit_train_step(cb, 0.1)
    pf, loss_f = step_f(params_f, *args)
    pb, loss_b = step_b(params_b, *args)
    assert all(c.dtype == jnp.bfloat16 for c in pb["emb"])
    # losses agree to bf16 resolution (~3 decimal digits)
    np.testing.assert_allclose(float(loss_b), float(loss_f), rtol=2e-2)
    got = emb_ops.unpack_tables(
        tuple(np.asarray(c, np.float32) for c in pb["emb"]), cb)
    want = emb_ops.unpack_tables(jax.tree.map(np.asarray, pf["emb"]), cf)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_bf16_adagrad_block_matches_sequential():
    """dense-G adagrad blocks with bf16 TABLE storage: the accumulator is
    f32, updates cast once at the write — with disjoint ids the block
    tracks K sequential bf16 adagrad steps within bf16 resolution."""
    import pytest
    from dlrm_tpu.train.train import (init_opt_state,
                                      make_jit_train_block_opt,
                                      make_jit_train_step_opt)

    cb = _config(embedding_dtype=jnp.bfloat16)
    params = dlrm_tpu.init_params(jax.random.key(2), cb)
    rng = np.random.default_rng(2)
    k, b = 2, 16
    dense = jnp.asarray(rng.normal(size=(k, b, 13)).astype(np.float32))
    sparse = jnp.asarray(np.stack([np.stack(
        [rng.integers(i * (s // k), (i + 1) * (s // k), size=b)
         for s in cb.table_sizes], axis=1)
        for i in range(k)]).astype(np.int32))
    labels = jnp.asarray((rng.random((k, b)) > 0.5).astype(np.float32))

    step = make_jit_train_step_opt(cb, optimizer="adagrad", lr=0.1)
    p_ref = jax.tree.map(jnp.copy, params)
    o_ref = init_opt_state(p_ref, config=cb, optimizer="adagrad", lr=0.1)
    for i in range(k):
        (p_ref, o_ref), _ = step(p_ref, o_ref, dense[i], sparse[i],
                                 labels[i])

    blk = make_jit_train_block_opt(cb, optimizer="adagrad", lr=0.1,
                                   block=k)
    p_blk = jax.tree.map(jnp.copy, params)
    o_blk = init_opt_state(p_blk, config=cb, optimizer="adagrad", lr=0.1)
    (p_blk, o_blk), losses = blk(p_blk, o_blk, dense, sparse, labels)
    assert all(c.dtype == jnp.bfloat16 for c in p_blk["emb"])
    got = emb_ops.unpack_tables(
        tuple(np.asarray(c, np.float32) for c in p_blk["emb"]), cb)
    want = emb_ops.unpack_tables(
        tuple(np.asarray(c, np.float32) for c in p_ref["emb"]), cb)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    # accumulators are f32 and must agree tightly
    for a, b_ in zip(o_ref["emb"].acc, o_blk["emb"].acc):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b_),
                                   atol=1e-5, rtol=1e-4)


def test_bf16_storage_multi_step_finite():
    cb = _config(embedding_dtype=jnp.bfloat16, n_hot=2)
    params = dlrm_tpu.init_params(jax.random.key(1), cb)
    rng = np.random.default_rng(1)
    step = dlrm_tpu.make_jit_train_step(cb, 0.1)
    for _ in range(5):
        batch = synthetic.random_batch(rng, cb, 32)
        params, loss = step(params, jnp.asarray(batch["dense"]),
                            jnp.asarray(batch["sparse"]),
                            jnp.asarray(batch["labels"]))
        assert np.isfinite(float(loss))
    out = dlrm_tpu.forward(params, jnp.asarray(batch["dense"]),
                           jnp.asarray(batch["sparse"]), cb)
    assert np.all(np.isfinite(np.asarray(out, np.float32)))


def test_fs128_bf16_rowwise_path_smoke():
    """The bench.py fs=128 operating point at tiny scale: pack=1 (128-lane
    physical rows hold exactly one logical row), bf16 chunked storage,
    exact SGD + rowwise adagrad + mixed_lookup all compile and stay
    finite.  Kaggle fs=128 itself is 8.6 GB bf16 — bench-only."""
    import dataclasses
    import numpy as np
    from dlrm_tpu.ops.embedding import mixed_lookup
    from dlrm_tpu.train.train import init_opt_state, make_jit_train_step_opt

    config = dataclasses.replace(
        dlrm_tpu.DLRMConfig(
            bottom_mlp_sizes=(13, 32, 128),
            top_mlp_sizes=(32, 1),
            feature_size=128,
            table_sizes=(64, 4000, 120, 9000),
            small_table_threshold=100,
            chunk_budget_bytes=1 << 20,  # force a multi-chunk split
            deep_chunk_budget_bytes=1 << 20,
        ),
        embedding_dtype=jnp.bfloat16)
    assert config.pack == 1 and config.is_packed
    assert config.num_chunks >= 3  # 4000- and 9000-row tables ~1-2.2 MB
    params = dlrm_tpu.init_params(jax.random.key(0), config)
    assert all(c.dtype == jnp.bfloat16 for c in params["emb"])

    rng = np.random.default_rng(0)
    b = 32
    dense = jnp.asarray(rng.normal(size=(b, 13)).astype(np.float32))
    sparse = jnp.asarray(np.stack(
        [rng.integers(0, s, size=b) for s in config.table_sizes],
        axis=1).astype(np.int32))
    labels = jnp.asarray((rng.random(b) > 0.5).astype(np.float32))

    pooled = mixed_lookup(params["emb"], sparse, config)
    assert pooled.shape == (b, 4, 128) and np.isfinite(
        np.asarray(pooled, np.float32)).all()

    step = dlrm_tpu.make_jit_train_step(config, lr=0.1)
    p2, loss = step(jax.tree.map(jnp.copy, params), dense, sparse, labels)
    assert np.isfinite(float(loss))

    opt = init_opt_state(params, config=config, optimizer="rowwise_adagrad",
                         lr=0.01)
    astep = make_jit_train_step_opt(config, optimizer="rowwise_adagrad",
                                    lr=0.01)
    (p3, opt), loss2 = astep(params, opt, dense, sparse, labels)
    assert np.isfinite(float(loss2))
