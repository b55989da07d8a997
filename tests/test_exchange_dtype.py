"""bf16 exchange compression (config.exchange_dtype).

The sharded embedding path's collectives (slot/cs all_to_all, rs
psum_scatter/all_gather, DCN gradient fold) optionally ride the wire in
bf16 — half the collective bytes (SCALING.md: the fs=128 pooled a2a is the
dominant per-step collective).  The numerics contract is crisp and these
tests pin it bit-exactly:

* forward (single-id): compressed lookup == f32 lookup rounded ONCE to
  bf16 (collectives only move data / add disjoint-support partials);
* backward: compressed update == uncompressed update applied to the
  bf16-pre-rounded gradient (routing collectives only move data);
* multi-hot rs partials may straddle owners, so the forward there gets a
  tolerance bound instead of bit-exactness.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dlrm_tpu
from dlrm_tpu.parallel import embedding as pemb
from dlrm_tpu.parallel.mesh import batch_sharding, make_mesh, param_shardings
from dlrm_tpu.parallel.placement import plan_placement
from dlrm_tpu.ops import embedding as emb_ops

BF16 = jnp.bfloat16


def _setup(rng, n_hot=1, b=32):
    """slot + device row-sharded + column-sharded placement on 8 shards."""
    config = dlrm_tpu.tiny_config(num_tables=6, rows=64, feature_size=8,
                                  n_hot=n_hot)
    config = dataclasses.replace(
        config, table_sizes=(64, 400, 12, 300, 64, 500),
        packed_tables=False)  # column sharding requires pack == 1
    params = dlrm_tpu.init_params(jax.random.key(7), config)
    mesh = make_mesh(8)
    p = plan_placement(config.table_sizes, 8, pack=1,
                       max_rows_per_shard=350, col_sharded_tables=(3,))
    assert p.row_sharded and p.col_sharded and p.slot_table_list
    emb_np = np.asarray(params["emb"])
    from jax.sharding import NamedSharding, PartitionSpec as P
    shd = NamedSharding(mesh, P("d"))
    sh = {
        "emb": jax.device_put(
            jnp.asarray(pemb.shard_tables(emb_np, p, config)), shd),
        "emb_cs": tuple(
            jax.device_put(jnp.asarray(a), shd)
            for a in pemb.shard_col_tables(emb_np, p, config)),
    }
    if config.n_hot == 1:
        ids = np.stack([rng.integers(0, s, size=b)
                        for s in config.table_sizes], axis=1)
    else:
        ids = np.stack([rng.integers(0, s, size=(b, config.n_hot))
                        for s in config.table_sizes], axis=1)
    ids = jax.device_put(jnp.asarray(ids.astype(np.int32)),
                         batch_sharding(mesh))
    return config, params, mesh, p, sh, ids


def _lookup(sh, ids, mesh, p, xd):
    return jax.jit(lambda e, cs, i: pemb.sharded_lookup(
        e, i, mesh=mesh, placement=p, cs=cs, exchange_dtype=xd)
    )(sh["emb"], sh["emb_cs"], ids)


def test_bf16_exchange_lookup_is_one_rounding(rng):
    """One-hot: the compressed lookup equals the f32 lookup rounded once
    to bf16 — bit-exact, every placement kind exercised."""
    config, params, mesh, p, sh, ids = _setup(rng, n_hot=1)
    f32 = np.asarray(_lookup(sh, ids, mesh, p, None))
    got = np.asarray(_lookup(sh, ids, mesh, p, BF16))
    want = np.asarray(jnp.asarray(f32).astype(BF16).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)
    # and the f32 path is the single-device lookup (sanity anchor)
    single = np.asarray(emb_ops.mixed_lookup(
        params["emb"], jnp.asarray(np.asarray(ids)),
        dataclasses.replace(config, small_table_threshold=0)))
    np.testing.assert_allclose(f32, single, atol=1e-6)


def test_bf16_exchange_lookup_multihot_bounded(rng):
    """Multi-hot: rs partials may straddle owners (extra bf16 additions),
    so the bound is a few ulps of the pooled magnitude, not bit-equality."""
    config, params, mesh, p, sh, ids = _setup(rng, n_hot=4)
    f32 = np.asarray(_lookup(sh, ids, mesh, p, None))
    got = np.asarray(_lookup(sh, ids, mesh, p, BF16))
    # each contributing row rounds relative to ITS OWN magnitude (pooled
    # values can be small through cancellation), so bound by the pooled
    # ABSOLUTE row mass: |err| <= (H roundings + straddled partial sums)
    # * 2^-8 * sum_h |row_h|
    cfg_abs = dataclasses.replace(config, small_table_threshold=0)
    abs_mass = np.asarray(emb_ops.mixed_lookup(
        jnp.abs(params["emb"]), jnp.asarray(np.asarray(ids)), cfg_abs))
    tol = abs_mass * (2.0 ** -8) * (config.n_hot + 2) + 1e-6
    assert np.all(np.abs(got - f32) <= tol)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rowwise_adagrad"])
def test_bf16_exchange_update_equals_prerounded_gradient(optimizer, rng):
    """The compressed update == the uncompressed update applied to the
    bf16-pre-rounded d_pooled (gradient routing only MOVES data), for
    every placement kind and optimizer."""
    config, params, mesh, p, sh, ids = _setup(rng, n_hot=1)
    b = ids.shape[0]
    d_pooled = jnp.asarray(rng.normal(size=(
        b, config.num_tables, config.feature_size)).astype(np.float32))
    d_pooled = jax.device_put(d_pooled, batch_sharding(mesh))
    rounded = d_pooled.astype(BF16).astype(jnp.float32)
    lr = 0.37

    if optimizer == "sgd":
        def run(dp, xd):
            new_emb, _, new_cs = pemb.sharded_update_sgd(
                sh["emb"], ids, dp, lr, mesh=mesh, placement=p,
                cs=sh["emb_cs"], exchange_dtype=xd)
            return new_emb, new_cs
        got_emb, got_cs = run(d_pooled, BF16)
        want_emb, want_cs = run(rounded, None)
    else:
        rowwise = optimizer == "rowwise_adagrad"
        acc = jnp.zeros_like(sh["emb"])
        acc_cs = tuple(
            (jnp.zeros((a.shape[1],), jnp.float32) if rowwise
             else jnp.zeros_like(a)) for a in sh["emb_cs"])

        def run(dp, xd):
            out = pemb.sharded_update_adagrad(
                sh["emb"], acc, ids, dp, lr, mesh=mesh, placement=p,
                cs=sh["emb_cs"], acc_cs=acc_cs, rowwise=rowwise,
                exchange_dtype=xd)
            return out[0], out[4]
        got_emb, got_cs = run(d_pooled, BF16)
        want_emb, want_cs = run(rounded, None)

    np.testing.assert_array_equal(np.asarray(got_emb),
                                  np.asarray(want_emb))
    for g, w in zip(got_cs, want_cs):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # and it actually changed something (guards a silently-dead update)
    assert not np.array_equal(np.asarray(got_emb), np.asarray(sh["emb"]))


def test_bf16_exchange_block_path_equals_prerounded(rng):
    """The coalesced block routing (block_leading: (K, B, ...) stacks)
    compresses identically: == uncompressed update of the pre-rounded
    stack."""
    from dlrm_tpu.parallel.mesh import block_batch_sharding

    config, params, mesh, p, sh, ids = _setup(rng, n_hot=1)
    K, b = 2, ids.shape[0]
    bbs = block_batch_sharding(mesh)
    ids_k = jax.device_put(jnp.stack([ids, jnp.roll(ids, 1, axis=0)]),
                           bbs)
    d_stack = jax.device_put(jnp.asarray(rng.normal(size=(
        K, b, config.num_tables, config.feature_size)).astype(np.float32)),
        bbs)
    rounded = d_stack.astype(BF16).astype(jnp.float32)

    def run(dp, xd):
        new_emb, _, new_cs = pemb.sharded_update_sgd(
            sh["emb"], ids_k, dp, 0.21, mesh=mesh, placement=p,
            cs=sh["emb_cs"], block_leading=True, exchange_dtype=xd)
        return new_emb, new_cs

    got_emb, got_cs = run(d_stack, BF16)
    want_emb, want_cs = run(rounded, None)
    np.testing.assert_array_equal(np.asarray(got_emb),
                                  np.asarray(want_emb))
    for g, w in zip(got_cs, want_cs):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert not np.array_equal(np.asarray(got_emb), np.asarray(sh["emb"]))


@pytest.mark.parametrize("rowwise", [False, True])
def test_bf16_exchange_twin_schedule_equals_prerounded(rowwise, rng):
    """Scheduled blocks route the twin (g, lr_k*g) payload; compression
    rounds EACH half independently on the wire (bf16(lr_k*g) is NOT
    lr_k*bf16(g)) — so the oracle pre-rounds both halves."""
    config, params, mesh, p, sh, ids = _setup(rng, n_hot=1)
    b = ids.shape[0]
    from jax.sharding import NamedSharding, PartitionSpec as P
    bs = NamedSharding(mesh, P("d"))
    dp = jax.device_put(jnp.asarray(rng.normal(size=(
        b, config.num_tables, config.feature_size)).astype(np.float32)),
        bs)
    dps = 0.033 * dp  # the lr_k-scaled half
    acc = jnp.zeros_like(sh["emb"])
    acc_cs = tuple(
        (jnp.zeros((a.shape[1],), jnp.float32) if rowwise
         else jnp.zeros_like(a)) for a in sh["emb_cs"])

    def run(g, gs, xd):
        out = pemb.sharded_update_adagrad(
            sh["emb"], acc, ids, g, 1.0, mesh=mesh, placement=p,
            cs=sh["emb_cs"], acc_cs=acc_cs, rowwise=rowwise,
            d_pooled_scaled=gs, exchange_dtype=xd)
        return out[0], out[4]

    rnd = lambda x: x.astype(BF16).astype(jnp.float32)  # noqa: E731
    got_emb, got_cs = run(dp, dps, BF16)
    want_emb, want_cs = run(rnd(dp), rnd(dps), None)
    np.testing.assert_array_equal(np.asarray(got_emb),
                                  np.asarray(want_emb))
    for g, w in zip(got_cs, want_cs):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert not np.array_equal(np.asarray(got_emb), np.asarray(sh["emb"]))


def test_bf16_exchange_full_step_trains(rng):
    """End-to-end sharded SGD step with bf16 exchange: loss finite,
    parameters move, and stay within bf16-scale distance of the f32-
    exchange step."""
    from dlrm_tpu.train.train import make_sharded_train_step

    config, params, mesh, p, sh, ids = _setup(rng, n_hot=1)
    dense = jax.device_put(jnp.asarray(
        rng.normal(size=(32, 13)).astype(np.float32)),
        batch_sharding(mesh))
    labels = jax.device_put(jnp.asarray(
        (rng.random(32) > 0.5).astype(np.float32)), batch_sharding(mesh))
    full = {"bottom": params["bottom"], "top": params["top"], **sh}

    cfg_bf16 = dataclasses.replace(config, exchange_dtype=BF16)
    step16 = make_sharded_train_step(cfg_bf16, 0.1, mesh, p)
    new16, loss16 = step16(jax.tree.map(jnp.copy, full), dense, ids, labels)
    step32 = make_sharded_train_step(config, 0.1, mesh, p)
    new32, loss32 = step32(jax.tree.map(jnp.copy, full), dense, ids, labels)
    assert np.isfinite(float(loss16))
    np.testing.assert_allclose(float(loss16), float(loss32), atol=5e-3)
    d = np.abs(np.asarray(new16["emb"]) - np.asarray(new32["emb"]))
    assert d.max() < 1e-2  # lr * bf16 rounding of the gradient
    assert d.max() > 0  # the compression is actually in the program
