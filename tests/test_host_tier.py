"""Two-tier (HBM + host memory) embedding engine tests.

Contract: a model whose big tables live in host memory computes the SAME
forward, loss, and one-SGD-step result as the all-device model — tier
placement is a pure performance decision, like the reference's CachedArrays
local/remote heaps (SURVEY.md §2.2).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import dlrm_tpu
from dlrm_tpu.data import synthetic
from dlrm_tpu.parallel import host_tier as ht


pytestmark = pytest.mark.skipif(
    not ht.host_memory_supported(),
    reason="backend exposes no pinned_host memory space")


def _setup(n_hot=1, seed=0):
    config = dlrm_tpu.tiny_config(num_tables=6, rows=64, feature_size=8,
                                  n_hot=n_hot)
    # heterogeneous table sizes so the plan is nontrivial
    import dataclasses
    config = dataclasses.replace(
        config, table_sizes=(64, 1000, 16, 2048, 128, 512))
    params = dlrm_tpu.init_params(jax.random.key(seed), config)
    rng = np.random.default_rng(seed)
    batch = synthetic.random_batch(rng, config, 32)
    return config, params, batch


def test_plan_tiers_budget():
    config, _, _ = _setup()
    row_bytes = config.feature_size * 4
    # budget for ~the three smallest tables (64+16+128 = 208 rows)
    plan = ht.plan_tiers(config, 210 * row_bytes)
    assert set(plan.device_tables) == {0, 2, 4}
    assert set(plan.host_tables) == {1, 3, 5}
    assert plan.device_rows == 208
    assert plan.host_rows == 3560
    # no budget limit -> everything on device
    plan_all = ht.plan_tiers(config, None)
    assert plan_all.host_tables == ()
    # zero budget -> everything on host
    plan_none = ht.plan_tiers(config, 0)
    assert plan_none.device_tables == ()


def test_split_merge_roundtrip():
    from dlrm_tpu.ops import embedding as emb_ops
    config, params, _ = _setup()
    plan = ht.plan_tiers(config, 210 * config.feature_size * 4)
    emb = jax.tree.map(np.asarray, params["emb"])  # storage layout (chunked)
    logical = emb_ops.unpack_tables(emb, config)
    emb_dev, emb_host = ht.split_tiers(emb, plan, config)
    assert emb_host.sharding.memory_kind == "pinned_host"
    merged = ht.merge_tiers(emb_dev, emb_host, plan, config)
    np.testing.assert_array_equal(merged, logical)


@pytest.mark.parametrize("n_hot", [1, 3])
def test_tiered_lookup_parity(n_hot):
    config, params, batch = _setup(n_hot=n_hot)
    plan = ht.plan_tiers(config, 210 * config.feature_size * 4)
    emb = jax.tree.map(np.asarray, params["emb"])
    emb_dev, emb_host = ht.split_tiers(emb, plan, config)
    sparse = jnp.asarray(batch["sparse"])

    from dlrm_tpu.ops import embedding as emb_ops
    want = emb_ops.pool(emb_ops.gather_tables(
        jax.tree.map(jnp.asarray, emb), sparse, config))
    got = jax.jit(lambda d, h, s: ht.tiered_lookup(d, h, s, plan, config)
                  )(emb_dev, emb_host, sparse)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("n_hot", [1, 2])
def test_tiered_train_step_parity(n_hot):
    """One tiered SGD step == one all-device step, including both tiers'
    table updates (duplicate ids included)."""
    config, params, batch = _setup(n_hot=n_hot)
    # force duplicate ids within the batch for scatter-add semantics
    sparse = np.asarray(batch["sparse"]).copy()
    sparse[1] = sparse[0]
    batch["sparse"] = sparse

    plan = ht.plan_tiers(config, 210 * config.feature_size * 4)
    tiered = ht.init_tiered_params(jax.tree.map(np.asarray, params), plan,
                                   config)

    ref_step = dlrm_tpu.make_jit_train_step(config, lr=0.1)
    ref_params, ref_loss = ref_step(
        jax.tree.map(jnp.asarray, params), jnp.asarray(batch["dense"]),
        jnp.asarray(batch["sparse"]), jnp.asarray(batch["labels"]))
    step = ht.make_tiered_train_step(config, 0.1, plan)
    new_tiered, loss = step(tiered, jnp.asarray(batch["dense"]),
                            jnp.asarray(batch["sparse"]),
                            jnp.asarray(batch["labels"]))
    from dlrm_tpu.utils.backend import can_pin_host_outputs
    if can_pin_host_outputs():
        # where the backend pins jit outputs, the host stack stays pinned
        # across the step (make_tiered_train_step docstring)
        assert new_tiered["emb_host"].sharding.memory_kind == "pinned_host"
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-6)
    from dlrm_tpu.ops import embedding as emb_ops
    merged = ht.merge_tiers(new_tiered["emb_dev"], new_tiered["emb_host"],
                            plan, config)
    np.testing.assert_allclose(
        merged,
        emb_ops.unpack_tables(
            jax.tree.map(np.asarray, ref_params["emb"]), config),
        atol=1e-5)
    for k in ("bottom", "top"):
        for ours, want in zip(new_tiered[k], ref_params[k]):
            for _k in ("w", "b"):
                np.testing.assert_allclose(np.asarray(ours[_k]),
                                           np.asarray(want[_k]),
                                           atol=1e-5)


def test_all_host_plan_trains():
    """Extreme spill: every table on host; the step still runs and learns."""
    config, params, batch = _setup()
    plan = ht.plan_tiers(config, 0)
    tiered = ht.init_tiered_params(params, plan, config)
    host0 = np.asarray(tiered["emb_host"]).copy()
    step = ht.make_tiered_train_step(config, 0.1, plan)
    losses = []
    for i in range(3):
        tiered, loss = step(tiered, jnp.asarray(batch["dense"]),
                            jnp.asarray(batch["sparse"]),
                            jnp.asarray(batch["labels"]))
        losses.append(float(loss))
    assert all(np.isfinite(l) for l in losses)
    # "learns" must mean the host tier actually moved — a step that
    # silently dropped the host scatter would still print finite losses
    assert not np.array_equal(np.asarray(tiered["emb_host"]), host0)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("n_hot", [1, 2])
def test_tiered_adagrad_matches_dense_oracle(n_hot):
    """Two-tier Adagrad (tier-matched accumulator slabs, dedup-then-apply)
    == dense-gradient Adagrad oracle over 2 steps with duplicate ids."""
    import optax
    from dlrm_tpu.models import dlrm as model_lib
    from dlrm_tpu.ops.loss import bce_loss
    from dlrm_tpu.train.optim import apply_adagrad_dense_table

    config, params, batch = _setup(n_hot=n_hot, seed=3)
    sparse = np.asarray(batch["sparse"]).copy()
    sparse[1] = sparse[0]  # duplicate ids: the adagrad-critical case
    args = (jnp.asarray(batch["dense"]), jnp.asarray(sparse),
            jnp.asarray(batch["labels"]))
    lr, steps = 0.3, 2

    from dlrm_tpu.ops import embedding as emb_ops
    logical = jnp.asarray(emb_ops.unpack_tables(
        jax.tree.map(np.asarray, params["emb"]), config))

    def loss_fn(p):
        # oracle forward on the plain logical stack (unpacked storage)
        pooled = emb_ops.pool(emb_ops.gather_rows(
            p["emb"], emb_ops.translate_ids(args[1],
                                            config.table_offsets)))
        dp = {"bottom": p["bottom"], "top": p["top"]}
        out = model_lib.forward_from_pooled(dp, pooled, args[0], config)
        return bce_loss(out, args[2])

    tx = optax.adagrad(lr, initial_accumulator_value=0.0, eps=1e-10)
    dense_ref = {"bottom": jax.tree.map(jnp.copy, params["bottom"]),
                 "top": jax.tree.map(jnp.copy, params["top"])}
    dstate = tx.init(dense_ref)
    emb_ref = jnp.copy(logical)
    acc = jnp.zeros(logical.shape, jnp.float32)
    for _ in range(steps):
        g = jax.grad(loss_fn)({"bottom": dense_ref["bottom"],
                               "emb": emb_ref,
                               "top": dense_ref["top"]})
        upd, dstate = tx.update({"bottom": g["bottom"], "top": g["top"]},
                                dstate, dense_ref)
        dense_ref = optax.apply_updates(dense_ref, upd)
        emb_ref, acc = apply_adagrad_dense_table(emb_ref, acc, g["emb"],
                                                 lr)

    plan = ht.plan_tiers(config, 210 * config.feature_size * 4)
    assert plan.host_tables and plan.device_tables
    tiered = ht.init_tiered_params(params, plan, config)
    opt = ht.init_tiered_opt_state(tiered, config=config,
                                   optimizer="adagrad", lr=lr, plan=plan)
    step = ht.make_tiered_train_step_opt(config, optimizer="adagrad",
                                         lr=lr, plan=plan)
    state = (tiered, opt)
    for _ in range(steps):
        state, loss = step(state[0], state[1], *args)

    merged = ht.merge_tiers(state[0]["emb_dev"], state[0]["emb_host"],
                            plan, config)
    np.testing.assert_allclose(np.asarray(merged), np.asarray(emb_ref),
                               atol=1e-5, rtol=1e-5)
    for side in ("bottom", "top"):
        for a, b in zip(state[0][side], dense_ref[side]):
            for _k in ("w", "b"):
                np.testing.assert_allclose(np.asarray(a[_k]),
                                           np.asarray(b[_k]),
                                           atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_hot", [1, 2])
def test_tiered_rowwise_adagrad_matches_dense_oracle(n_hot):
    """Two-tier ROW-WISE Adagrad: (R,) device accumulator + (R, 1) pinned
    host scalar slab (1/D the slow-tier optimizer bytes and accumulator
    PCIe traffic) == dense-gradient row-wise oracle over 2 steps with
    duplicate ids."""
    import optax
    from dlrm_tpu.models import dlrm as model_lib
    from dlrm_tpu.ops.loss import bce_loss
    from dlrm_tpu.train.optim import apply_rowwise_adagrad_dense_table

    config, params, batch = _setup(n_hot=n_hot, seed=5)
    sparse = np.asarray(batch["sparse"]).copy()
    sparse[1] = sparse[0]
    args = (jnp.asarray(batch["dense"]), jnp.asarray(sparse),
            jnp.asarray(batch["labels"]))
    lr, steps = 0.3, 2

    from dlrm_tpu.ops import embedding as emb_ops
    logical = jnp.asarray(emb_ops.unpack_tables(
        jax.tree.map(np.asarray, params["emb"]), config))

    def loss_fn(p):
        pooled = emb_ops.pool(emb_ops.gather_rows(
            p["emb"], emb_ops.translate_ids(args[1],
                                            config.table_offsets)))
        dp = {"bottom": p["bottom"], "top": p["top"]}
        out = model_lib.forward_from_pooled(dp, pooled, args[0], config)
        return bce_loss(out, args[2])

    tx = optax.adagrad(lr, initial_accumulator_value=0.0, eps=1e-10)
    dense_ref = {"bottom": jax.tree.map(jnp.copy, params["bottom"]),
                 "top": jax.tree.map(jnp.copy, params["top"])}
    dstate = tx.init(dense_ref)
    emb_ref = jnp.copy(logical)
    acc = jnp.zeros((logical.shape[0],), jnp.float32)
    for _ in range(steps):
        g = jax.grad(loss_fn)({"bottom": dense_ref["bottom"],
                               "emb": emb_ref,
                               "top": dense_ref["top"]})
        upd, dstate = tx.update({"bottom": g["bottom"], "top": g["top"]},
                                dstate, dense_ref)
        dense_ref = optax.apply_updates(dense_ref, upd)
        emb_ref, acc = apply_rowwise_adagrad_dense_table(emb_ref, acc,
                                                         g["emb"], lr)

    plan = ht.plan_tiers(config, 210 * config.feature_size * 4)
    assert plan.host_tables and plan.device_tables
    tiered = ht.init_tiered_params(params, plan, config)
    opt = ht.init_tiered_opt_state(tiered, config=config,
                                   optimizer="rowwise_adagrad", lr=lr,
                                   plan=plan)
    # device acc: engine layout (per-chunk (rows, pack) scalar-per-row);
    # host acc: flat 1-D pinned scalar-per-row carry
    assert all(a.ndim == 2 for a in opt["dev_acc"])
    assert opt["host_acc"].ndim == 1
    step = ht.make_tiered_train_step_opt(
        config, optimizer="rowwise_adagrad", lr=lr, plan=plan)
    state = (tiered, opt)
    for _ in range(steps):
        state, loss = step(state[0], state[1], *args)

    merged = ht.merge_tiers(state[0]["emb_dev"], state[0]["emb_host"],
                            plan, config)
    np.testing.assert_allclose(np.asarray(merged), np.asarray(emb_ref),
                               atol=1e-5, rtol=1e-5)
    # tier accumulators must hold the oracle's per-row scalars (device:
    # read the per-table view out of the chunked engine accumulator)
    dev_cfg = ht.device_subconfig(plan, config)
    for k, t in enumerate(plan.device_tables):
        go, n = config.table_offsets[t], config.table_sizes[t]
        c = dev_cfg.table_chunk[k]
        po = dev_cfg.chunk_table_offsets[k]
        pn = dev_cfg.packed_table_rows[k]
        got = np.asarray(state[1]["dev_acc"][c])[po:po + pn].reshape(-1)[:n]
        np.testing.assert_allclose(
            got, np.asarray(acc)[go:go + n], atol=1e-6, rtol=1e-5)
    for t, lo in zip(plan.host_tables, plan.host_offsets):
        go, n = config.table_offsets[t], config.table_sizes[t]
        np.testing.assert_allclose(
            np.asarray(state[1]["host_acc"])[lo:lo + n],
            np.asarray(acc)[go:go + n], atol=1e-6, rtol=1e-5)
    for side in ("bottom", "top"):
        for a, b in zip(state[0][side], dense_ref[side]):
            for _k in ("w", "b"):
                np.testing.assert_allclose(np.asarray(a[_k]),
                                           np.asarray(b[_k]),
                                           atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_hot", [1, 2])
def test_host_sharded_train_step_matches_single_device(n_hot):
    """Config-5 composition (BASELINE.json): row-sharded tables whose
    per-shard blocks live in pinned HOST memory, in the same step as
    device row-sharded + slot tables — lookup joins the same psum_scatter,
    updates scatter host-side.  Must equal the single-device step."""
    import jax
    from dlrm_tpu.ops import embedding as emb_ops
    from dlrm_tpu.parallel import embedding as pemb
    from dlrm_tpu.parallel.mesh import (batch_sharding, make_mesh,
                                        param_shardings)
    from dlrm_tpu.parallel.placement import plan_placement
    from dlrm_tpu.train.train import make_sharded_train_step, train_step

    config, params, batch = _setup(n_hot=n_hot, seed=5)
    sparse = np.asarray(batch["sparse"]).copy()
    sparse[1] = sparse[0]  # duplicate ids
    args = (jnp.asarray(batch["dense"]), jnp.asarray(sparse),
            jnp.asarray(batch["labels"]))
    lr = 0.4

    ref_params, ref_loss = jax.jit(
        lambda p, d, s, l: train_step(p, d, s, l, config=config, lr=lr)
    )(jax.tree.map(jnp.copy, params), *args)

    mesh = make_mesh(8)
    # tables: (64, 1000, 16, 2048, 128, 512); host-place 3 (the biggest),
    # row-shard 1 on device, slot-place the rest
    p = plan_placement(config.table_sizes, 8, pack=config.pack,
                       max_rows_per_shard=1500, host_tables=(1, 3))
    assert set(p.host_row_sharded) == {1, 3}
    assert set(p.row_sharded) == {1, 3}
    emb_np = np.asarray(emb_ops.unpack_tables(
        jax.tree.map(np.asarray, params["emb"]), config))
    sh_params = {
        "bottom": jax.tree.map(jnp.copy, params["bottom"]),
        "emb": pemb.shard_tables(emb_np, p, config),
        "emb_h": pemb.shard_host_tables(emb_np, p, config),
        "top": jax.tree.map(jnp.copy, params["top"]),
    }
    shardings = param_shardings(mesh, sh_params)
    assert shardings["emb_h"].memory_kind == "pinned_host"
    sh_params = jax.device_put(sh_params, shardings)
    assert sh_params["emb_h"].sharding.memory_kind == "pinned_host"
    bs = batch_sharding(mesh)
    step = make_sharded_train_step(config, lr, mesh, p)
    new_params, loss = step(sh_params,
                            *(jax.device_put(a, bs) for a in args))
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-6)

    got = pemb.unshard_tables(np.asarray(new_params["emb"]), p, config,
                              host=np.asarray(new_params["emb_h"]))
    want = np.asarray(emb_ops.unpack_tables(
        jax.tree.map(np.asarray, ref_params["emb"]), config))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    for side in ("bottom", "top"):
        for a, b in zip(new_params[side], ref_params[side]):
            for _k in ("w", "b"):
                np.testing.assert_allclose(np.asarray(a[_k]),
                                           np.asarray(b[_k]),
                                           atol=1e-5, rtol=1e-5)


def test_pipelined_host_prefetch_matches_inline():
    """The software-pipelined two-tier step (batch N+1's host gather
    issued AFTER step N's scatter — the BatchUpdater analog,
    src/model/embedding_update.jl:1-37) must reproduce the inline tiered
    step's parameter trajectory EXACTLY, including when consecutive
    batches hit the same host-tier rows (the update-then-read hazard the
    data dependency resolves)."""
    from dlrm_tpu.data import synthetic

    config, params, _ = _setup(seed=13)
    plan = ht.plan_tiers(config, 210 * config.feature_size * 4)
    assert plan.host_tables and plan.device_tables
    lr, steps, b = 0.4, 5, 32

    rng = np.random.default_rng(17)
    batches = [synthetic.random_batch(rng, config, b) for _ in range(steps)]
    # force the hazard: step k+1 re-reads rows step k just updated
    for k in range(steps - 1):
        batches[k + 1]["sparse"][:4] = batches[k]["sparse"][:4]

    inline = ht.init_tiered_params(params, plan, config)
    step = ht.make_tiered_train_step(config, lr, plan)
    for bt in batches:
        inline, _ = step(inline, jnp.asarray(bt["dense"]),
                         jnp.asarray(bt["sparse"]),
                         jnp.asarray(bt["labels"]))

    piped = ht.init_tiered_params(params, plan, config)
    pstep = ht.make_tiered_pipelined_step(config, lr, plan)
    pref = ht.prime_host_prefetch(piped["emb_host"],
                                  jnp.asarray(batches[0]["sparse"]), plan)
    losses = []
    for k, bt in enumerate(batches):
        nxt = batches[k + 1] if k + 1 < steps else bt
        (piped, pref), loss = pstep(piped, pref,
                                    jnp.asarray(bt["dense"]),
                                    jnp.asarray(bt["sparse"]),
                                    jnp.asarray(bt["labels"]),
                                    jnp.asarray(nxt["sparse"]))
        losses.append(float(loss))

    assert all(np.isfinite(l) for l in losses)
    for key in ("emb_dev", "emb_host"):
        np.testing.assert_array_equal(np.asarray(inline[key]),
                                      np.asarray(piped[key]), err_msg=key)
    for side in ("bottom", "top"):
        for a, c in zip(inline[side], piped[side]):
            np.testing.assert_array_equal(np.asarray(a["w"]),
                                          np.asarray(c["w"]))


def test_tiered_step_remat_identity():
    """config.remat must cover the two-tier path too (it routes through
    the shared models.dlrm.loss_from_pooled): bit-equal loss and merged
    tables vs the non-remat tiered step."""
    import dataclasses

    config, params, batch = _setup()
    config_r = dataclasses.replace(config, remat=True)
    plan = ht.plan_tiers(config, 210 * config.feature_size * 4)

    def run(cfg):
        tiered = ht.init_tiered_params(jax.tree.map(np.asarray, params),
                                       plan, cfg)
        step = ht.make_tiered_train_step(cfg, 0.1, plan)
        new, loss = step(tiered, jnp.asarray(batch["dense"]),
                         jnp.asarray(batch["sparse"]),
                         jnp.asarray(batch["labels"]))
        return float(loss), ht.merge_tiers(new["emb_dev"],
                                           new["emb_host"], plan, cfg)

    (l1, m1), (l2, m2) = run(config), run(config_r)
    assert l1 == l2
    np.testing.assert_array_equal(m1, m2)


def test_tiered_step_at_fs128_pack1():
    """The f32 fs=128 Kaggle config only fits a 16 GB chip via the host
    tier (17.3 GB of tables): guard the tiered step at the fs=128 shape
    — pack=1, 128-lane physical rows — against the all-device oracle."""
    import dataclasses

    config = dataclasses.replace(
        dlrm_tpu.tiny_config(num_tables=4, rows=64, feature_size=128),
        table_sizes=(64, 1000, 16, 2048),
        bottom_mlp_sizes=(13, 32, 128))
    assert config.pack == 1 and config.is_packed
    params = dlrm_tpu.init_params(jax.random.key(2), config)
    rng = np.random.default_rng(2)
    batch = synthetic.random_batch(rng, config, 32)

    plan = ht.plan_tiers(config, 210 * config.feature_size * 4)
    assert plan.host_tables  # the deep tables actually spilled
    tiered = ht.init_tiered_params(jax.tree.map(np.asarray, params), plan,
                                   config)
    ref_step = dlrm_tpu.make_jit_train_step(config, lr=0.1)
    ref_params, ref_loss = ref_step(
        jax.tree.map(jnp.asarray, params), jnp.asarray(batch["dense"]),
        jnp.asarray(batch["sparse"]), jnp.asarray(batch["labels"]))
    step = ht.make_tiered_train_step(config, 0.1, plan)
    new_tiered, loss = step(tiered, jnp.asarray(batch["dense"]),
                            jnp.asarray(batch["sparse"]),
                            jnp.asarray(batch["labels"]))
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-6)
    from dlrm_tpu.ops import embedding as emb_ops
    merged = ht.merge_tiers(new_tiered["emb_dev"], new_tiered["emb_host"],
                            plan, config)
    np.testing.assert_allclose(
        merged,
        emb_ops.unpack_tables(
            jax.tree.map(np.asarray, ref_params["emb"]), config),
        atol=1e-5)


def _tiered_disjoint_batches(config, k, b, rng):
    """Per-table id spaces partitioned across the K micro-batches so no
    host-tier row is read after being written within a block."""
    dense = rng.normal(size=(k, b, 13)).astype(np.float32)
    sparse = np.stack([np.stack(
        [rng.integers(i * (s // k), (i + 1) * (s // k), size=b)
         for s in config.table_sizes], axis=1)
        for i in range(k)]).astype(np.int32)
    labels = (rng.random((k, b)) > 0.5).astype(np.float32)
    return jnp.asarray(dense), jnp.asarray(sparse), jnp.asarray(labels)


def test_tiered_block1_equals_tiered_step():
    config, params, _ = _setup()
    plan = ht.plan_tiers(config, 210 * config.feature_size * 4)
    rng = np.random.default_rng(7)
    dense, sparse, labels = _tiered_disjoint_batches(config, 1, 32, rng)

    tiered = ht.init_tiered_params(jax.tree.map(np.asarray, params), plan,
                                   config)
    step = ht.make_tiered_train_step(config, 0.1, plan)
    p_ref, loss_ref = step(jax.tree.map(jnp.copy, tiered),
                           dense[0], sparse[0], labels[0])
    blk = ht.make_tiered_train_block(config, 0.1, plan)
    p_blk, losses = blk(jax.tree.map(jnp.copy, tiered),
                        dense, sparse, labels)
    np.testing.assert_allclose(float(losses[0]), float(loss_ref),
                               rtol=1e-6)
    for key in ("emb_dev", "emb_host"):
        np.testing.assert_allclose(np.asarray(p_blk[key]),
                                   np.asarray(p_ref[key]),
                                   rtol=1e-6, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("k", [2, 4])
def test_tiered_block_disjoint_equals_sequential(k):
    """One host gather + one host scatter per K steps: with no host-row
    repeat across micro-batches the block == K sequential tiered steps
    (the BatchUpdater relaxation, host-tier edition)."""
    config, params, _ = _setup()
    plan = ht.plan_tiers(config, 210 * config.feature_size * 4)
    rng = np.random.default_rng(8)
    dense, sparse, labels = _tiered_disjoint_batches(config, k, 32, rng)

    tiered = ht.init_tiered_params(jax.tree.map(np.asarray, params), plan,
                                   config)
    step = ht.make_tiered_train_step(config, 0.1, plan)
    seq = jax.tree.map(jnp.copy, tiered)
    seq_losses = []
    for i in range(k):
        seq, loss = step(seq, dense[i], sparse[i], labels[i])
        seq_losses.append(float(loss))

    blk = ht.make_tiered_train_block(config, 0.1, plan)
    p_blk, losses = blk(jax.tree.map(jnp.copy, tiered),
                        dense, sparse, labels)
    np.testing.assert_allclose(np.asarray(losses), seq_losses, rtol=1e-5)
    for key in ("emb_dev", "emb_host"):
        np.testing.assert_allclose(np.asarray(p_blk[key]),
                                   np.asarray(seq[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    for side in ("bottom", "top"):
        for a, b in zip(p_blk[side], seq[side]):
            np.testing.assert_allclose(np.asarray(a["w"]),
                                       np.asarray(b["w"]),
                                       rtol=1e-5, atol=1e-6)


def test_tiered_block_repeated_ids_trains():
    """With repeated host ids the relaxation still trains (commuting
    scatter-adds; bounded staleness < K) and the loss stays finite."""
    config, params, _ = _setup()
    plan = ht.plan_tiers(config, 210 * config.feature_size * 4)
    rng = np.random.default_rng(9)
    k, b = 3, 32
    dense = jnp.asarray(rng.normal(size=(k, b, 13)).astype(np.float32))
    sparse = np.stack([np.stack(
        [rng.integers(0, s, size=b) for s in config.table_sizes], axis=1)
        for _ in range(k)]).astype(np.int32)
    sparse[1] = sparse[0]  # force cross-micro-batch repeats
    labels = jnp.asarray((rng.random((k, b)) > 0.5).astype(np.float32))

    tiered = ht.init_tiered_params(jax.tree.map(np.asarray, params), plan,
                                   config)
    host0 = np.asarray(tiered["emb_host"]).copy()
    blk = ht.make_tiered_train_block(config, 0.1, plan)
    tiered, losses = blk(tiered, dense, jnp.asarray(sparse), labels)
    assert np.isfinite(np.asarray(losses)).all()
    assert not np.array_equal(np.asarray(tiered["emb_host"]), host0)


@pytest.mark.parametrize("n_hot", [2])
def test_tiered_block_multihot(n_hot):
    """Multi-hot pooled lookups through the block path: block=2 disjoint
    == sequential."""
    import dataclasses
    config, params, _ = _setup(n_hot=n_hot)
    plan = ht.plan_tiers(config, 210 * config.feature_size * 4)
    rng = np.random.default_rng(10)
    k, b = 2, 16
    dense = jnp.asarray(rng.normal(size=(k, b, 13)).astype(np.float32))
    sparse = np.stack([np.stack(
        [rng.integers(i * (s // k), (i + 1) * (s // k), size=(b, n_hot))
         for s in config.table_sizes], axis=1)
        for i in range(k)]).astype(np.int32)
    labels = jnp.asarray((rng.random((k, b)) > 0.5).astype(np.float32))

    tiered = ht.init_tiered_params(jax.tree.map(np.asarray, params), plan,
                                   config)
    step = ht.make_tiered_train_step(config, 0.1, plan)
    seq = jax.tree.map(jnp.copy, tiered)
    for i in range(k):
        seq, _ = step(seq, dense[i], jnp.asarray(sparse[i]), labels[i])
    blk = ht.make_tiered_train_block(config, 0.1, plan)
    p_blk, losses = blk(jax.tree.map(jnp.copy, tiered), dense,
                        jnp.asarray(sparse), labels)
    assert np.isfinite(np.asarray(losses)).all()
    for key in ("emb_dev", "emb_host"):
        np.testing.assert_allclose(np.asarray(p_blk[key]),
                                   np.asarray(seq[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("optimizer", ["adagrad", "rowwise_adagrad"])
def test_tiered_opt_block_disjoint_equals_sequential(optimizer):
    """Coalesced tiered Adagrad block (one host gather + one acc-gather +
    two host scatters per K): with no host-row repeat across
    micro-batches it equals K sequential tiered_train_step_opt calls."""
    config, params, _ = _setup()
    plan = ht.plan_tiers(config, 210 * config.feature_size * 4)
    rng = np.random.default_rng(11)
    k, lr = 2, 0.2
    dense, sparse, labels = _tiered_disjoint_batches(config, k, 32, rng)

    tiered = ht.init_tiered_params(jax.tree.map(np.asarray, params), plan,
                                   config)
    opt0 = ht.init_tiered_opt_state(tiered, config=config,
                                    optimizer=optimizer, lr=lr, plan=plan)
    step = ht.make_tiered_train_step_opt(config, optimizer=optimizer,
                                         lr=lr, plan=plan)
    seq = (jax.tree.map(jnp.copy, tiered), jax.tree.map(jnp.copy, opt0))
    seq_losses = []
    for i in range(k):
        seq, loss = step(seq[0], seq[1], dense[i], sparse[i], labels[i])
        seq_losses.append(float(loss))

    blk = ht.make_tiered_train_block_opt(config, optimizer=optimizer,
                                         lr=lr, plan=plan)
    (p_blk, o_blk), losses = blk(jax.tree.map(jnp.copy, tiered),
                                 jax.tree.map(jnp.copy, opt0),
                                 dense, sparse, labels)
    np.testing.assert_allclose(np.asarray(losses), seq_losses, rtol=1e-5)
    for key in ("emb_dev", "emb_host"):
        np.testing.assert_allclose(np.asarray(p_blk[key]),
                                   np.asarray(seq[0][key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    for key in ("dev_acc", "host_acc"):
        np.testing.assert_allclose(np.asarray(o_blk[key]),
                                   np.asarray(seq[1][key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    assert int(o_blk["count"]) == k


def test_tiered_opt_block1_equals_step():
    config, params, _ = _setup()
    plan = ht.plan_tiers(config, 210 * config.feature_size * 4)
    rng = np.random.default_rng(12)
    dense, sparse, labels = _tiered_disjoint_batches(config, 1, 32, rng)

    tiered = ht.init_tiered_params(jax.tree.map(np.asarray, params), plan,
                                   config)
    opt0 = ht.init_tiered_opt_state(tiered, config=config,
                                    optimizer="rowwise_adagrad", lr=0.2,
                                    plan=plan)
    step = ht.make_tiered_train_step_opt(config,
                                         optimizer="rowwise_adagrad",
                                         lr=0.2, plan=plan)
    (p_ref, o_ref), loss_ref = step(jax.tree.map(jnp.copy, tiered),
                                    jax.tree.map(jnp.copy, opt0),
                                    dense[0], sparse[0], labels[0])
    blk = ht.make_tiered_train_block_opt(config,
                                         optimizer="rowwise_adagrad",
                                         lr=0.2, plan=plan)
    (p_blk, o_blk), losses = blk(jax.tree.map(jnp.copy, tiered),
                                 jax.tree.map(jnp.copy, opt0),
                                 dense, sparse, labels)
    np.testing.assert_allclose(float(losses[0]), float(loss_ref),
                               rtol=1e-6)
    for key in ("emb_dev", "emb_host"):
        np.testing.assert_allclose(np.asarray(p_blk[key]),
                                   np.asarray(p_ref[key]),
                                   rtol=1e-6, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(np.asarray(o_blk["host_acc"]),
                               np.asarray(o_ref["host_acc"]),
                               rtol=1e-6, atol=1e-7)
