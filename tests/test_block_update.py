"""Coalesced K-step block updates (the BatchUpdater analog).

The reference's BatchUpdater (src/model/embedding_update.jl:1-37, disabled)
aggregates sparse updates and trickles them into the tables behind the
forward pass, tolerating bounded staleness.  train.train_block is the
JAX equivalent; its exactness contract is oracle-tested here:

* block=1 is bit-identical to train_step;
* when no big-table id repeats across micro-batches, a K-block is
  bit-identical to K sequential train_step calls (scatter-adds commute,
  dense params and small tables are carried exactly);
* with repeated ids the relaxation still trains (AUC rises on the skewed
  synthetic task like exact SGD does).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import dlrm_tpu
from dlrm_tpu.train.train import make_jit_train_block


def _config():
    # small_table_threshold=16 makes tables 0,2 one-hot-path and 1,3 gather
    import dataclasses
    return dataclasses.replace(
        dlrm_tpu.tiny_config(num_tables=4, rows=256, feature_size=8),
        small_table_threshold=16, table_sizes=(16, 256, 8, 256))


def _batches(config, k, b, rng, disjoint=False):
    dense = rng.normal(size=(k, b, 13)).astype(np.float32)
    if disjoint:
        # partition each table's id space across the K micro-batches so no
        # row is read after being written within the block
        sparse = np.stack([np.stack(
            [rng.integers(i * (s // k), (i + 1) * (s // k), size=b)
             for s in config.table_sizes], axis=1)
            for i in range(k)]).astype(np.int32)
    else:
        sparse = np.stack([np.stack(
            [rng.integers(0, s, size=b) for s in config.table_sizes],
            axis=1) for _ in range(k)]).astype(np.int32)
    labels = (rng.random((k, b)) > 0.5).astype(np.float32)
    return jnp.asarray(dense), jnp.asarray(sparse), jnp.asarray(labels)


def _leaves_allclose(a, b, **kw):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **kw)


def test_block1_equals_train_step():
    config = _config()
    params = dlrm_tpu.init_params(jax.random.key(0), config)
    rng = np.random.default_rng(0)
    dense, sparse, labels = _batches(config, 1, 32, rng)
    step = dlrm_tpu.make_jit_train_step(config, lr=0.1)
    blk = make_jit_train_block(config, lr=0.1, block=1)

    p_ref, loss_ref = step(jax.tree.map(jnp.copy, params),
                           dense[0], sparse[0], labels[0])
    p_blk, losses = blk(jax.tree.map(jnp.copy, params),
                        dense, sparse, labels)
    np.testing.assert_allclose(float(losses[0]), float(loss_ref), rtol=1e-6)
    _leaves_allclose(p_ref, p_blk, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("k", [2, 4])
def test_block_disjoint_ids_equals_sequential(k):
    """No id repeats across micro-batches => block == sequential exactly."""
    config = _config()
    params = dlrm_tpu.init_params(jax.random.key(1), config)
    rng = np.random.default_rng(1)
    dense, sparse, labels = _batches(config, k, 32, rng, disjoint=True)
    step = dlrm_tpu.make_jit_train_step(config, lr=0.1)
    blk = make_jit_train_block(config, lr=0.1, block=k)

    p_ref = jax.tree.map(jnp.copy, params)
    ref_losses = []
    for i in range(k):
        p_ref, loss = step(p_ref, dense[i], sparse[i], labels[i])
        ref_losses.append(float(loss))
    p_blk, losses = blk(jax.tree.map(jnp.copy, params),
                        dense, sparse, labels)
    np.testing.assert_allclose(np.asarray(losses), ref_losses, rtol=1e-5)
    _leaves_allclose(p_ref, p_blk, rtol=1e-5, atol=1e-6)


def test_block_multihot_disjoint_equals_sequential():
    import dataclasses
    config = dataclasses.replace(_config(), n_hot=3)
    params = dlrm_tpu.init_params(jax.random.key(2), config)
    rng = np.random.default_rng(2)
    k, b = 2, 16
    dense = jnp.asarray(rng.normal(size=(k, b, 13)).astype(np.float32))
    sparse = jnp.asarray(np.stack([np.stack(
        [rng.integers(i * (s // k), (i + 1) * (s // k), size=(b, 3))
         for s in config.table_sizes], axis=1)
        for i in range(k)]).astype(np.int32))
    labels = jnp.asarray((rng.random((k, b)) > 0.5).astype(np.float32))
    step = dlrm_tpu.make_jit_train_step(config, lr=0.1)
    blk = make_jit_train_block(config, lr=0.1, block=k)

    p_ref = jax.tree.map(jnp.copy, params)
    for i in range(k):
        p_ref, _ = step(p_ref, dense[i], sparse[i], labels[i])
    p_blk, _ = blk(jax.tree.map(jnp.copy, params), dense, sparse, labels)
    _leaves_allclose(p_ref, p_blk, rtol=1e-5, atol=1e-6)


def test_block_trains_on_skewed_synthetic():
    """Bounded staleness (repeated hot ids across micro-batches) still
    learns: AUC after training with block=4 is close to exact SGD's."""
    import dataclasses
    from dlrm_tpu.data import synthetic
    from dlrm_tpu.train.metrics import evaluate

    # threshold 0: every table on the gather/scatter path, so hot ids DO
    # repeat across micro-batches and the block forward reads stale rows
    config = dataclasses.replace(
        dlrm_tpu.tiny_config(num_tables=4, rows=128, feature_size=8),
        small_table_threshold=0)
    truth = synthetic.ClickthroughModel(config, seed=5)
    params = dlrm_tpu.init_params(jax.random.key(3), config)
    b, steps, k = 128, 120, 4

    def run_exact():
        p = jax.tree.map(jnp.copy, params)
        step = dlrm_tpu.make_jit_train_step(config, lr=0.1)
        for batch in truth.stream(b, steps, seed=11):
            p, _ = step(p, batch["dense"], batch["sparse"],
                        batch["labels"])
        return p

    def run_block():
        p = jax.tree.map(jnp.copy, params)
        blk = make_jit_train_block(config, lr=0.1, block=k)
        buf = []
        for batch in truth.stream(b, steps, seed=11):
            buf.append(batch)
            if len(buf) == k:
                p, _ = blk(p,
                           jnp.stack([x["dense"] for x in buf]),
                           jnp.stack([x["sparse"] for x in buf]),
                           jnp.stack([x["labels"] for x in buf]))
                buf = []
        return p

    ev = lambda p: evaluate(p, truth.stream(b, 10, seed=999), config)
    auc_exact = ev(run_exact())["auc"]
    auc_block = ev(run_block())["auc"]
    assert auc_exact > 0.6, auc_exact  # the task is learnable at all
    # bounded staleness costs at most a little AUC at this scale
    assert auc_block > auc_exact - 0.03, (auc_block, auc_exact)


@pytest.mark.parametrize("row_sharded", [False, True])
def test_sharded_block_disjoint_ids_equals_sequential(row_sharded):
    """Hybrid-parallel block: with no id repeats across micro-batches, a
    K-block == K sequential sharded steps (and exercises slot +
    row-sharded routing with the leading-K fold)."""
    from dlrm_tpu.parallel import embedding as pemb
    from dlrm_tpu.parallel.mesh import (batch_sharding, make_mesh,
                                        param_shardings)
    from dlrm_tpu.parallel.placement import plan_placement
    from dlrm_tpu.train.train import (make_sharded_train_block,
                                      make_sharded_train_step)

    config = dlrm_tpu.tiny_config(num_tables=4, rows=256, feature_size=8)
    params = dlrm_tpu.init_params(jax.random.key(4), config)
    rng = np.random.default_rng(4)
    k, b = 2, 32
    dense, sparse, labels = _batches(config, k, b, rng, disjoint=True)

    mesh = make_mesh(8)
    p = plan_placement(config.table_sizes, 8, pack=config.pack,
                       max_rows_per_shard=200 if row_sharded else None)
    if row_sharded:
        assert p.row_sharded
    sh_params = {
        "bottom": jax.tree.map(jnp.copy, params["bottom"]),
        "emb": jnp.asarray(pemb.shard_tables(params["emb"], p, config)),
        "top": jax.tree.map(jnp.copy, params["top"]),
    }
    shardings = param_shardings(mesh, sh_params)
    sh_params = jax.device_put(sh_params, shardings)
    bs = batch_sharding(mesh)
    from dlrm_tpu.parallel.mesh import block_batch_sharding
    bs2 = block_batch_sharding(mesh)

    step = make_sharded_train_step(config, 0.1, mesh, p)
    p_ref = jax.device_put(jax.tree.map(jnp.copy, sh_params), shardings)
    ref_losses = []
    for i in range(k):
        p_ref, loss = step(p_ref,
                           jax.device_put(dense[i], bs),
                           jax.device_put(sparse[i], bs),
                           jax.device_put(labels[i], bs))
        ref_losses.append(float(loss))

    blk = make_sharded_train_block(config, 0.1, mesh, p, block=k)
    p_blk, losses = blk(jax.device_put(jax.tree.map(jnp.copy, sh_params),
                                       shardings),
                        jax.device_put(dense, bs2),
                        jax.device_put(sparse, bs2),
                        jax.device_put(labels, bs2))
    np.testing.assert_allclose(np.asarray(losses), ref_losses, rtol=1e-5)
    _leaves_allclose(p_ref, p_blk, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scheduled,impl,unroll",
                         [(False, "dense_g", True), (True, "dense_g", True),
                          (False, "dedup", True), (True, "dedup", True),
                          (False, "dense_g", False),
                          (True, "dense_g", False)])
def test_adagrad_block_disjoint_equals_sequential(scheduled, impl, unroll):
    """Adagrad blocks (train_block_opt): with no id repeats across
    micro-batches, a K-block == K sequential train_step_opt calls (the
    one accumulator update per unique row uses exactly that row's single
    gradient and, under a schedule, its own micro-step's lr via the twin
    (g, lr_k*g) dedup payload)."""
    from dlrm_tpu.train.optim import make_schedule
    from dlrm_tpu.train.train import (init_opt_state,
                                      make_jit_train_block_opt,
                                      make_jit_train_step_opt)

    config = _config()
    params = dlrm_tpu.init_params(jax.random.key(8), config)
    rng = np.random.default_rng(8)
    k = 3
    dense, sparse, labels = _batches(config, k, 32, rng, disjoint=True)
    lr = (make_schedule(0.2, schedule="warmup_poly_decay", warmup_steps=2,
                        decay_start=2, decay_steps=10)
          if scheduled else 0.1)

    step = make_jit_train_step_opt(config, optimizer="adagrad", lr=lr)
    p_ref = jax.tree.map(jnp.copy, params)
    o_ref = init_opt_state(p_ref, config=config, optimizer="adagrad",
                           lr=lr)
    ref_losses = []
    for i in range(k):
        (p_ref, o_ref), loss = step(p_ref, o_ref, dense[i], sparse[i],
                                    labels[i])
        ref_losses.append(float(loss))

    blk = make_jit_train_block_opt(config, optimizer="adagrad", lr=lr,
                                   block=k, adagrad_impl=impl,
                                   unroll=unroll)
    p_blk = jax.tree.map(jnp.copy, params)
    o_blk = init_opt_state(p_blk, config=config, optimizer="adagrad",
                           lr=lr)
    (p_blk, o_blk), losses = blk(p_blk, o_blk, dense, sparse, labels)
    np.testing.assert_allclose(np.asarray(losses), ref_losses, rtol=1e-5)
    _leaves_allclose(p_ref, p_blk, rtol=1e-5, atol=1e-6)
    assert int(o_blk["count"]) == k
    # the Adagrad accumulator trajectories must agree too
    _leaves_allclose(o_ref["emb"], o_blk["emb"], rtol=1e-5, atol=1e-6)


def test_adagrad_block_scan_all_small_tables():
    """unroll=False must use the lax.scan path even when EVERY table is
    small (no big-table ids/drows to carry through the scan ys) — the
    compile-time win is the flag's whole point and must not silently
    fall back to the unrolled trace."""
    import dataclasses
    from dlrm_tpu.train.train import (init_opt_state,
                                      make_jit_train_block_opt,
                                      make_jit_train_step_opt)

    config = dataclasses.replace(
        dlrm_tpu.tiny_config(num_tables=3, rows=12, feature_size=8),
        small_table_threshold=64, table_sizes=(12, 9, 12))
    params = dlrm_tpu.init_params(jax.random.key(4), config)
    rng = np.random.default_rng(4)
    k = 3
    dense, sparse, labels = _batches(config, k, 16, rng, disjoint=True)

    step = make_jit_train_step_opt(config, optimizer="adagrad", lr=0.1)
    p_ref = jax.tree.map(jnp.copy, params)
    o_ref = init_opt_state(p_ref, config=config, optimizer="adagrad",
                           lr=0.1)
    ref_losses = []
    for i in range(k):
        (p_ref, o_ref), loss = step(p_ref, o_ref, dense[i], sparse[i],
                                    labels[i])
        ref_losses.append(float(loss))

    blk = make_jit_train_block_opt(config, optimizer="adagrad", lr=0.1,
                                   block=k, unroll=False)
    p_blk = jax.tree.map(jnp.copy, params)
    o_blk = init_opt_state(p_blk, config=config, optimizer="adagrad",
                           lr=0.1)
    # STRUCTURAL check: the lowered program must actually contain a scan
    # over micro-steps (numeric parity alone cannot distinguish scan
    # from a silent fallback to the unrolled trace)
    hlo = blk.lower(p_blk, o_blk, dense, sparse, labels).as_text()
    assert "while(" in hlo or "while " in hlo, \
        "unroll=False lowered without a scan/while loop"
    (p_blk, o_blk), losses = blk(p_blk, o_blk, dense, sparse, labels)
    np.testing.assert_allclose(np.asarray(losses), ref_losses, rtol=1e-5)
    _leaves_allclose(p_ref, p_blk, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["dedup", "dense_g"])
def test_adagrad_block_repeated_ids_dedups_before_accumulator(impl):
    """A row hit twice in one coalesced gradient gets ONE accumulator
    update with the SUMMED gradient — acc == (g1+g2)^2, not g1^2+g2^2 —
    and the weight step uses the summed gradient once (the dedup-then-
    apply contract the block relies on, tested at the optim layer for
    both the sort-based and dense-G implementations)."""
    from dlrm_tpu.train import optim as optim_lib
    from dlrm_tpu.train.optim import EmbAdagradState

    apply = {"dedup": optim_lib.apply_adagrad_chunked,
             "dense_g": optim_lib.apply_adagrad_dense_g}[impl]
    config = dlrm_tpu.tiny_config(num_tables=1, rows=64, feature_size=8)
    emb = tuple(jnp.zeros(s, jnp.float32) for s in config.emb_shapes)
    state = EmbAdagradState(acc=tuple(
        jnp.zeros(s, jnp.float32) for s in config.emb_shapes))
    ids = jnp.asarray([[3], [3], [7]], jnp.int32)          # row 3 twice
    g1, g2, g3 = 0.5, -0.2, 1.5
    d_rows = jnp.asarray([[[g1] * 8], [[g2] * 8], [[g3] * 8]], jnp.float32)
    lr = 0.1
    new_emb, new_state = jax.jit(lambda e, s: apply(
        e, s, ids, d_rows, lr, config))(emb, state)
    acc = np.asarray(new_state.acc[0]).reshape(-1, 8)
    w = np.asarray(new_emb[0]).reshape(-1, 8)
    gs = g1 + g2
    np.testing.assert_allclose(acc[3], gs * gs, rtol=1e-6)     # (g1+g2)^2
    np.testing.assert_allclose(acc[7], g3 * g3, rtol=1e-6)
    np.testing.assert_allclose(
        w[3], -lr * gs / np.sqrt(gs * gs + 1e-10), rtol=1e-5)
    np.testing.assert_allclose(
        w[7], -lr * g3 / np.sqrt(g3 * g3 + 1e-10), rtol=1e-5)
    assert np.all(w[[0, 1, 2, 4, 5, 6]] == 0)  # untouched rows


@pytest.mark.parametrize("row_sharded,unroll,scheduled",
                         [(False, True, False), (True, True, False),
                          (False, False, False), (False, True, True),
                          (True, False, True)])
def test_sharded_adagrad_block_disjoint_equals_sequential(row_sharded,
                                                          unroll,
                                                          scheduled):
    """Hybrid-parallel Adagrad block == K sequential sharded adagrad
    steps when ids are disjoint across micro-batches; ``scheduled``
    covers the twin (g, lr_k*g) payload riding the mesh collectives."""
    from dlrm_tpu.parallel import embedding as pemb
    from dlrm_tpu.parallel.mesh import (batch_sharding,
                                        block_batch_sharding, make_mesh,
                                        param_shardings)
    from dlrm_tpu.parallel.placement import plan_placement
    from dlrm_tpu.train.train import (init_sharded_opt_state,
                                      make_sharded_train_block_opt,
                                      make_sharded_train_step_opt)

    from dlrm_tpu.train.optim import make_schedule

    config = dlrm_tpu.tiny_config(num_tables=4, rows=256, feature_size=8)
    params = dlrm_tpu.init_params(jax.random.key(10), config)
    rng = np.random.default_rng(10)
    k, b = 2, 32
    dense, sparse, labels = _batches(config, k, b, rng, disjoint=True)
    lr = (make_schedule(0.2, schedule="warmup_poly_decay", warmup_steps=1,
                        decay_start=1, decay_steps=6)
          if scheduled else 0.1)

    mesh = make_mesh(8)
    p = plan_placement(config.table_sizes, 8, pack=config.pack,
                       max_rows_per_shard=200 if row_sharded else None)
    sh_params = {
        "bottom": jax.tree.map(jnp.copy, params["bottom"]),
        "emb": jnp.asarray(pemb.shard_tables(params["emb"], p, config)),
        "top": jax.tree.map(jnp.copy, params["top"]),
    }
    shardings = param_shardings(mesh, sh_params)
    sh_params = jax.device_put(sh_params, shardings)
    bs = batch_sharding(mesh)
    bs2 = block_batch_sharding(mesh)

    step = make_sharded_train_step_opt(config, optimizer="adagrad",
                                       lr=lr, mesh=mesh, placement=p)
    p_ref = jax.device_put(jax.tree.map(jnp.copy, sh_params), shardings)
    o_ref = init_sharded_opt_state(p_ref, config=config,
                                   optimizer="adagrad", lr=lr, mesh=mesh)
    ref_losses = []
    for i in range(k):
        (p_ref, o_ref), loss = step(p_ref, o_ref,
                                    jax.device_put(dense[i], bs),
                                    jax.device_put(sparse[i], bs),
                                    jax.device_put(labels[i], bs))
        ref_losses.append(float(loss))

    blk = make_sharded_train_block_opt(config, optimizer="adagrad",
                                       lr=lr, mesh=mesh, placement=p,
                                       block=k, unroll=unroll)
    p_blk = jax.device_put(jax.tree.map(jnp.copy, sh_params), shardings)
    o_blk = init_sharded_opt_state(p_blk, config=config,
                                   optimizer="adagrad", lr=lr, mesh=mesh)
    (p_blk, o_blk), losses = blk(p_blk, o_blk,
                                 jax.device_put(dense, bs2),
                                 jax.device_put(sparse, bs2),
                                 jax.device_put(labels, bs2))
    np.testing.assert_allclose(np.asarray(losses), ref_losses, rtol=1e-5)
    _leaves_allclose(p_ref, p_blk, rtol=1e-5, atol=1e-6)
    _leaves_allclose(o_ref["emb_acc"], o_blk["emb_acc"], rtol=1e-5,
                     atol=1e-6)


def test_block_scheduled_lr_disjoint_equals_sequential():
    """LR-schedule blocks: each micro-step's gradient is pre-scaled by its
    own lr; with disjoint ids a K-block == K sequential scheduled steps."""
    from dlrm_tpu.train.optim import make_schedule

    config = _config()
    params = dlrm_tpu.init_params(jax.random.key(6), config)
    rng = np.random.default_rng(6)
    k = 4
    dense, sparse, labels = _batches(config, k, 32, rng, disjoint=True)
    sched = make_schedule(0.2, schedule="warmup_poly_decay",
                          warmup_steps=2, decay_start=2, decay_steps=10)

    step = dlrm_tpu.make_jit_train_step(config, sched)
    p_ref = jax.tree.map(jnp.copy, params)
    for i in range(k):
        p_ref, _ = step(p_ref, dense[i], sparse[i], labels[i])

    blk = make_jit_train_block(config, sched, block=k)
    p_blk, _ = blk(jax.tree.map(jnp.copy, params), dense, sparse, labels)
    _leaves_allclose(p_ref, p_blk, rtol=1e-5, atol=1e-6)
