"""End-to-end trainability: AUC climbs on learnable skewed synthetic CTR.

The reference validates numerics against PyTorch but never demonstrates
learning; the north-star metric is Criteo AUC (BASELINE.json).  Without the
dataset, the strongest executable evidence is: on Zipf-skewed synthetic
clickthrough data with a planted ground truth, the full pipeline (mixed
lookup, compressed sparse updates, chunked storage) learns — held-out AUC
rises well above chance for both optimizers.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import dlrm_tpu
from dlrm_tpu.data.synthetic import ClickthroughModel
from dlrm_tpu.train.metrics import evaluate
from dlrm_tpu.train.train import init_opt_state, make_jit_train_step_opt


def _config():
    import dataclasses
    c = dlrm_tpu.tiny_config(num_tables=6, rows=64, feature_size=8)
    # mix of tiny (one-hot path) and bigger (gather path) tables
    return dataclasses.replace(
        c, table_sizes=(200, 12, 500, 40, 1000, 8),
        small_table_threshold=16, chunk_budget_bytes=16 << 10)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_auc_climbs_on_skewed_ctr(optimizer):
    config = _config()
    truth = ClickthroughModel(config, seed=3)
    params = dlrm_tpu.init_params(jax.random.key(0), config)
    lr = 0.1 if optimizer == "sgd" else 0.05
    step = make_jit_train_step_opt(config, optimizer=optimizer, lr=lr)
    opt_state = init_opt_state(params, config=config, optimizer=optimizer,
                               lr=lr)

    heldout = list(truth.stream(512, steps=4, seed=999))
    before = evaluate(params, heldout, config)
    for batch in truth.stream(256, steps=150, seed=1):
        (params, opt_state), loss = step(
            params, opt_state, jnp.asarray(batch["dense"]),
            jnp.asarray(batch["sparse"]), jnp.asarray(batch["labels"]))
    after = evaluate(params, heldout, config)
    assert np.isfinite(after["loss"])
    assert after["auc"] > max(before["auc"], 0.5) + 0.1, (before, after)
    assert after["loss"] < before["loss"]


def test_zipf_ids_are_skewed_and_in_range():
    config = _config()
    truth = ClickthroughModel(config, seed=0)
    rng = np.random.default_rng(0)
    b = truth.batch(rng, 4096)
    sparse = b["sparse"]
    for t, n in enumerate(config.table_sizes):
        col = sparse[:, t]
        assert col.min() >= 0 and col.max() < n
        # skew: the most frequent id covers a large fraction of the batch
        _, counts = np.unique(col, return_counts=True)
        assert counts.max() > 4096 * 0.1
    assert 0.1 < b["labels"].mean() < 0.9


def test_train_sync_every():
    """train(sync_every=N) syncs the loss every N steps: same final
    params as per-step sync, 1/N the losses/iteration_times entries,
    callback fires on synced steps only."""
    import dlrm_tpu
    from dlrm_tpu.data import synthetic

    c = dlrm_tpu.tiny_config(num_tables=3, rows=16, feature_size=8)
    params = dlrm_tpu.init_params(jax.random.key(2), c)
    data = list(synthetic.batch_stream(c, 16, 7, seed=4))

    r1 = dlrm_tpu.train(jax.tree.map(jnp.copy, params), iter(data),
                        config=c, lr=0.1)
    seen = []
    r3 = dlrm_tpu.train(jax.tree.map(jnp.copy, params), iter(data),
                        config=c, lr=0.1, sync_every=3,
                        callback=lambda i, l: seen.append(i))
    assert len(r1["losses"]) == 7
    # steps 3, 6 sync on cadence; step 7 is the final step (always synced)
    assert len(r3["losses"]) == 3 and seen == [2, 5, 6]
    # tail window (step 7) covers ONE step — its per-step time must be
    # divided by 1, not sync_every, so it lands in the same ballpark as
    # the full windows' per-step estimates (not ~3x smaller)
    assert len(r3["iteration_times"]) == 3
    assert all(t > 0 for t in r3["iteration_times"])
    np.testing.assert_allclose(r3["losses"], [r1["losses"][i]
                                              for i in (2, 5, 6)],
                               rtol=1e-6)
    for k in ("bottom", "top"):
        for a, b in zip(r1["params"][k], r3["params"][k]):
            np.testing.assert_array_equal(np.asarray(a["w"]),
                                          np.asarray(b["w"]))


def test_auc_climbs_at_fs128_bf16():
    """The fs=128 operating point LEARNS, not just runs: pack=1 chunked
    bf16 storage + rowwise adagrad (the bench.py fs=128 production combo)
    lifts held-out AUC on the planted-truth CTR task.  Also guards the
    wide-row lr regime (adagrad sign-steps saturate at fs=128 with the
    fs=16 lr)."""
    import dataclasses
    config = dataclasses.replace(
        dlrm_tpu.DLRMConfig(
            bottom_mlp_sizes=(13, 32, 128),
            top_mlp_sizes=(32, 1),
            feature_size=128,
            table_sizes=(200, 12, 500, 40, 1000, 8),
            small_table_threshold=16,
            chunk_budget_bytes=64 << 10,
            deep_chunk_budget_bytes=64 << 10),
        embedding_dtype=jnp.bfloat16)
    assert config.pack == 1 and config.num_chunks >= 2
    truth = ClickthroughModel(config, seed=3)
    params = dlrm_tpu.init_params(jax.random.key(0), config)
    lr = 0.005  # fs=128-appropriate (0.05 saturates the interaction)
    step = make_jit_train_step_opt(config, optimizer="rowwise_adagrad",
                                   lr=lr)
    opt_state = init_opt_state(params, config=config,
                               optimizer="rowwise_adagrad", lr=lr)

    heldout = list(truth.stream(512, steps=4, seed=999))
    before = evaluate(params, heldout, config)
    for batch in truth.stream(256, steps=150, seed=1):
        (params, opt_state), loss = step(
            params, opt_state, jnp.asarray(batch["dense"]),
            jnp.asarray(batch["sparse"]), jnp.asarray(batch["labels"]))
    after = evaluate(params, heldout, config)
    assert np.isfinite(after["loss"])
    assert after["auc"] > max(before["auc"], 0.5) + 0.1, (before, after)
    assert after["loss"] < before["loss"]


def test_remat_is_the_identity():
    """config.remat (jax.checkpoint around the dense tower) must be
    bit-identical in loss AND updated params to the non-remat step —
    single-chip and sharded."""
    import dataclasses
    from dlrm_tpu.train.train import make_jit_train_step

    config = _config()
    config_r = dataclasses.replace(config, remat=True)
    params = dlrm_tpu.init_params(jax.random.key(7), config)
    rng = np.random.default_rng(5)
    b = 64
    dense = jnp.asarray(rng.normal(size=(b, 13)).astype(np.float32))
    sparse = jnp.asarray(np.stack(
        [rng.integers(0, s, size=b) for s in config.table_sizes],
        axis=1).astype(np.int32))
    labels = jnp.asarray((rng.random(b) > 0.5).astype(np.float32))

    p1, l1 = make_jit_train_step(config, lr=0.1)(
        jax.tree.map(jnp.copy, params), dense, sparse, labels)
    p2, l2 = make_jit_train_step(config_r, lr=0.1)(
        jax.tree.map(jnp.copy, params), dense, sparse, labels)
    assert float(l1) == float(l2)
    for a, b_ in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))

    # sharded step goes through the same _loss_from_pooled closure
    from dlrm_tpu.parallel import embedding as pemb
    from dlrm_tpu.parallel.mesh import (batch_sharding, make_mesh,
                                        param_shardings)
    from dlrm_tpu.parallel.placement import plan_placement
    from dlrm_tpu.train.train import make_sharded_train_step
    mesh = make_mesh(4)
    p = plan_placement(config.table_sizes, 4, pack=config.pack)
    bs = batch_sharding(mesh)

    def sharded_loss(cfg):
        sh = {"bottom": jax.tree.map(jnp.copy, params["bottom"]),
              "emb": pemb.shard_tables(params["emb"], p, cfg),
              "top": jax.tree.map(jnp.copy, params["top"])}
        sh = jax.device_put(sh, param_shardings(mesh, sh))
        step = make_sharded_train_step(cfg, 0.1, mesh, p)
        new, loss = step(sh, jax.device_put(dense, bs),
                         jax.device_put(sparse, bs),
                         jax.device_put(labels, bs))
        return float(loss), pemb.unshard_tables(np.asarray(new["emb"]),
                                                p, cfg)

    (ls1, e1), (ls2, e2) = sharded_loss(config), sharded_loss(config_r)
    assert ls1 == ls2
    np.testing.assert_array_equal(e1, e2)
