"""Global-norm gradient clipping (--grad-clip-norm).

Semantics: one global norm over everything the step's autodiff produced
(optim.clip_by_global_norm docstring), per-step optimizer paths only.
A measured scope note these tests pin: clipping bounds SGD steps
directly (lr*g), but Adagrad-family sparse steps (g*rsqrt(acc)) are
invariant to gradient scale — clipping is NOT a substitute for lr
choice there (at fs=128, lr=0.05 saturates and lr=0.002 trains).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dlrm_tpu
from dlrm_tpu.train import optim
from dlrm_tpu.train.train import init_opt_state, make_jit_train_step_opt


def _config():
    return dataclasses.replace(
        dlrm_tpu.tiny_config(num_tables=6, rows=64, feature_size=8),
        table_sizes=(200, 12, 500, 40, 1000, 8),
        small_table_threshold=16, chunk_budget_bytes=16 << 10)


def _batch(rng, config, b=64):
    dense = jnp.asarray(rng.normal(size=(b, 13)).astype(np.float32))
    sparse = jnp.asarray(np.stack(
        [rng.integers(0, s, size=b) for s in config.table_sizes],
        axis=1).astype(np.int32))
    labels = jnp.asarray((rng.random(b) > 0.5).astype(np.float32))
    return dense, sparse, labels


def test_clip_by_global_norm_unit(rng):
    g = {"a": jnp.asarray(rng.normal(size=(7, 3)).astype(np.float32)),
         "b": (jnp.asarray(rng.normal(size=(11,)).astype(np.float32)),)}
    flat = np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree.leaves(g)])
    gn = float(np.linalg.norm(flat))
    # above the max: scaled to exactly max_norm
    clipped, got_norm = optim.clip_by_global_norm(gn / 3, g)
    assert abs(float(got_norm) - gn) < 1e-5 * gn
    cflat = np.concatenate([np.asarray(x).ravel()
                            for x in jax.tree.leaves(clipped)])
    np.testing.assert_allclose(np.linalg.norm(cflat), gn / 3, rtol=1e-5)
    np.testing.assert_allclose(cflat, flat / 3, rtol=1e-5)
    # below the max: identity
    same, _ = optim.clip_by_global_norm(gn * 3, g)
    for x, y in zip(jax.tree.leaves(same), jax.tree.leaves(g)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad",
                                       "rowwise_adagrad"])
def test_huge_clip_is_identity_tiny_clip_bounds(optimizer, rng):
    """clip=1e9 reproduces the unclipped step bit-for-bit; a tiny clip
    bounds the parameter movement by lr * max_norm (SGD exactly)."""
    config = _config()
    params = dlrm_tpu.init_params(jax.random.key(1), config)
    d, s, l = _batch(rng, config)
    lr = 0.1

    def run(clip):
        p = jax.tree.map(jnp.copy, params)
        o = init_opt_state(p, config=config, optimizer=optimizer, lr=lr)
        step = make_jit_train_step_opt(config, optimizer=optimizer,
                                       lr=lr, grad_clip_norm=clip)
        (p2, _), loss = step(p, o, d, s, l)
        return p2, float(loss)

    base, loss0 = run(None)
    same, loss1 = run(1e9)
    assert loss0 == loss1
    for x, y in zip(jax.tree.leaves(base), jax.tree.leaves(same)):
        # the no-op clip (scale == 1.0 exactly) is mathematically the
        # identity, but the extra multiply changes XLA's fusion of the
        # downstream reductions (rowwise's mean(g^2)) — compare to float
        # tolerance, not bitwise
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=3e-6, atol=1e-7)
    small, _ = run(1e-3)
    if optimizer == "sgd":
        # ||delta|| = lr * ||clipped grad|| <= lr * max_norm
        delta = np.concatenate(
            [(np.asarray(a) - np.asarray(b)).ravel()
             for a, b in zip(jax.tree.leaves(small),
                             jax.tree.leaves(params))])
        assert np.linalg.norm(delta) <= lr * 1e-3 * 1.01
    else:
        # adagrad normalizes by rsqrt(acc); just require it moved less
        # than unclipped
        d_small = sum(float(np.abs(np.asarray(a) - np.asarray(b)).sum())
                      for a, b in zip(jax.tree.leaves(small),
                                      jax.tree.leaves(params)))
        d_base = sum(float(np.abs(np.asarray(a) - np.asarray(b)).sum())
                     for a, b in zip(jax.tree.leaves(base),
                                     jax.tree.leaves(params)))
        assert 0 < d_small < d_base


def test_sharded_clip_identity_and_bound(rng):
    from dlrm_tpu.parallel import embedding as pemb
    from dlrm_tpu.parallel.mesh import (batch_sharding, make_mesh,
                                        param_shardings)
    from dlrm_tpu.parallel.placement import plan_placement
    from dlrm_tpu.train.train import (init_sharded_opt_state,
                                      make_sharded_train_step_opt)

    config = dataclasses.replace(_config(), packed_tables=False)
    params = dlrm_tpu.init_params(jax.random.key(2), config)
    mesh = make_mesh(8)
    p = plan_placement(config.table_sizes, 8, pack=1)
    d, s, l = _batch(rng, config)
    bs = batch_sharding(mesh)
    d, s, l = (jax.device_put(x, bs) for x in (d, s, l))

    def run(clip):
        sh = {"bottom": jax.tree.map(jnp.copy, params["bottom"]),
              "emb": pemb.shard_tables(np.asarray(params["emb"]), p,
                                       config),
              "top": jax.tree.map(jnp.copy, params["top"])}
        sh = jax.device_put(sh, param_shardings(mesh, sh))
        o = init_sharded_opt_state(sh, config=config,
                                   optimizer="adagrad", lr=0.1,
                                   mesh=mesh)
        step = make_sharded_train_step_opt(
            config, optimizer="adagrad", lr=0.1, mesh=mesh, placement=p,
            grad_clip_norm=clip)
        (p2, _), loss = step(sh, o, d, s, l)
        return np.asarray(p2["emb"]), float(loss)

    e_base, l0 = run(None)
    e_same, l1 = run(1e9)
    assert l0 == l1
    np.testing.assert_array_equal(e_base, e_same)
    e_small, _ = run(1e-3)
    sh0 = pemb.shard_tables(np.asarray(params["emb"]), p, config)
    assert 0 < np.abs(e_small - sh0).sum() < np.abs(e_base - sh0).sum()


def test_clip_stabilizes_hot_sgd_but_not_adagrad():
    """SGD at an over-hot lr blows into the BCE clamp regime without
    clipping and trains normally with a tight clip (step = lr*clipped
    grad).  Adagrad's sparse step is gradient-scale INVARIANT
    (g*rsqrt(acc)), so the same clip changes nothing there — the fix is
    lr, and this pins that scope honestly."""
    from dlrm_tpu.data.synthetic import ClickthroughModel

    config = _config()
    truth = ClickthroughModel(config, seed=3)

    def final_loss(optimizer, lr, clip):
        params = dlrm_tpu.init_params(jax.random.key(0), config)
        opt = init_opt_state(params, config=config, optimizer=optimizer,
                             lr=lr)
        step = make_jit_train_step_opt(config, optimizer=optimizer,
                                       lr=lr, grad_clip_norm=clip)
        for batch in truth.stream(256, steps=30, seed=1):
            (params, opt), loss = step(params, opt,
                                       jnp.asarray(batch["dense"]),
                                       jnp.asarray(batch["sparse"]),
                                       jnp.asarray(batch["labels"]))
        return float(loss)

    hot = final_loss("sgd", 60.0, None)
    clipped = final_loss("sgd", 60.0, 0.05)
    assert hot > 10.0, hot  # the blowup the clip exists for
    assert np.isfinite(clipped) and clipped < 2.5, (clipped, hot)
    # the invariance: clipping does NOT rescue a hot Adagrad lr
    ada_hot = final_loss("rowwise_adagrad", 2.0, None)
    ada_clip = final_loss("rowwise_adagrad", 2.0, 0.1)
    assert ada_hot > 10.0 and ada_clip > 10.0, (ada_hot, ada_clip)


def _disjoint_batches(config, k, b, rng):
    """Per-table id spaces partitioned across the K micro-batches so no
    row is read after being written within a block (the block oracle
    precondition, tests/test_block_update.py)."""
    dense = rng.normal(size=(k, b, 13)).astype(np.float32)
    sparse = np.stack([np.stack(
        [rng.integers(i * (s // k), (i + 1) * (s // k), size=b)
         for s in config.table_sizes], axis=1)
        for i in range(k)]).astype(np.int32)
    labels = (rng.random((k, b)) > 0.5).astype(np.float32)
    return jnp.asarray(dense), jnp.asarray(sparse), jnp.asarray(labels)


def test_sgd_block_clip_matches_sequential_clipped_steps(rng):
    """Round-5 extension: the clip now lives inside the block paths too,
    applied per MICRO-step over the same pytree the per-step path clips —
    with disjoint ids a clipped K-block equals K sequential clipped
    per-step calls."""
    from dlrm_tpu.train.train import make_jit_train_block

    config = _config()
    k, clip = 4, 5e-2  # tight enough that every micro-step clips
    params = dlrm_tpu.init_params(jax.random.key(3), config)
    d, s, l = _disjoint_batches(config, k, 32, rng)

    blk = make_jit_train_block(config, lr=0.1, block=k,
                               grad_clip_norm=clip)
    p_blk, losses = blk(jax.tree.map(jnp.copy, params), d, s, l)

    # sequential oracle: sgd + clip routes through the opt-state step
    p_seq = jax.tree.map(jnp.copy, params)
    o = init_opt_state(p_seq, config=config, optimizer="sgd", lr=0.1)
    step = make_jit_train_step_opt(config, optimizer="sgd", lr=0.1,
                                   grad_clip_norm=clip)
    for i in range(k):
        (p_seq, o), loss = step(p_seq, o, d[i], s[i], l[i])
        np.testing.assert_allclose(float(losses[i]), float(loss),
                                   rtol=1e-5)
    for x, y in zip(jax.tree.leaves(p_blk), jax.tree.leaves(p_seq)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=2e-5, atol=1e-6)
    # and the clip actually engaged: an unclipped block lands elsewhere
    blk0 = make_jit_train_block(config, lr=0.1, block=k)
    p0, _ = blk0(jax.tree.map(jnp.copy, params), d, s, l)
    moved = sum(float(np.abs(np.asarray(a) - np.asarray(b)).sum())
                for a, b in zip(jax.tree.leaves(p0),
                                jax.tree.leaves(p_blk)))
    assert moved > 0


@pytest.mark.parametrize("unroll", [True, False])
def test_adagrad_block_clip_matches_sequential_clipped_steps(unroll, rng):
    from dlrm_tpu.train.train import make_jit_train_block_opt

    config = _config()
    k, clip = 2, 5e-2
    params = dlrm_tpu.init_params(jax.random.key(4), config)
    d, s, l = _disjoint_batches(config, k, 32, rng)

    p_blk = jax.tree.map(jnp.copy, params)
    o_blk = init_opt_state(p_blk, config=config, optimizer="adagrad",
                           lr=0.1)
    blk = make_jit_train_block_opt(config, optimizer="adagrad", lr=0.1,
                                   block=k, adagrad_impl="dense_g",
                                   unroll=unroll, grad_clip_norm=clip)
    (p_blk, o_blk), losses = blk(p_blk, o_blk, d, s, l)

    p_seq = jax.tree.map(jnp.copy, params)
    o_seq = init_opt_state(p_seq, config=config, optimizer="adagrad",
                           lr=0.1)
    step = make_jit_train_step_opt(config, optimizer="adagrad", lr=0.1,
                                   emb_impl="dense_g",
                                   grad_clip_norm=clip)
    for i in range(k):
        (p_seq, o_seq), loss = step(p_seq, o_seq, d[i], s[i], l[i])
        np.testing.assert_allclose(float(losses[i]), float(loss),
                                   rtol=1e-5)
    for x, y in zip(jax.tree.leaves(p_blk), jax.tree.leaves(p_seq)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=2e-5, atol=1e-6)


def test_grad_clip_cli(tmp_path, capsys):
    from dlrm_tpu import run as cli
    from dlrm_tpu.data import synthetic

    (tmp_path / "day.txt").write_text(
        "".join(synthetic.criteo_text_lines(64, seed=51)))
    out = str(tmp_path / "d.bin")

    def run(argv):
        rc = cli.main(argv)
        txt = capsys.readouterr().out.strip().splitlines()
        return rc, json.loads(txt[-1])

    run(["preprocess", str(tmp_path / "day.txt"), "--out", out])
    sizes = ",".join("1000" for _ in range(26))
    common = ["--config", "tiny", "--table-sizes", sizes,
              "--batch-size", "16", "--data", out, "--log-every", "2"]
    # sgd + clip routes through the opt-state step; adagrad + clip too
    for extra in (["--grad-clip-norm", "1.0"],
                  ["--optimizer", "adagrad", "--lr", "0.05",
                   "--grad-clip-norm", "1.0"]):
        rc, res = run(["train", *common, "--sharded", "false", *extra])
        assert rc == 0 and np.isfinite(res["final_loss"])
    # round 5: the block paths clip per micro-step — the combination runs
    rc, res = run(["train", *common, "--sharded", "false",
                   "--grad-clip-norm", "1.0", "--update-interval", "2"])
    assert rc == 0 and np.isfinite(res["final_loss"])
    # the two-tier step still refuses loudly
    with pytest.raises(SystemExit, match="block paths"):
        cli.main(["train", *common, "--sharded", "false",
                  "--grad-clip-norm", "1.0", "--hbm-budget-gb", "0.0001"])
    capsys.readouterr()
