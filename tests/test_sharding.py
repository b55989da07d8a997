"""Sharded-vs-single-device parity for the hybrid embedding path.

The reference has no distributed tests (single-node code, SURVEY.md §4);
this framework's key new invariant is: the shard_map all-to-all lookup
and sparse update over an N-device mesh must be numerically identical to the
single-device stacked-table path.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import dlrm_tpu
from dlrm_tpu.ops import embedding as emb_ops
from dlrm_tpu.parallel import embedding as pemb
from dlrm_tpu.parallel.mesh import batch_sharding, make_mesh, param_shardings
from dlrm_tpu.parallel.placement import plan_placement
from dlrm_tpu.train.train import make_sharded_train_step, train_step


def _random_batch(rng, config, b):
    dense = rng.normal(size=(b, config.num_dense)).astype(np.float32)
    if config.n_hot == 1:
        sparse = np.stack(
            [rng.integers(0, s, size=b) for s in config.table_sizes],
            axis=1).astype(np.int32)
    else:
        sparse = np.stack(
            [rng.integers(0, s, size=(b, config.n_hot))
             for s in config.table_sizes], axis=1).astype(np.int32)
    labels = (rng.random(b) > 0.5).astype(np.float32)
    return dense, sparse, labels


@pytest.mark.parametrize("num_tables,num_shards", [(7, 8), (26, 8), (5, 4)])
def test_placement_covers_all_tables(num_tables, num_shards, rng):
    sizes = [int(rng.integers(4, 1000)) for _ in range(num_tables)]
    p = plan_placement(sizes, num_shards)
    seen = set()
    for d in range(num_shards):
        for s in range(p.slots_per_shard):
            if p.slot_valid[d, s]:
                t = int(p.slot_tables[d, s])
                assert t not in seen
                seen.add(t)
                assert p.table_shard[t] == d and p.table_slot[t] == s
    assert seen == set(range(num_tables))
    assert p.local_rows >= max(
        sum(sizes[t] for t in range(num_tables) if p.table_shard[t] == d)
        for d in range(num_shards)) + 1


@pytest.mark.parametrize("pack", [1, 16])
def test_shard_unshard_roundtrip(pack, rng):
    config = dlrm_tpu.tiny_config(num_tables=5, rows=16, feature_size=8)
    stacked = rng.normal(size=(config.total_rows,
                               config.feature_size)).astype(np.float32)
    p = plan_placement(config.table_sizes, 4, pack=pack)
    sharded = pemb.shard_tables(stacked, p, config)
    assert sharded.shape[-1] == config.feature_size * pack
    back = pemb.unshard_tables(sharded, p, config)
    np.testing.assert_array_equal(back, stacked)


@pytest.mark.parametrize("n_hot,num_tables,packed",
                         [(1, 7, False), (1, 26, False), (3, 7, False),
                          (1, 5, False), (1, 26, True), (3, 7, True)])
def test_sharded_lookup_matches_single_device(n_hot, num_tables, packed,
                                              rng):
    config = dlrm_tpu.tiny_config(num_tables=num_tables, rows=64,
                                  feature_size=8, n_hot=n_hot)
    mesh = make_mesh(8)
    p = plan_placement(config.table_sizes, 8,
                       pack=config.pack if packed else 1)
    stacked = rng.normal(size=(config.total_rows,
                               config.feature_size)).astype(np.float32)
    _, sparse, _ = _random_batch(rng, config, 32)

    expected = emb_ops.lookup(jnp.asarray(stacked), jnp.asarray(sparse),
                              config.table_offsets)

    emb_sh = jax.device_put(pemb.shard_tables(stacked, p, config),
                            jax.NamedSharding(mesh, jax.P("d")))
    ids = jax.device_put(jnp.asarray(sparse), batch_sharding(mesh))
    got = jax.jit(lambda e, i: pemb.sharded_lookup(
        e, i, mesh=mesh, placement=p, axis="d"))(emb_sh, ids)
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n_hot,packed",
                         [(1, False), (3, False), (1, True), (3, True)])
def test_sharded_train_step_matches_single_device(n_hot, packed, rng):
    config = dlrm_tpu.tiny_config(num_tables=7, rows=50, feature_size=8,
                                  n_hot=n_hot)
    params = dlrm_tpu.init_params(jax.random.key(7), config)
    dense, sparse, labels = _random_batch(rng, config, 32)
    lr = 0.5

    # single-device oracle
    ref_params, ref_loss = jax.jit(
        lambda p, d, s, l: train_step(p, d, s, l, config=config, lr=lr)
    )(params, jnp.asarray(dense), jnp.asarray(sparse), jnp.asarray(labels))

    # 8-way hybrid
    mesh = make_mesh(8)
    p = plan_placement(config.table_sizes, 8,
                       pack=config.pack if packed else 1)
    sh_params = {
        "bottom": params["bottom"],
        "emb": pemb.shard_tables(params["emb"], p, config),
        "top": params["top"],
    }
    sh_params = jax.device_put(sh_params, param_shardings(mesh, sh_params))
    bs = batch_sharding(mesh)
    step = make_sharded_train_step(config, lr, mesh, p)
    new_params, loss = step(sh_params,
                            jax.device_put(jnp.asarray(dense), bs),
                            jax.device_put(jnp.asarray(sparse), bs),
                            jax.device_put(jnp.asarray(labels), bs))

    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-6)
    got_emb = pemb.unshard_tables(np.asarray(new_params["emb"]), p, config)
    np.testing.assert_allclose(
        got_emb,
        emb_ops.unpack_tables(
            jax.tree.map(np.asarray, ref_params["emb"]), config),
        atol=1e-5, rtol=1e-5)
    for side in ("bottom", "top"):
        for i, layer in enumerate(new_params[side]):
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    np.asarray(layer[k]),
                    np.asarray(ref_params[side][i][k]),
                    atol=1e-5, rtol=1e-5, err_msg=f"{side}[{i}].{k}")


@pytest.mark.parametrize("pack", [1, 16])
def test_shard_unshard_roundtrip_row_sharded(pack, rng):
    config = dlrm_tpu.tiny_config(num_tables=5, rows=16, feature_size=8)
    import dataclasses
    config = dataclasses.replace(config, table_sizes=(16, 100, 7, 64, 33))
    stacked = rng.normal(size=(config.total_rows,
                               config.feature_size)).astype(np.float32)
    p = plan_placement(config.table_sizes, 4, pack=pack,
                       max_rows_per_shard=40)
    assert set(p.row_sharded) == {1, 3}
    sharded = pemb.shard_tables(stacked, p, config)
    back = pemb.unshard_tables(sharded, p, config)
    np.testing.assert_array_equal(back, stacked)


@pytest.mark.parametrize("n_hot,packed", [(1, False), (3, False),
                                          (1, True), (3, True)])
def test_row_sharded_lookup_matches_single_device(n_hot, packed, rng):
    """Tables too big for one shard: masked gather + psum_scatter path."""
    import dataclasses
    config = dlrm_tpu.tiny_config(num_tables=6, rows=64, feature_size=8,
                                  n_hot=n_hot)
    config = dataclasses.replace(
        config, table_sizes=(64, 400, 12, 300, 64, 50))
    mesh = make_mesh(8)
    p = plan_placement(config.table_sizes, 8,
                       pack=config.pack if packed else 1,
                       max_rows_per_shard=100)
    assert set(p.row_sharded) == {1, 3}
    stacked = rng.normal(size=(config.total_rows,
                               config.feature_size)).astype(np.float32)
    _, sparse, _ = _random_batch(rng, config, 32)

    expected = emb_ops.lookup(jnp.asarray(stacked), jnp.asarray(sparse),
                              config.table_offsets)
    emb_sh = jax.device_put(pemb.shard_tables(stacked, p, config),
                            jax.NamedSharding(mesh, jax.P("d")))
    ids = jax.device_put(jnp.asarray(sparse), batch_sharding(mesh))
    got = jax.jit(lambda e, i: pemb.sharded_lookup(
        e, i, mesh=mesh, placement=p, axis="d"))(emb_sh, ids)
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n_hot,packed", [(1, False), (2, True)])
def test_row_sharded_train_step_matches_single_device(n_hot, packed, rng):
    import dataclasses
    config = dlrm_tpu.tiny_config(num_tables=6, rows=64, feature_size=8,
                                  n_hot=n_hot)
    config = dataclasses.replace(
        config, table_sizes=(64, 400, 12, 300, 64, 50))
    params = dlrm_tpu.init_params(jax.random.key(7), config)
    dense, sparse, labels = _random_batch(rng, config, 32)
    # duplicate ids stress the masked scatter path
    sparse[1] = sparse[0]
    lr = 0.5

    ref_params, ref_loss = jax.jit(
        lambda p, d, s, l: train_step(p, d, s, l, config=config, lr=lr)
    )(params, jnp.asarray(dense), jnp.asarray(sparse), jnp.asarray(labels))

    mesh = make_mesh(8)
    p = plan_placement(config.table_sizes, 8,
                       pack=config.pack if packed else 1,
                       max_rows_per_shard=100)
    assert p.row_sharded
    sh_params = {
        "bottom": params["bottom"],
        "emb": pemb.shard_tables(params["emb"], p, config),
        "top": params["top"],
    }
    sh_params = jax.device_put(sh_params, param_shardings(mesh, sh_params))
    bs = batch_sharding(mesh)
    step = make_sharded_train_step(config, lr, mesh, p)
    new_params, loss = step(sh_params,
                            jax.device_put(jnp.asarray(dense), bs),
                            jax.device_put(jnp.asarray(sparse), bs),
                            jax.device_put(jnp.asarray(labels), bs))
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-6)
    got_emb = pemb.unshard_tables(np.asarray(new_params["emb"]), p, config)
    np.testing.assert_allclose(
        got_emb,
        emb_ops.unpack_tables(
            jax.tree.map(np.asarray, ref_params["emb"]), config),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_hot", [1, 2])
def test_col_sharded_train_step_matches_single_device(n_hot, rng):
    """Column-sharded tables (feature-dim slices on every shard; the
    fs>=128 / pack==1 regime) + slot + row-sharded tables in ONE step."""
    import dataclasses
    config = dlrm_tpu.tiny_config(num_tables=6, rows=64, feature_size=8,
                                  n_hot=n_hot)
    config = dataclasses.replace(
        config, table_sizes=(64, 400, 12, 300, 64, 50),
        packed_tables=False)  # column sharding requires pack == 1
    params = dlrm_tpu.init_params(jax.random.key(7), config)
    dense, sparse, labels = _random_batch(rng, config, 32)
    sparse[1] = sparse[0]  # duplicate ids
    lr = 0.5

    ref_params, ref_loss = jax.jit(
        lambda p, d, s, l: train_step(p, d, s, l, config=config, lr=lr)
    )(params, jnp.asarray(dense), jnp.asarray(sparse), jnp.asarray(labels))

    mesh = make_mesh(8)
    p = plan_placement(config.table_sizes, 8, pack=1,
                       max_rows_per_shard=350,
                       col_sharded_tables=(3, 5))
    assert p.col_sharded == (3, 5) and p.row_sharded == (1,)
    emb_np = np.asarray(params["emb"])
    sh_params = {
        "bottom": params["bottom"],
        "emb": pemb.shard_tables(emb_np, p, config),
        "emb_cs": pemb.shard_col_tables(emb_np, p, config),
        "top": params["top"],
    }
    sh_params = jax.device_put(sh_params, param_shardings(mesh, sh_params))
    bs = batch_sharding(mesh)
    step = make_sharded_train_step(config, lr, mesh, p)
    new_params, loss = step(sh_params,
                            jax.device_put(jnp.asarray(dense), bs),
                            jax.device_put(jnp.asarray(sparse), bs),
                            jax.device_put(jnp.asarray(labels), bs))
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-6)
    # non-col tables via unshard; col tables via their own converter
    got_emb = pemb.unshard_tables(np.asarray(new_params["emb"]), p, config)
    want_emb = np.asarray(ref_params["emb"])
    for t in range(config.num_tables):
        off = config.table_offsets[t]
        rows = config.table_sizes[t]
        if t in p.col_sharded:
            continue
        np.testing.assert_allclose(got_emb[off:off + rows],
                                   want_emb[off:off + rows],
                                   atol=1e-5, rtol=1e-5, err_msg=f"t={t}")
    got_cs = pemb.unshard_col_tables(
        [np.asarray(a) for a in new_params["emb_cs"]], p)
    for k, t in enumerate(p.col_sharded):
        off = config.table_offsets[t]
        rows = config.table_sizes[t]
        np.testing.assert_allclose(got_cs[k], want_emb[off:off + rows],
                                   atol=1e-5, rtol=1e-5, err_msg=f"cs t={t}")


def test_terabyte_scale_placement_plans():
    """The MLPerf/Terabyte scale story is pure planning math — verify the
    placement handles 292.8M-row tables (criteo.jl:379-406) without
    materializing anything: row-shard everything over max_rows_per_shard,
    host-place the biggest, per-shard row counts cover every logical row."""
    config = dlrm_tpu.terabyte_config(feature_size=128)
    assert max(config.table_sizes) == 292_775_614
    n = 64  # a pod-slice worth of chips
    biggest = sorted(range(config.num_tables),
                     key=lambda t: -config.table_sizes[t])[:4]
    p = plan_placement(config.table_sizes, n, pack=config.pack,
                       max_rows_per_shard=8_000_000,
                       host_tables=tuple(biggest))
    assert set(p.host_row_sharded) == set(biggest)
    for k, t in enumerate(p.row_sharded):
        # every logical row of a row-sharded table is covered by the
        # per-shard contiguous blocks
        assert p.rs_rows_per_shard[k] * n >= config.table_sizes[t]
    # device-stack HBM per shard stays under a v5p-class budget
    w = config.feature_size * p.pack
    dev_bytes = p.local_rows * w * 4
    assert dev_bytes < 8 << 30, f"{dev_bytes/2**30:.1f} GiB per shard"
    # host stack bounded too (host RAM budget per chip)
    host_bytes = p.host_local_rows * w * 4
    assert host_bytes < 16 << 30, f"{host_bytes/2**30:.1f} GiB host"
    # unsharded slot tables actually FIT: per-table packed rows within
    # the planner's per-shard cap, and each shard's slot occupancy within
    # the shared local_rows extent (a real capacity check, not just
    # "some shard was assigned")
    pack = p.pack
    occupancy = [0] * n
    for t in p.slot_table_list:
        prows = -(-config.table_sizes[t] // pack)
        assert prows * pack <= 8_000_000  # the planner's cap above
        occupancy[p.table_shard[t]] += prows
    for used in occupancy:
        assert used <= p.local_rows


@pytest.mark.parametrize("n_hot", [1, 2])
def test_all_placement_kinds_in_one_step(n_hot, rng):
    """Capstone: slot + device row-sharded + HOST-resident row-sharded +
    column-sharded tables in a single hybrid-parallel SGD step, equal to
    the single-device step (and the on-mesh sharded_evaluate forward
    equals the single-device forward)."""
    import dataclasses
    from dlrm_tpu.parallel import host_tier as ht
    from dlrm_tpu.train.metrics import evaluate, sharded_evaluate

    if not ht.host_memory_supported():
        pytest.skip("no pinned_host memory space")
    config = dlrm_tpu.tiny_config(num_tables=7, rows=64, feature_size=8,
                                  n_hot=n_hot)
    config = dataclasses.replace(
        config, table_sizes=(64, 400, 12, 300, 64, 50, 500),
        packed_tables=False)  # column sharding requires pack == 1
    params = dlrm_tpu.init_params(jax.random.key(11), config)
    dense, sparse, labels = _random_batch(rng, config, 32)
    sparse[1] = sparse[0]  # duplicate ids
    lr = 0.5

    ref_params, ref_loss = jax.jit(
        lambda p, d, s, l: train_step(p, d, s, l, config=config, lr=lr)
    )(jax.tree.map(jnp.copy, params), jnp.asarray(dense),
      jnp.asarray(sparse), jnp.asarray(labels))

    mesh = make_mesh(8)
    # 1 -> device row-sharded (rows > 350), 6 -> host-resident,
    # 3, 5 -> column-sharded, rest slot-placed
    p = plan_placement(config.table_sizes, 8, pack=1,
                       max_rows_per_shard=350,
                       col_sharded_tables=(3, 5), host_tables=(6,))
    assert p.row_sharded == (1, 6) and p.host_row_sharded == (6,)
    assert p.col_sharded == (3, 5)
    emb_np = np.asarray(params["emb"])
    sh_params = {
        "bottom": jax.tree.map(jnp.copy, params["bottom"]),
        "emb": pemb.shard_tables(emb_np, p, config),
        "emb_h": pemb.shard_host_tables(emb_np, p, config),
        "emb_cs": pemb.shard_col_tables(emb_np, p, config),
        "top": jax.tree.map(jnp.copy, params["top"]),
    }
    sh_params = jax.device_put(sh_params, param_shardings(mesh, sh_params))
    bs = batch_sharding(mesh)
    step = make_sharded_train_step(config, lr, mesh, p)
    new_params, loss = step(sh_params,
                            jax.device_put(jnp.asarray(dense), bs),
                            jax.device_put(jnp.asarray(sparse), bs),
                            jax.device_put(jnp.asarray(labels), bs))
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-6)

    got = pemb.unshard_tables(np.asarray(new_params["emb"]), p, config,
                              host=np.asarray(new_params["emb_h"]))
    cs_tabs = pemb.unshard_col_tables(
        [np.asarray(a) for a in new_params["emb_cs"]], p)
    for k, t in enumerate(p.col_sharded):
        off = config.table_offsets[t]
        got[off:off + config.table_sizes[t]] = cs_tabs[k]
    np.testing.assert_allclose(got, np.asarray(ref_params["emb"]),
                               atol=1e-5, rtol=1e-5)

    # on-mesh eval forward == single-device eval on the updated model
    batch = {"dense": dense, "sparse": sparse, "labels": labels}
    m_sh = sharded_evaluate(new_params, [batch], config, mesh=mesh,
                            placement=p)
    host_params = {"bottom": jax.tree.map(jnp.asarray, new_params["bottom"]),
                   "emb": jnp.asarray(got),
                   "top": jax.tree.map(jnp.asarray, new_params["top"])}
    m_ref = evaluate(host_params, [batch], config)
    np.testing.assert_allclose(m_sh["loss"], m_ref["loss"], rtol=1e-5)
    # AUC is bucketed (StreamingAUC): 1-ulp prediction differences can
    # cross a bucket edge, moving AUC by ~1/(pos*neg) — compare loosely
    np.testing.assert_allclose(m_sh["auc"], m_ref["auc"], atol=2e-2)
    # accuracy thresholds at 0.5: a logit within f32 noise of 0 can flip
    # one prediction under the sharded forward's different reduction
    # order — allow one flipped example
    n_eval = int(m_ref["examples"])
    assert abs(m_sh["accuracy"] - m_ref["accuracy"]) <= 1.0 / n_eval + 1e-9


def test_sharded_eval_ragged_tail_covers_every_row(rng):
    """On-mesh eval over a dataset that does NOT divide the batch size
    pads the trailing batch to a mesh multiple, trims the padded
    predictions, and reports metrics over EVERY row — exactly equal to
    single-chip eval (reference test() covers every row, utils.jl:31-46)."""
    from dlrm_tpu.train.metrics import evaluate, sharded_evaluate

    config = dlrm_tpu.tiny_config(num_tables=5, rows=64, feature_size=8)
    params = dlrm_tpu.init_params(jax.random.key(3), config)
    mesh = make_mesh(8)
    p = plan_placement(config.table_sizes, 8, pack=config.pack)
    sh_params = {
        "bottom": jax.tree.map(jnp.copy, params["bottom"]),
        "emb": pemb.shard_tables(params["emb"], p, config),
        "top": jax.tree.map(jnp.copy, params["top"]),
    }
    sh_params = jax.device_put(sh_params, param_shardings(mesh, sh_params))

    # 83 rows at B=32 -> batches of 32, 32, and a ragged 19 (19 % 8 != 0)
    n, b = 83, 32
    dense = rng.normal(size=(n, config.num_dense)).astype(np.float32)
    sparse = np.stack(
        [rng.integers(0, s, size=n) for s in config.table_sizes],
        axis=1).astype(np.int32)
    labels = (rng.random(n) > 0.5).astype(np.float32)
    batches = [{"dense": dense[i:i + b], "sparse": sparse[i:i + b],
                "labels": labels[i:i + b]} for i in range(0, n, b)]
    assert batches[-1]["dense"].shape[0] == 19

    m_sh = sharded_evaluate(sh_params, batches, config, mesh=mesh,
                            placement=p)
    m_ref = evaluate(params, batches, config)
    assert m_sh["examples"] == n == m_ref["examples"]
    np.testing.assert_allclose(m_sh["loss"], m_ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(m_sh["auc"], m_ref["auc"], atol=2e-2)
    assert abs(m_sh["accuracy"] - m_ref["accuracy"]) <= 1.0 / n + 1e-9
