"""Boundary-targeted sharding cases the randomized parity tests could miss.

Three deliberate edges:
  * the MAXIMUM id of every table (id == size-1) and every row-sharded
    SHARD-EDGE id (k*chunk - 1, k*chunk) present in one batch — padding /
    trash-row bugs trigger exactly here;
  * row-sharded tables whose rows divide EVENLY by num_shards*pack vs a
    ragged size — the rs chunk math's off-by-one surface;
  * a placement where most shards own ZERO slot tables (fewer tables than
    shards) — the slot_valid masking must keep idle shards inert.
Each case asserts full train-step parity against the single-device step.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import dlrm_tpu
from dlrm_tpu.parallel import embedding as pemb
from dlrm_tpu.parallel.mesh import (batch_sharding, make_mesh,
                                    param_shardings)
from dlrm_tpu.parallel.placement import plan_placement
from dlrm_tpu.train.train import make_sharded_train_step, train_step


def _edge_batch(rng, config, b, placement):
    """A batch whose sparse ids hit every table's 0 and size-1, and every
    row-sharded table's shard-edge ids (k*chunk - 1, k*chunk)."""
    dense = rng.normal(size=(b, config.num_dense)).astype(np.float32)
    cols = []
    for t, size in enumerate(config.table_sizes):
        edges = [0, size - 1]
        if t in placement.row_sharded:
            k = placement.row_sharded.index(t)
            chunk = placement.rs_rows_per_shard[k]
            for s in range(1, placement.num_shards):
                if s * chunk < size:
                    edges += [s * chunk - 1, s * chunk]
        edges = np.asarray(edges, np.int64)
        col = rng.integers(0, size, size=b)
        col[:len(edges) % b] = edges[:b]
        col[-1] = size - 1          # max id in the LAST row of the batch
        cols.append(col)
    sparse = np.stack(cols, axis=1).astype(np.int32)
    labels = (rng.random(b) > 0.5).astype(np.float32)
    return dense, sparse, labels


def _assert_step_parity(config, placement, dense, sparse, labels,
                        lr=0.5, atol=1e-5):
    params = dlrm_tpu.init_params(jax.random.key(13), config)
    ref_params, ref_loss = jax.jit(
        lambda p, d, s, l: train_step(p, d, s, l, config=config, lr=lr)
    )(jax.tree.map(jnp.copy, params), jnp.asarray(dense),
      jnp.asarray(sparse), jnp.asarray(labels))

    mesh = make_mesh(placement.num_shards)
    emb_np = np.asarray(params["emb"]) if not isinstance(
        params["emb"], tuple) else params["emb"]
    sh_params = {
        "bottom": jax.tree.map(jnp.copy, params["bottom"]),
        "emb": pemb.shard_tables(emb_np, placement, config),
        "top": jax.tree.map(jnp.copy, params["top"]),
    }
    if placement.col_sharded:
        sh_params["emb_cs"] = pemb.shard_col_tables(emb_np, placement,
                                                    config)
    sh_params = jax.device_put(sh_params,
                               param_shardings(mesh, sh_params))
    bs = batch_sharding(mesh)
    step = make_sharded_train_step(config, lr, mesh, placement)
    new_params, loss = step(sh_params,
                            jax.device_put(jnp.asarray(dense), bs),
                            jax.device_put(jnp.asarray(sparse), bs),
                            jax.device_put(jnp.asarray(labels), bs))
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-6)
    got = pemb.unshard_tables(np.asarray(new_params["emb"]), placement,
                              config)
    want = np.asarray(ref_params["emb"]) if not isinstance(
        ref_params["emb"], tuple) else None
    if want is None:
        from dlrm_tpu.ops import embedding as emb_ops
        want = emb_ops.unpack_tables(
            jax.tree.map(np.asarray, ref_params["emb"]), config)
    if placement.col_sharded:
        cs_tabs = pemb.unshard_col_tables(
            [np.asarray(a) for a in new_params["emb_cs"]], placement)
        for k, t in enumerate(placement.col_sharded):
            off = config.table_offsets[t]
            got[off:off + config.table_sizes[t]] = cs_tabs[k]
    np.testing.assert_allclose(got, want, atol=atol, rtol=atol)


@pytest.mark.parametrize("n_hot", [1, 2])
def test_max_id_and_shard_edge_rows(n_hot, rng):
    """id == size-1 on every table + rs shard-edge ids, slot + rs + cs in
    one step; a trash-row or edge-ownership bug corrupts the last rows."""
    config = dlrm_tpu.tiny_config(num_tables=5, rows=64, feature_size=8,
                                  n_hot=n_hot)
    config = dataclasses.replace(
        config, table_sizes=(64, 401, 12, 300, 50),
        packed_tables=False)
    p = plan_placement(config.table_sizes, 8, pack=1,
                       max_rows_per_shard=350, col_sharded_tables=(3,))
    assert p.row_sharded == (1,) and p.col_sharded == (3,)
    b = 32
    if n_hot == 1:
        dense, sparse, labels = _edge_batch(rng, config, b, p)
    else:
        d1, s1, labels = _edge_batch(rng, config, b, p)
        d2, s2, _ = _edge_batch(rng, config, b, p)
        dense = d1
        sparse = np.stack([s1, s2], axis=2)
    _assert_step_parity(config, p, dense, sparse, labels)


@pytest.mark.parametrize("rows", [512, 500, 513])
def test_rs_rows_divisible_vs_ragged(rows, rng):
    """Row-sharded table sizes that divide evenly by num_shards*pack
    (512 = 8*64... exactly), just under (500), and just over (513) — the
    rs chunk arithmetic's off-by-one surface, with lane packing ON."""
    config = dlrm_tpu.tiny_config(num_tables=3, rows=64, feature_size=8)
    config = dataclasses.replace(config, table_sizes=(64, rows, 32))
    p = plan_placement(config.table_sizes, 8, pack=config.pack,
                       max_rows_per_shard=256)
    assert p.row_sharded == (1,)
    dense, sparse, labels = _edge_batch(rng, config, 32, p)
    _assert_step_parity(config, p, dense, sparse, labels)


def test_shards_with_zero_slot_tables(rng):
    """3 tables over 8 shards (one row-sharded): five shards own NO slot
    table; their slot paths must stay inert while their rs blocks still
    participate."""
    config = dlrm_tpu.tiny_config(num_tables=3, rows=64, feature_size=8)
    config = dataclasses.replace(config, table_sizes=(40, 900, 24))
    p = plan_placement(config.table_sizes, 8, pack=config.pack,
                       max_rows_per_shard=500)
    assert p.row_sharded == (1,)
    owners = {int(p.table_shard[t]) for t in p.slot_table_list}
    assert len(owners) <= 3          # >= 5 shards own zero slot tables
    dense, sparse, labels = _edge_batch(rng, config, 32, p)
    _assert_step_parity(config, p, dense, sparse, labels)
