"""int8 quantized serving path (ops/quant.py).

The reference has no quantized inference (tables are f32/bf16 only); this
is a serving capability extension motivated by device-memory capacity
(the Kaggle fs=128 stack is 17.3 GB f32 vs ~4.4 GB int8).  Tests pin:
error bounds of the symmetric per-row scheme, bit-parity of the
quantized lookup against the dequantized-storage oracle on every storage
layout, end-to-end forward closeness, geometry guards, and the CLI.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dlrm_tpu
from dlrm_tpu.config import DLRMConfig, tiny_config
from dlrm_tpu.models.dlrm import forward, init_params
from dlrm_tpu.ops import embedding as emb_ops
from dlrm_tpu.ops import quant


def _configs():
    """One config per storage regime the quantizer must handle."""
    return {
        # lane-packed engine storage, pack=16, multiple chunks
        "packed": dataclasses.replace(
            tiny_config(num_tables=6, rows=64, feature_size=8),
            table_sizes=(64, 4096, 64, 300, 8192, 64),
            chunk_budget_bytes=64 << 10, small_table_threshold=100),
        # engine storage with pack=1 (24 does not divide 128)
        "pack1": dataclasses.replace(
            tiny_config(num_tables=4, rows=500, feature_size=24),
            chunk_budget_bytes=16 << 10, small_table_threshold=0),
        # plain stacked storage
        "plain": dataclasses.replace(
            tiny_config(num_tables=4, rows=200, feature_size=8),
            packed_tables=False, small_table_threshold=64),
        # multi-hot pooled lookups
        "multihot": dataclasses.replace(
            tiny_config(num_tables=4, rows=600, feature_size=8, n_hot=3),
            chunk_budget_bytes=16 << 10, small_table_threshold=100),
    }


def _ids(rng, config, b=32):
    shape = ((b, config.num_tables) if config.n_hot == 1
             else (b, config.num_tables, config.n_hot))
    cols = [rng.integers(0, n, size=shape[:1] + shape[2:])
            for n in config.table_sizes]
    return jnp.asarray(np.stack(cols, axis=1).astype(np.int32))


@pytest.mark.parametrize("name", list(_configs()))
def test_quant_roundtrip_error_bound(name, rng):
    """dequant(quant(x)) is within half a quantization step of x, per
    logical row; all-zero rows survive exactly."""
    config = _configs()[name]
    params = init_params(jax.random.key(1), config)
    emb = params["emb"]
    qemb = quant.quantize_emb(emb, config)
    deq = quant.dequantize_emb(qemb, config)
    for t in range(config.num_tables):
        x = np.asarray(emb_ops.get_logical_table(emb, config, t))
        y = np.asarray(quant.quant_get_logical_table(qemb, config, t))
        step = np.abs(x).max(axis=1, keepdims=True) / 127.0
        assert np.all(np.abs(x - y) <= 0.5 * step + 1e-7), name
        # the storage-level oracle agrees with the per-table view
        z = np.asarray(emb_ops.get_logical_table(deq, config, t))
        np.testing.assert_allclose(y, z, rtol=0, atol=1e-7)


def test_quant_zero_rows_exact():
    config = _configs()["packed"]
    if config.is_packed:
        emb = tuple(jnp.zeros(s, jnp.float32) for s in config.emb_shapes)
    qemb = quant.quantize_emb(emb, config)
    for c, s in zip(qemb.chunks, qemb.scales):
        assert np.all(np.asarray(c) == 0)
        assert np.all(np.asarray(s) == 1.0)  # safe scale, no 0/0


@pytest.mark.parametrize("name", list(_configs()))
def test_quant_lookup_matches_dequantized_oracle(name, rng):
    """quant_mixed_lookup(qemb) == mixed_lookup(dequantize(qemb)): the
    int8 gather/scale plumbing is exact — all error lives in quantize."""
    config = _configs()[name]
    params = init_params(jax.random.key(2), config)
    qemb = quant.quantize_emb(params["emb"], config)
    deq = quant.dequantize_emb(qemb, config)
    ids = _ids(rng, config)
    got = np.asarray(quant.quant_mixed_lookup(qemb, ids, config))
    want = np.asarray(emb_ops.mixed_lookup(deq, ids, config))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["packed", "plain", "multihot"])
def test_quant_forward_close_to_f32(name, rng):
    """End-to-end CTR scores from quantized tables stay close to f32's
    (0.4% relative table error through the dense tower)."""
    config = _configs()[name]
    params = init_params(jax.random.key(3), config)
    qparams = quant.quantize_params(params, config)
    dense = jnp.asarray(rng.standard_normal((64, 13)).astype(np.float32))
    ids = _ids(rng, config, b=64)
    f32 = np.asarray(jax.jit(
        lambda p, d, s: forward(p, d, s, config))(params, dense, ids))
    q = np.asarray(jax.jit(
        lambda p, d, s: forward(p, d, s, config))(qparams, dense, ids))
    assert np.max(np.abs(f32 - q)) < 5e-3, (name, np.max(np.abs(f32 - q)))


def test_quant_footprint_and_guards(rng):
    config = _configs()["packed"]
    params = init_params(jax.random.key(4), config)
    qemb = quant.quantize_emb(params["emb"], config)
    f32_bytes = sum(int(np.prod(c.shape)) * 4 for c in params["emb"])
    assert 0 < quant.table_bytes(qemb) < 0.5 * f32_bytes
    # geometry guard: storage quantized under a different chunk split
    other = dataclasses.replace(config, chunk_budget_bytes=1 << 20)
    with pytest.raises(ValueError, match="quantized chunk shapes"):
        emb_ops.check_storage(qemb, other)
    # QuantEmb must NOT match the engine tuple-storage isinstance checks
    assert not isinstance(qemb, (tuple, list))
    # it is a pytree: jit boundaries and tree.map work
    mapped = jax.tree.map(lambda x: x, qemb)
    assert isinstance(mapped, quant.QuantEmb)
    assert len(mapped.chunks) == len(qemb.chunks)


@pytest.mark.parametrize("name", ["packed", "pack1", "plain"])
def test_quant_host_matches_device(name):
    """quantize_emb_host (numpy, the serving load path — the f32 stack
    must never be device_put when it doesn't fit HBM) is bit-identical
    to the jnp quantizer."""
    config = _configs()[name]
    params = init_params(jax.random.key(9), config)
    qd = quant.quantize_emb(params["emb"], config)
    emb_np = (tuple(np.asarray(c) for c in params["emb"])
              if isinstance(params["emb"], tuple)
              else np.asarray(params["emb"]))
    qh = quant.quantize_emb_host(emb_np, config)
    for cd, ch, sd, sh in zip(qd.chunks, qh.chunks, qd.scales, qh.scales):
        np.testing.assert_array_equal(np.asarray(cd), ch)
        np.testing.assert_array_equal(np.asarray(sd), sh)
    # the host result flows through the same pytree placement the CLI
    # uses and still passes the storage guard
    placed = jax.tree.map(jnp.asarray, qh)
    assert isinstance(placed, quant.QuantEmb)
    quant.check_quant_storage(placed, config)


def _sharded_setup(rng, with_cs: bool):
    """slot + row-sharded (+ column-sharded) placement on 8 shards with
    quantized shard stacks."""
    from dlrm_tpu.parallel import embedding as pemb
    from dlrm_tpu.parallel.mesh import batch_sharding, make_mesh
    from dlrm_tpu.parallel.placement import plan_placement
    from jax.sharding import NamedSharding, PartitionSpec as P

    config = dataclasses.replace(
        tiny_config(num_tables=6, rows=64, feature_size=8),
        table_sizes=(64, 400, 12, 300, 64, 500),
        packed_tables=False)
    params = init_params(jax.random.key(13), config)
    emb_np = np.asarray(params["emb"])
    mesh = make_mesh(8)
    p = plan_placement(config.table_sizes, 8, pack=1,
                       max_rows_per_shard=350,
                       col_sharded_tables=(3,) if with_cs else ())
    shd = NamedSharding(mesh, P("d"))
    q, s = quant.quantize_sharded_stack(
        pemb.shard_tables(emb_np, p, config), 1, config.feature_size)
    sh = {"emb": jax.device_put(jnp.asarray(q), shd),
          "emb_scales": jax.device_put(jnp.asarray(s), shd)}
    if with_cs:
        qcs, scs = quant.quantize_col_shards(
            pemb.shard_col_tables(emb_np, p, config))
        sh["emb_cs"] = tuple(jax.device_put(jnp.asarray(a), shd)
                             for a in qcs)
        sh["emb_cs_scales"] = tuple(jax.device_put(jnp.asarray(a), shd)
                                    for a in scs)
    rng_ids = np.stack([rng.integers(0, n, size=32)
                        for n in config.table_sizes], axis=1)
    ids = jax.device_put(jnp.asarray(rng_ids.astype(np.int32)),
                         batch_sharding(mesh))
    return config, params, mesh, p, sh, ids


def test_quant_sharded_lookup_matches_single_host(rng):
    """int8 sharded lookup (slot + row-sharded) == the single-host
    quantized lookup bit-for-bit: per-logical-row scales are
    layout-independent, and both paths compute int8->f32 * scale."""
    from dlrm_tpu.parallel import embedding as pemb

    config, params, mesh, p, sh, ids = _sharded_setup(rng, with_cs=False)
    got = np.asarray(jax.jit(lambda e, s, i: pemb.sharded_lookup(
        e, i, mesh=mesh, placement=p, scales=s))(
        sh["emb"], sh["emb_scales"], ids))
    qemb = quant.quantize_emb(params["emb"], config)
    want = np.asarray(quant.quant_gather_tables(
        qemb, jnp.asarray(np.asarray(ids)), config))
    np.testing.assert_array_equal(got, want)


def test_quant_sharded_forward_with_cs_close_to_f32(rng):
    """With column-sharded tables (per-lane-slice scales — finer than
    whole-row), the quantized sharded lookup stays within the derived
    quantization error bound of the f32 sharded lookup."""
    from dlrm_tpu.parallel import embedding as pemb

    config, params, mesh, p, sh, ids = _sharded_setup(rng, with_cs=True)
    got = np.asarray(jax.jit(lambda e, s, cs, csc, i: pemb.sharded_lookup(
        e, i, mesh=mesh, placement=p, cs=cs, cs_scales=csc, scales=s))(
        sh["emb"], sh["emb_scales"], sh["emb_cs"], sh["emb_cs_scales"],
        ids))
    cfg_all = dataclasses.replace(config, small_table_threshold=0)
    f32 = np.asarray(emb_ops.mixed_lookup(
        params["emb"], jnp.asarray(np.asarray(ids)), cfg_all))
    mass = np.asarray(emb_ops.mixed_lookup(
        jnp.abs(params["emb"]), jnp.asarray(np.asarray(ids)), cfg_all))
    # error bound is per-ROW: half a quantization step = amax(row)/254
    # (per-lane-slice scales only tighten it)
    tol = mass.max(axis=-1, keepdims=True) / 254.0 + 1e-6
    assert np.all(np.abs(got - f32) <= tol)


def test_quant_sharded_update_rejected(rng):
    """int8 tables are inference-only: the sharded update paths refuse."""
    from dlrm_tpu.parallel import embedding as pemb
    from dlrm_tpu.parallel.mesh import batch_sharding

    config, params, mesh, p, sh, ids = _sharded_setup(rng, with_cs=False)
    d_pooled = jax.device_put(jnp.zeros(
        (32, config.num_tables, config.feature_size), jnp.float32),
        batch_sharding(mesh))
    with pytest.raises(ValueError, match="inference-only"):
        pemb.sharded_update_sgd(sh["emb"], ids, d_pooled, 0.1,
                                mesh=mesh, placement=p)
    with pytest.raises(ValueError, match="scales"):
        pemb.sharded_lookup(sh["emb"], ids, mesh=mesh, placement=p)


def test_quant_cli_sharded_predict_and_eval(tmp_path, capsys):
    """End-to-end: train sharded -> predict/eval --quantize-tables int8
    serves ON the mesh (int8 shard stacks) and matches f32 closely."""
    from dlrm_tpu import run as cli
    from dlrm_tpu.data import synthetic

    lines = synthetic.criteo_text_lines(96, seed=21)
    (tmp_path / "day.txt").write_text("".join(lines))
    out = str(tmp_path / "data.bin")

    def run(argv):
        rc = cli.main(argv)
        txt = capsys.readouterr().out.strip().splitlines()
        return rc, json.loads(txt[-1])

    run(["preprocess", str(tmp_path / "day.txt"), "--out", out])
    sizes = ",".join("1000" for _ in range(26))
    ckpt = str(tmp_path / "ck")
    common = ["--config", "tiny", "--table-sizes", sizes,
              "--batch-size", "16"]
    run(["train", *common, "--data", out, "--sharded", "true",
         "--log-every", "5", "--ckpt-dir", ckpt, "--save-interval", "100"])
    rc, _ = run(["predict", *common, "--data", out, "--ckpt-dir", ckpt,
                 "--out", str(tmp_path / "f32.npy")])
    assert rc == 0
    rc, res = run(["predict", *common, "--data", out, "--ckpt-dir", ckpt,
                   "--out", str(tmp_path / "q.npy"),
                   "--quantize-tables", "int8"])
    assert rc == 0 and res["examples"] == 96
    a = np.load(str(tmp_path / "f32.npy"))
    b = np.load(str(tmp_path / "q.npy"))
    assert np.max(np.abs(a - b)) < 5e-3
    rc, m = run(["eval", *common, "--data", out, "--ckpt-dir", ckpt,
                 "--quantize-tables", "int8"])
    assert rc == 0 and np.isfinite(m["loss"])


def test_quant_export_artifact_roundtrip(tmp_path, capsys):
    """export --quantize int8 writes a ready-to-serve artifact; predict
    from it matches quantize-at-load bit-for-bit (same quantizer), and
    eval serves it without any --quantize flag."""
    from dlrm_tpu import run as cli
    from dlrm_tpu.data import synthetic

    (tmp_path / "day.txt").write_text(
        "".join(synthetic.criteo_text_lines(64, seed=31)))
    out = str(tmp_path / "data.bin")

    def run(argv):
        rc = cli.main(argv)
        txt = capsys.readouterr().out.strip().splitlines()
        return rc, json.loads(txt[-1])

    run(["preprocess", str(tmp_path / "day.txt"), "--out", out])
    sizes = ",".join("1000" for _ in range(26))
    ckpt, qdir = str(tmp_path / "ck"), str(tmp_path / "q")
    common = ["--config", "tiny", "--table-sizes", sizes,
              "--batch-size", "16"]
    run(["train", *common, "--data", out, "--sharded", "false",
         "--log-every", "5", "--ckpt-dir", ckpt, "--save-interval", "100"])
    rc, res = run(["export", "--config", "tiny", "--table-sizes", sizes,
                   "--ckpt-dir", ckpt, "--out", qdir,
                   "--quantize", "int8"])
    assert rc == 0 and res["quantized"] == "int8"
    assert res["table_bytes"] < 26 * 1000 * 8 * 4 * 0.5
    rc, _ = run(["predict", *common, "--data", out, "--ckpt-dir", ckpt,
                 "--out", str(tmp_path / "a.npy"),
                 "--quantize-tables", "int8"])
    assert rc == 0
    rc, _ = run(["predict", *common, "--data", out, "--ckpt-dir", qdir,
                 "--out", str(tmp_path / "b.npy")])
    assert rc == 0
    np.testing.assert_array_equal(np.load(str(tmp_path / "a.npy")),
                                  np.load(str(tmp_path / "b.npy")))
    rc, m = run(["eval", *common, "--data", out, "--ckpt-dir", qdir])
    assert rc == 0 and np.isfinite(m["loss"])


def test_quant_preserves_auc_on_trained_model():
    """The serving claim that matters: on a model trained to a real AUC
    (planted-truth synthetic CTR), int8 tables reproduce the f32 AUC to
    within 0.005 — quantization error does not change ranking quality."""
    from dlrm_tpu.data.synthetic import ClickthroughModel
    from dlrm_tpu.train.metrics import evaluate
    from dlrm_tpu.train.train import make_jit_train_step

    config = dataclasses.replace(
        tiny_config(num_tables=6, rows=64, feature_size=8),
        table_sizes=(200, 12, 500, 40, 1000, 8),
        small_table_threshold=16, chunk_budget_bytes=16 << 10)
    truth = ClickthroughModel(config, seed=3)
    params = dlrm_tpu.init_params(jax.random.key(0), config)
    step = make_jit_train_step(config, lr=0.1)
    for batch in truth.stream(256, steps=150, seed=1):
        params, _ = step(params, jnp.asarray(batch["dense"]),
                         jnp.asarray(batch["sparse"]),
                         jnp.asarray(batch["labels"]))
    heldout = list(truth.stream(512, steps=4, seed=999))
    m32 = evaluate(params, heldout, config)
    mq = evaluate(quant.quantize_params(params, config), heldout, config)
    assert m32["auc"] > 0.6  # the model actually learned something
    assert abs(mq["auc"] - m32["auc"]) < 0.005, (m32, mq)
    assert abs(mq["loss"] - m32["loss"]) < 0.01


def test_quant_cli_predict_and_eval(tmp_path, capsys):
    """predict/eval --quantize-tables int8: scores every row, close to
    the f32 scores."""
    from dlrm_tpu import run as cli
    from dlrm_tpu.data import synthetic

    lines = synthetic.criteo_text_lines(96, seed=11)
    src = tmp_path / "day.txt"
    src.write_text("".join(lines))
    out = str(tmp_path / "data.bin")

    def run(argv):
        rc = cli.main(argv)
        txt = capsys.readouterr().out.strip().splitlines()
        return rc, json.loads(txt[-1])

    run(["preprocess", str(src), "--out", out])
    sizes = ",".join("1000" for _ in range(26))
    ckpt = str(tmp_path / "ck")
    common = ["--config", "tiny", "--table-sizes", sizes,
              "--batch-size", "16"]
    run(["train", *common, "--data", out, "--sharded", "false",
         "--log-every", "5", "--ckpt-dir", ckpt, "--save-interval", "100"])
    p_f32 = str(tmp_path / "f32.npy")
    p_q = str(tmp_path / "q.npy")
    rc, _ = run(["predict", *common, "--data", out, "--ckpt-dir", ckpt,
                 "--out", p_f32])
    assert rc == 0
    rc, res = run(["predict", *common, "--data", out, "--ckpt-dir", ckpt,
                   "--out", p_q, "--quantize-tables", "int8"])
    assert rc == 0 and res["examples"] == 96
    a, b = np.load(p_f32), np.load(p_q)
    assert a.shape == b.shape == (96,)
    assert np.max(np.abs(a - b)) < 5e-3
    rc, m = run(["eval", *common, "--data", out, "--ckpt-dir", ckpt,
                 "--quantize-tables", "int8"])
    assert rc == 0
    rc, m32 = run(["eval", *common, "--data", out, "--ckpt-dir", ckpt])
    assert rc == 0
    assert abs(m["loss"] - m32["loss"]) < 1e-2
    assert abs(m["accuracy"] - m32["accuracy"]) <= 0.05
