"""CLI driver tests: each subcommand end-to-end on tiny data.

The reference is driven from the Julia REPL via script.jl/@setup; the CLI is
the new framework's equivalent driver layer, so every subcommand gets an
end-to-end test (in-process, capturing stdout JSON).
"""

import json
import os

import numpy as np
import pytest

from conftest import FIXTURE_SINGLE, requires_fixtures

from dlrm_tpu import run as cli
from dlrm_tpu.data import synthetic
from dlrm_tpu.data.criteo import DACLoader, load


def _run(capsys, argv):
    rc = cli.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


def _write_text_shards(tmp_path, n=120, shards=3):
    lines = synthetic.criteo_text_lines(n, seed=7)
    per = n // shards
    paths = []
    for i in range(shards):
        p = tmp_path / f"day_{i}.txt"
        p.write_text("".join(lines[i * per:(i + 1) * per]))
        paths.append(str(p))
    return paths


def test_preprocess_cli(tmp_path, capsys):
    paths = _write_text_shards(tmp_path)
    out = str(tmp_path / "data.bin")
    vocab = str(tmp_path / "vocab.npz")
    rc, res = _run(capsys, ["preprocess", *paths, "--out", out,
                            "--vocab", vocab])
    assert rc == 0
    assert res["records"] == 120
    assert os.path.exists(out) and os.path.exists(vocab)
    data = load(out)
    assert len(data) == 120
    # reindexed ids are dense 1..N
    sizes = res["vocab_sizes"]
    cat = np.asarray(data["cat"])
    for j in range(26):
        assert cat[:, j].min() >= 1
        assert cat[:, j].max() == sizes[j]


def test_train_eval_cli_on_real_pipeline(tmp_path, capsys):
    """preprocess -> train (with checkpointing + resume) -> eval."""
    paths = _write_text_shards(tmp_path)
    out = str(tmp_path / "data.bin")
    rc, res = _run(capsys, ["preprocess", *paths, "--out", out])
    sizes = ",".join("1000" for _ in range(26))  # vocab fits in 1000

    ckpt = str(tmp_path / "ckpt")
    common = ["--config", "tiny", "--table-sizes", sizes,
              "--batch-size", "16"]
    train_common = [*common, "--sharded", "false"]
    rc, res = _run(capsys, ["train", *train_common, "--data", out,
                            "--lr", "0.05", "--log-every", "1",
                            "--ckpt-dir", ckpt, "--save-interval", "2",
                            "--eval-after"])
    assert rc == 0
    assert res["steps"] == 120 // 16
    assert res["final_loss"] is not None and np.isfinite(res["final_loss"])
    assert 0.0 <= res["eval"]["accuracy"] <= 1.0
    # single-chip eval keeps the trailing partial batch: all 120 rows
    # (training itself still consumes the 7 full batches)
    assert res["eval"]["examples"] == 120

    # resume: another epoch starting from the saved step
    rc, res2 = _run(capsys, ["train", *train_common, "--data", out,
                             "--ckpt-dir", ckpt, "--log-every", "1"])
    assert rc == 0 and res2["steps"] == 7

    rc, ev = _run(capsys, ["eval", *common, "--data", out,
                           "--ckpt-dir", ckpt, "--eval-steps", "3"])
    assert rc == 0
    assert 0.0 <= ev["accuracy"] <= 1.0 and np.isfinite(ev["loss"])


def test_train_cli_adagrad(capsys):
    rc, res = _run(capsys, [
        "train", "--config", "tiny", "--batch-size", "32", "--steps", "3",
        "--sharded", "false", "--optimizer", "adagrad", "--log-every", "1"])
    assert rc == 0
    assert res["steps"] == 3 and np.isfinite(res["final_loss"])


def test_train_cli_rowwise_adagrad(capsys):
    """rowwise_adagrad end-to-end on EVERY path: single-chip steps +
    blocks, sharded steps + blocks, the two-tier path, and
    col-sharded/host-resident placements."""
    rc, res = _run(capsys, [
        "train", "--config", "tiny", "--batch-size", "32", "--steps", "5",
        "--sharded", "false", "--optimizer", "rowwise_adagrad",
        "--update-interval", "2", "--log-every", "2", "--eval-after",
        "--eval-steps", "2"])
    assert rc == 0 and res["steps"] == 5
    assert np.isfinite(res["final_loss"])

    rc, res = _run(capsys, [
        "train", "--config", "tiny", "--batch-size", "32", "--steps", "4",
        "--sharded", "true", "--optimizer", "rowwise_adagrad",
        "--update-interval", "2", "--log-every", "2", "--eval-after",
        "--eval-steps", "2"])
    assert rc == 0 and res["steps"] == 4
    assert np.isfinite(res["final_loss"])

    rc, res = _run(capsys, [
        "train", "--config", "tiny", "--batch-size", "32", "--steps", "2",
        "--sharded", "false", "--hbm-budget-gb", "0.0001",
        "--optimizer", "rowwise_adagrad", "--log-every", "1"])
    assert rc == 0 and res["steps"] == 2
    assert np.isfinite(res["final_loss"])

    # round 5: coalesced tiered blocks (one host gather/scatter per K)
    rc, res = _run(capsys, [
        "train", "--config", "tiny", "--batch-size", "32", "--steps", "4",
        "--sharded", "false", "--hbm-budget-gb", "0.0001",
        "--update-interval", "2", "--log-every", "2"])
    assert rc == 0 and res["steps"] == 4
    assert np.isfinite(res["final_loss"])
    rc, res = _run(capsys, [
        "train", "--config", "tiny", "--batch-size", "32", "--steps", "4",
        "--sharded", "false", "--hbm-budget-gb", "0.0001",
        "--update-interval", "2", "--optimizer", "rowwise_adagrad",
        "--lr", "0.05", "--log-every", "2"])
    assert rc == 0 and res["steps"] == 4
    assert np.isfinite(res["final_loss"])
    import pytest as _pytest
    with _pytest.raises(SystemExit, match="constant lr"):
        from dlrm_tpu import run as _cli
        _cli.main(["train", "--config", "tiny", "--batch-size", "32",
                   "--steps", "4", "--sharded", "false",
                   "--hbm-budget-gb", "0.0001", "--update-interval", "2",
                   "--lr-schedule", "warmup_poly_decay",
                   "--warmup-steps", "2", "--decay-steps", "4"])
    capsys.readouterr()

    from dlrm_tpu.parallel.host_tier import host_memory_supported
    if host_memory_supported():
        rc, res = _run(capsys, [
            "train", "--config", "tiny", "--batch-size", "32",
            "--steps", "2", "--sharded", "true", "--host-tables", "1",
            "--col-sharded-tables", "2",
            "--optimizer", "rowwise_adagrad", "--log-every", "1"])
        assert rc == 0 and res["steps"] == 2
        assert np.isfinite(res["final_loss"])


def test_train_cli_sharded_synthetic(capsys):
    """Hybrid-parallel path over the 8-device CPU mesh via the CLI."""
    rc, res = _run(capsys, [
        "train", "--config", "tiny", "--batch-size", "32", "--steps", "3",
        "--sharded", "true", "--log-every", "1"])
    assert rc == 0
    assert res["steps"] == 3 and np.isfinite(res["final_loss"])


@requires_fixtures
def test_validate_cli(capsys):
    rc, res = _run(capsys, ["validate", FIXTURE_SINGLE])
    assert rc == 0
    assert res["ok"] and res["worst_abs_err"] < 1e-4


def test_instrument_cli(capsys):
    rc, res = _run(capsys, ["instrument", "--config", "tiny",
                            "--batch-size", "32", "--steps", "3"])
    assert rc == 0
    phases = res["phase_ms"]
    for sym in ("lookup", "bottom_mlp", "interaction", "top_mlp", "loss",
                "loss_back", "weight_update_done",
                "embedding_update_done"):
        assert sym in phases, sorted(phases)


def test_bench_cli(capsys):
    rc, res = _run(capsys, ["bench", "--config", "tiny",
                            "--batch-size", "64", "--steps", "2"])
    assert rc == 0
    assert res["examples_per_s"] > 0


def test_train_cli_eval_every(capsys):
    rc, res = _run(capsys, [
        "train", "--config", "tiny", "--batch-size", "32", "--steps", "4",
        "--sharded", "false", "--eval-every", "2", "--eval-steps", "2",
        "--log-every", "1"])
    assert rc == 0
    assert len(res["eval_record"]) == 2
    assert res["eval_record"][0]["step"] == 2
    assert 0.0 <= res["eval_record"][-1]["accuracy"] <= 1.0


def test_train_cli_host_tier(capsys):
    """Two-tier path from the CLI: a tiny hbm budget spills tables to host
    memory; training runs and eval-after works on the merged view."""
    import jax
    from dlrm_tpu.parallel import host_tier as ht

    if not ht.host_memory_supported():
        pytest.skip("no pinned_host memory space")
    rc, res = _run(capsys, [
        "train", "--config", "tiny", "--batch-size", "32", "--steps", "3",
        "--sharded", "false", "--hbm-budget-gb", "0.000004",
        "--eval-after", "--eval-steps", "2", "--log-every", "1"])
    assert rc == 0
    assert res["steps"] == 3 and np.isfinite(res["final_loss"])
    assert 0.0 <= res["eval"]["accuracy"] <= 1.0

    # software-pipelined host tier: --host-prefetch with a budget small
    # enough that tables actually spill (tiny tables are 1 KiB each)
    rc, res = _run(capsys, [
        "train", "--config", "tiny", "--batch-size", "32", "--steps", "3",
        "--sharded", "false", "--hbm-budget-gb", "0.000002",
        "--host-prefetch", "--eval-after", "--eval-steps", "2",
        "--log-every", "1"])
    assert rc == 0
    assert res["steps"] == 3 and np.isfinite(res["final_loss"])
    with pytest.raises(SystemExit, match="two-tier"):
        cli.main(["train", "--config", "tiny", "--steps", "1",
                  "--host-prefetch"])


def test_train_cli_col_and_row_sharded(capsys):
    """Hybrid row+column sharding via the CLI on the 8-device mesh."""
    sizes = ",".join(str(s) for s in (64, 400, 12, 300, 64, 50))
    rc, res = _run(capsys, [
        "train", "--config", "tiny", "--table-sizes", sizes,
        "--batch-size", "32", "--steps", "3", "--sharded", "true",
        "--max-rows-per-shard", "350", "--col-sharded-tables", "3,5",
        "--eval-after", "--eval-steps", "2", "--log-every", "1"])
    assert rc == 0
    assert res["steps"] == 3 and np.isfinite(res["final_loss"])
    assert 0.0 <= res["eval"]["accuracy"] <= 1.0


def test_sharded_adagrad_ckpt_resume_eval(tmp_path, capsys):
    """Sharded adagrad: checkpoint + resume via CLI, then `eval --ckpt-dir`
    rebuilds the placement from run_meta.json and reproduces the training
    run's --eval-after metrics exactly on the same data."""
    paths = _write_text_shards(tmp_path)
    out = str(tmp_path / "data.bin")
    _run(capsys, ["preprocess", *paths, "--out", out])
    sizes = ",".join("1000" for _ in range(26))
    ckpt = str(tmp_path / "ck")
    common = ["--config", "tiny", "--table-sizes", sizes,
              "--batch-size", "16"]
    rc, res = _run(capsys, [
        "train", *common, "--data", out, "--sharded", "true",
        "--optimizer", "adagrad", "--lr", "0.05", "--log-every", "2",
        "--ckpt-dir", ckpt, "--save-interval", "4", "--eval-every", "4",
        "--eval-steps", "2", "--eval-after"])
    assert rc == 0 and res["steps"] == 7
    assert res["eval_record"] and res["eval_record"][0]["step"] == 4
    assert os.path.exists(os.path.join(ckpt, "run_meta.json"))

    # resume continues (accumulator restored, not reset)
    rc, res2 = _run(capsys, [
        "train", *common, "--data", out, "--sharded", "true",
        "--optimizer", "adagrad", "--lr", "0.05", "--log-every", "2",
        "--ckpt-dir", ckpt, "--eval-after"])
    assert rc == 0 and res2["steps"] == 7

    # eval from the checkpoint == the training run's own --eval-after
    rc, ev = _run(capsys, ["eval", *common, "--data", out,
                           "--ckpt-dir", ckpt])
    assert rc == 0
    np.testing.assert_allclose(ev["loss"], res2["eval"]["loss"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ev["auc"], res2["eval"]["auc"], atol=1e-9)


def test_train_cli_update_interval(capsys):
    """Coalesced block mode from the CLI, including a sub-K remainder."""
    rc, res = _run(capsys, [
        "train", "--config", "tiny", "--batch-size", "32", "--steps", "7",
        "--sharded", "false", "--update-interval", "4", "--log-every", "2",
        "--eval-after", "--eval-steps", "2"])
    assert rc == 0
    assert res["steps"] == 7  # 4-block + 3 single remainder steps
    assert np.isfinite(res["final_loss"])
    assert 0.0 <= res["eval"]["accuracy"] <= 1.0


def test_train_cli_update_interval_with_schedule(capsys):
    """--update-interval + --lr-schedule: the schedule must reach the block
    step (regression: both block makers were handed the constant args.lr,
    silently training at base lr).  Covers single-chip and sharded."""
    from unittest import mock
    from dlrm_tpu.train import train as train_lib

    for shard in ("false", "true"):
        maker = (train_lib.make_jit_train_block if shard == "false"
                 else train_lib.make_sharded_train_block)
        name = maker.__name__
        with mock.patch.object(train_lib, name, wraps=maker) as spy:
            rc, res = _run(capsys, [
                "train", "--config", "tiny", "--batch-size", "32",
                "--steps", "4", "--sharded", shard,
                "--update-interval", "2", "--log-every", "2",
                "--lr-schedule", "warmup_poly_decay",
                "--warmup-steps", "2", "--decay-start", "2",
                "--decay-steps", "4"])
        assert rc == 0 and res["steps"] == 4
        assert np.isfinite(res["final_loss"])
        (args_, _), = [(c.args, c.kwargs) for c in spy.call_args_list]
        assert callable(args_[1]), \
            f"block maker got a constant lr on sharded={shard}"


def test_train_cli_sharded_update_interval(capsys):
    """Coalesced block mode on the hybrid-parallel path via the CLI."""
    rc, res = _run(capsys, [
        "train", "--config", "tiny", "--batch-size", "32", "--steps", "6",
        "--sharded", "true", "--update-interval", "2", "--log-every", "2",
        "--eval-after", "--eval-steps", "2"])
    assert rc == 0
    assert res["steps"] == 6
    assert np.isfinite(res["final_loss"])
    assert 0.0 <= res["eval"]["accuracy"] <= 1.0


def test_train_cli_adagrad_update_interval(capsys):
    """Adagrad block mode via the CLI: single-chip (with a schedule) and
    sharded (constant lr); scheduled sharded adagrad blocks must be
    rejected up front, not silently dropped."""
    rc, res = _run(capsys, [
        "train", "--config", "tiny", "--batch-size", "32", "--steps", "7",
        "--sharded", "false", "--optimizer", "adagrad",
        "--update-interval", "4", "--lr-schedule", "warmup_poly_decay",
        "--warmup-steps", "2", "--decay-start", "2", "--decay-steps", "8",
        "--log-every", "2", "--eval-after", "--eval-steps", "2"])
    assert rc == 0 and res["steps"] == 7
    assert np.isfinite(res["final_loss"])

    rc, res = _run(capsys, [
        "train", "--config", "tiny", "--batch-size", "32", "--steps", "4",
        "--sharded", "true", "--optimizer", "adagrad",
        "--update-interval", "2", "--log-every", "2", "--eval-after",
        "--eval-steps", "2"])
    assert rc == 0 and res["steps"] == 4
    assert np.isfinite(res["final_loss"])

    # scheduled sharded adagrad blocks (twin payload through the mesh)
    rc, res = _run(capsys, [
        "train", "--config", "tiny", "--batch-size", "32",
        "--steps", "4", "--sharded", "true", "--optimizer", "adagrad",
        "--update-interval", "2", "--log-every", "2", "--lr-schedule",
        "warmup_poly_decay", "--warmup-steps", "2",
        "--decay-start", "2", "--decay-steps", "8"])
    assert rc == 0 and res["steps"] == 4
    assert np.isfinite(res["final_loss"])


def test_train_cli_host_sharded_tables(capsys):
    """Config-5 composition via the CLI: host-resident row-sharded tables
    + slot tables on the 8-device mesh, eval-after on the merged view."""
    from dlrm_tpu.parallel import host_tier as ht
    if not ht.host_memory_supported():
        pytest.skip("no pinned_host memory space")
    sizes = ",".join(str(s) for s in (64, 1000, 16, 2048, 128, 512))
    rc, res = _run(capsys, [
        "train", "--config", "tiny", "--table-sizes", sizes,
        "--batch-size", "32", "--steps", "4", "--sharded", "true",
        "--host-tables", "1,3", "--max-rows-per-shard", "1500",
        "--log-every", "2", "--eval-after", "--eval-steps", "2"])
    assert rc == 0
    assert res["steps"] == 4 and np.isfinite(res["final_loss"])
    assert 0.0 <= res["eval"]["accuracy"] <= 1.0


def test_host_tables_ckpt_eval_roundtrip(tmp_path, capsys):
    """`eval --ckpt-dir` must rebuild host-resident placements from
    run_meta.json (regression: host_tables was not passed to
    plan_placement, silently unsharding with the wrong layout)."""
    from dlrm_tpu.parallel import host_tier as ht
    if not ht.host_memory_supported():
        pytest.skip("no pinned_host memory space")
    paths = _write_text_shards(tmp_path)
    out = str(tmp_path / "data.bin")
    _run(capsys, ["preprocess", *paths, "--out", out])
    sizes = ",".join("1000" for _ in range(26))
    ckpt = str(tmp_path / "ck")
    common = ["--config", "tiny", "--table-sizes", sizes,
              "--batch-size", "16"]
    rc, res = _run(capsys, [
        "train", *common, "--data", out, "--sharded", "true",
        "--host-tables", "1,3", "--log-every", "2",
        "--ckpt-dir", ckpt, "--save-interval", "4", "--eval-after"])
    assert rc == 0 and res["steps"] == 7
    rc, ev = _run(capsys, ["eval", *common, "--data", out,
                           "--ckpt-dir", ckpt])
    assert rc == 0
    np.testing.assert_allclose(ev["loss"], res["eval"]["loss"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ev["auc"], res["eval"]["auc"], atol=1e-9)

    # mismatched table sizes must fail fast, not corrupt silently
    with pytest.raises(SystemExit, match="table sizes"):
        _run(capsys, ["eval", "--config", "tiny", "--data", out,
                      "--batch-size", "16", "--ckpt-dir", ckpt])


def test_host_tables_block_mode_cli(capsys):
    """--update-interval composes with --host-tables (block maker pins /
    skips donation for the pinned-host stack)."""
    from dlrm_tpu.parallel import host_tier as ht
    if not ht.host_memory_supported():
        pytest.skip("no pinned_host memory space")
    sizes = ",".join(str(s) for s in (64, 1000, 16, 2048, 128, 512))
    rc, res = _run(capsys, [
        "train", "--config", "tiny", "--table-sizes", sizes,
        "--batch-size", "32", "--steps", "5", "--sharded", "true",
        "--host-tables", "1,3", "--max-rows-per-shard", "1500",
        "--update-interval", "2", "--log-every", "2", "--eval-after",
        "--eval-steps", "2"])
    assert rc == 0
    assert res["steps"] == 5 and np.isfinite(res["final_loss"])


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_two_tier_ckpt_resume_eval(tmp_path, capsys, optimizer):
    """Two-tier (--hbm-budget-gb) runs checkpoint and resume — the host
    tier (and its Adagrad accumulator) re-pins to pinned_host on restore —
    and `eval --ckpt-dir` reassembles the tier split via run_meta.json."""
    from dlrm_tpu.parallel import host_tier as ht
    if not ht.host_memory_supported():
        pytest.skip("no pinned_host memory space")
    paths = _write_text_shards(tmp_path)
    out = str(tmp_path / "data.bin")
    _run(capsys, ["preprocess", *paths, "--out", out])
    sizes = ",".join("1000" for _ in range(26))
    ckpt = str(tmp_path / "ck")
    common = ["--config", "tiny", "--table-sizes", sizes,
              "--batch-size", "16"]
    # 0.0001 GiB ~= 107 KB: 3 of the 26 32KB tables stay on device, the
    # rest spill to pinned host — both tiers non-empty (a checkpoint
    # requirement: orbax cannot serialize zero-size arrays)
    targs = ["train", *common, "--data", out, "--sharded", "false",
             "--hbm-budget-gb", "0.0001", "--optimizer", optimizer,
             "--lr", "0.05", "--log-every", "2", "--ckpt-dir", ckpt,
             "--save-interval", "4"]
    rc, res = _run(capsys, [*targs, "--eval-after"])
    assert rc == 0 and res["steps"] == 7
    meta = json.load(open(os.path.join(ckpt, "run_meta.json")))
    assert meta["two_tier"] and meta["hbm_budget_gb"] == 0.0001

    # resume continues from the saved step (host tier + accumulator kept)
    rc, res2 = _run(capsys, [*targs, "--eval-after"])
    assert rc == 0 and res2["steps"] == 7

    # eval from the checkpoint == the resumed run's own --eval-after
    rc, ev = _run(capsys, ["eval", *common, "--data", out,
                           "--ckpt-dir", ckpt])
    assert rc == 0
    np.testing.assert_allclose(ev["loss"], res2["eval"]["loss"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ev["auc"], res2["eval"]["auc"], atol=1e-9)


def test_train_cli_bf16_tables(capsys):
    """--bf16-tables trains with bfloat16 embedding storage end-to-end
    (single-chip and sharded)."""
    for extra in (["--sharded", "false"], ["--sharded", "true"]):
        rc, res = _run(capsys, [
            "train", "--config", "tiny", "--batch-size", "32",
            "--steps", "3", "--bf16-tables", "--log-every", "1",
            "--eval-after", "--eval-steps", "2", *extra])
        assert rc == 0
        assert res["steps"] == 3 and np.isfinite(res["final_loss"])


def test_predict_cli(tmp_path, capsys):
    """Batch serving: predict writes scores aligned with the dataset and
    matching eval's forward."""
    paths = _write_text_shards(tmp_path)
    out = str(tmp_path / "data.bin")
    _run(capsys, ["preprocess", *paths, "--out", out])
    sizes = ",".join("1000" for _ in range(26))
    ckpt = str(tmp_path / "ck")
    common = ["--config", "tiny", "--table-sizes", sizes,
              "--batch-size", "16"]
    _run(capsys, ["train", *common, "--data", out, "--sharded", "false",
                  "--log-every", "5", "--ckpt-dir", ckpt,
                  "--save-interval", "100"])
    scores_path = str(tmp_path / "scores.npy")
    rc, res = _run(capsys, ["predict", *common, "--data", out,
                            "--ckpt-dir", ckpt, "--out", scores_path])
    assert rc == 0 and res["examples"] == 120  # every row scored
    scores = np.load(scores_path)
    assert scores.shape == (120,)
    assert np.all((scores >= 0) & (scores <= 1))
    np.testing.assert_allclose(res["mean_score"], float(scores.mean()),
                               rtol=1e-6)
    # oracle: the library forward on the restored checkpoint over the
    # same loader must reproduce the scores exactly, in order
    import dataclasses as _dc
    import jax, jax.numpy as jnp
    import dlrm_tpu
    from dlrm_tpu.data.criteo import DACLoader, load as dac_load
    from dlrm_tpu.io.checkpoint import restore_checkpoint
    config = _dc.replace(dlrm_tpu.tiny_config(),
                         table_sizes=tuple([1000] * 26))
    template = jax.eval_shape(
        lambda: dlrm_tpu.init_params(jax.random.key(0), config))
    params, _ = restore_checkpoint(ckpt, template=template)
    params = jax.tree.map(jnp.asarray, params)
    want = []
    for b in DACLoader(dac_load(out), 16, drop_remainder=False):
        want.append(np.asarray(dlrm_tpu.forward(
            params, jnp.asarray(b["dense"]), jnp.asarray(b["sparse"]),
            config)))
    np.testing.assert_allclose(scores, np.concatenate(want),
                               rtol=1e-6, atol=1e-7)


def test_predict_cli_sharded_on_mesh(tmp_path, capsys):
    """predict from a SHARDED checkpoint scores ON the mesh (tables never
    unsharded — the Terabyte serving path), including a ragged tail padded
    to a mesh multiple; scores must equal the unshard-based forward."""
    paths = _write_text_shards(tmp_path)
    out = str(tmp_path / "data.bin")
    _run(capsys, ["preprocess", *paths, "--out", out])
    sizes = ",".join("1000" for _ in range(26))
    ckpt = str(tmp_path / "ck")
    common = ["--config", "tiny", "--table-sizes", sizes,
              "--batch-size", "16"]
    _run(capsys, ["train", *common, "--data", out, "--sharded", "true",
                  "--host-tables", "1", "--log-every", "5",
                  "--ckpt-dir", ckpt, "--save-interval", "100"])
    scores_path = str(tmp_path / "scores.npy")
    rc, res = _run(capsys, ["predict", *common, "--data", out,
                            "--ckpt-dir", ckpt, "--out", scores_path])
    assert rc == 0 and res["examples"] == 120  # 120 % 16 => ragged tail
    scores = np.load(scores_path)
    assert scores.shape == (120,)

    # oracle: unshard via _load_eval_params (the old path) and score with
    # the library forward — identical predictions, in order
    import argparse, dataclasses as _dc
    import jax, jax.numpy as jnp
    import dlrm_tpu
    config = _dc.replace(dlrm_tpu.tiny_config(),
                         table_sizes=tuple([1000] * 26))
    params, config2 = cli._load_eval_params(
        argparse.Namespace(ckpt_dir=ckpt, hdf5=None), config)
    want = []
    for b in DACLoader(load(out), 16, drop_remainder=False):
        want.append(np.asarray(dlrm_tpu.forward(
            params, jnp.asarray(b["dense"]), jnp.asarray(b["sparse"]),
            config2)))
    np.testing.assert_allclose(scores, np.concatenate(want),
                               rtol=1e-5, atol=1e-6)


def test_eval_cli_sharded_on_mesh(tmp_path, capsys):
    """eval --ckpt-dir on a sharded checkpoint runs on the mesh and
    matches the unshard-based eval (loss/accuracy)."""
    paths = _write_text_shards(tmp_path)
    out = str(tmp_path / "data.bin")
    _run(capsys, ["preprocess", *paths, "--out", out])
    sizes = ",".join("1000" for _ in range(26))
    ckpt = str(tmp_path / "ck")
    common = ["--config", "tiny", "--table-sizes", sizes,
              "--batch-size", "16"]
    _run(capsys, ["train", *common, "--data", out, "--sharded", "true",
                  "--log-every", "5", "--ckpt-dir", ckpt,
                  "--save-interval", "100"])
    rc, ev_mesh = _run(capsys, ["eval", *common, "--data", out,
                                "--ckpt-dir", ckpt])
    assert rc == 0
    # batch size not divisible by the mesh -> falls back to unshard path
    rc, ev_host = _run(capsys, ["eval", "--config", "tiny",
                                "--table-sizes", sizes,
                                "--batch-size", "12", "--data", out,
                                "--ckpt-dir", ckpt])
    assert rc == 0
    np.testing.assert_allclose(ev_mesh["loss"], ev_host["loss"],
                               rtol=1e-4)
    assert abs(ev_mesh["accuracy"] - ev_host["accuracy"]) < 0.05


def test_export_cli_roundtrip(tmp_path, capsys):
    """export writes the PyTorch-interop HDF5 from ANY run's checkpoint
    (here a sharded one, exercising the unshard path); loading it back
    reproduces the checkpoint's forward exactly."""
    import h5py
    import jax, jax.numpy as jnp
    import dlrm_tpu
    from dlrm_tpu.io import hdf5 as h5io

    paths = _write_text_shards(tmp_path)
    out = str(tmp_path / "data.bin")
    _run(capsys, ["preprocess", *paths, "--out", out])
    sizes = ",".join("1000" for _ in range(26))
    ckpt = str(tmp_path / "ck")
    common = ["--config", "tiny", "--table-sizes", sizes,
              "--batch-size", "16"]
    _run(capsys, ["train", *common, "--data", out, "--sharded", "true",
                  "--log-every", "5", "--ckpt-dir", ckpt,
                  "--save-interval", "100"])
    h5_path = str(tmp_path / "model.hdf5")
    rc, res = _run(capsys, ["export", "--config", "tiny", "--table-sizes",
                            sizes, "--ckpt-dir", ckpt, "--out", h5_path])
    assert rc == 0 and res["tables"] == 26
    with h5py.File(h5_path, "r") as f:
        assert "emb_0" in f and "bot_l.0.weight" in f
        assert f["emb_0"].shape == (1000, 8)

    # round-trip: load_params + forward == the checkpoint's eval forward
    params_h, config_h = h5io.load_params(h5_path)
    params_h = jax.tree.map(jnp.asarray, params_h)
    rc, ev = _run(capsys, ["eval", *common, "--data", out,
                           "--ckpt-dir", ckpt, "--eval-steps", "2"])
    from dlrm_tpu.train.metrics import evaluate
    data_iter = [b for i, b in zip(
        range(2), DACLoader(load(out), 16))]
    m = evaluate(params_h, data_iter, config_h)
    np.testing.assert_allclose(m["loss"], ev["loss"], rtol=1e-5,
                               atol=1e-6)


def test_train_cli_epochs(tmp_path, capsys):
    """--epochs N trains N full passes over the dataset."""
    paths = _write_text_shards(tmp_path)
    out = str(tmp_path / "data.bin")
    _run(capsys, ["preprocess", *paths, "--out", out])
    sizes = ",".join("1000" for _ in range(26))
    rc, res = _run(capsys, [
        "train", "--config", "tiny", "--table-sizes", sizes,
        "--batch-size", "16", "--data", out, "--epochs", "2",
        "--sharded", "false", "--shuffle", "--log-every", "5"])
    assert rc == 0
    assert res["steps"] == 2 * (120 // 16)


def test_chunk_budget_flag_and_ckpt_geometry_roundtrip(tmp_path, capsys):
    """--chunk-budget-mb changes the chunk split; eval --ckpt-dir rebuilds
    the TRAINING run's geometry from run_meta.json even when its own
    (batch-size-keyed) default budget differs."""
    import argparse
    from dlrm_tpu.run import _build_config

    # flag plumbing: 4 tables x ~1.9 MB packed -> 2 MB budget = 4 chunks,
    # default 16 MB = 1 chunk
    sizes = ",".join("60000" for _ in range(4))
    base = dict(config="tiny", feature_size=16, interaction=None,
                n_hot=None, bf16=False, pad_to=None, table_sizes=sizes,
                batch_size=16)
    c_small = _build_config(argparse.Namespace(**base, chunk_budget_mb=2))
    c_auto = _build_config(argparse.Namespace(**base, chunk_budget_mb=None))
    assert c_small.chunk_budget_bytes == 2 << 20
    assert c_small.num_chunks > c_auto.num_chunks == 1

    paths = _write_text_shards(tmp_path)
    out = str(tmp_path / "data.bin")
    _run(capsys, ["preprocess", *paths, "--out", out])
    ckpt = str(tmp_path / "ck")
    common = ["--config", "tiny", "--table-sizes", sizes,
              "--batch-size", "16"]
    rc, res = _run(capsys, [
        "train", *common, "--data", out, "--chunk-budget-mb", "2",
        "--ckpt-dir", ckpt, "--save-interval", "4", "--eval-after"])
    assert rc == 0
    meta = json.loads(open(os.path.join(ckpt, "run_meta.json")).read())
    assert meta["chunk_budget_bytes"] == 2 << 20

    # eval WITHOUT the flag must restore the 2 MB-geometry checkpoint
    rc, ev = _run(capsys, ["eval", *common, "--data", out,
                           "--ckpt-dir", ckpt])
    assert rc == 0
    np.testing.assert_allclose(ev["loss"], res["eval"]["loss"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ev["auc"], res["eval"]["auc"], atol=1e-9)


def test_terabyte_preset_cli_scaled_down(tmp_path, capsys):
    """The terabyte preset (fs=128 default, criteo.jl:379-406) drives the
    production CLI end-to-end at scaled-down table sizes: pack=1 chunked
    storage, sharded rowwise-adagrad blocks, eval-after."""
    sizes = ",".join(str(s) for s in (4000, 120, 9000, 64) * 2)
    rc, res = _run(capsys, [
        "train", "--config", "terabyte", "--table-sizes", sizes,
        "--batch-size", "32", "--steps", "6", "--sharded", "true",
        "--optimizer", "rowwise_adagrad", "--update-interval", "2",
        "--block-scan", "--lr", "0.002", "--eval-after",
        "--eval-steps", "2"])
    assert rc == 0 and res["steps"] == 6
    assert np.isfinite(res["final_loss"])
    # sane, non-saturated model (adagrad first steps are sign-updates of
    # magnitude lr per element: at fs=128's wide rows lr=0.05 saturates
    # the interaction inputs within steps — hence the small lr here)
    assert res["eval"]["loss"] < 1.5
    assert 0.0 <= res["eval"]["accuracy"] <= 1.0
    # the preset's fs=128 geometry: pack=1, engine storage still chunked
    import argparse
    from dlrm_tpu.run import _build_config
    c = _build_config(argparse.Namespace(
        config="terabyte", feature_size=128, interaction=None, n_hot=None,
        bf16=False, pad_to=None, table_sizes=sizes, batch_size=32,
        chunk_budget_mb=None))
    assert c.feature_size == 128 and c.pack == 1 and c.is_packed


def test_auto_interaction_impl_keying(monkeypatch):
    """The interaction default is keyed to what can run it: the fused GPU
    kernel on one GPU at a shape it takes (config.default_interaction_impl),
    gram elsewhere — on the CPU, under a mesh, at unsupported widths; an
    explicit --interaction always wins."""
    import argparse
    import dataclasses
    import jax

    from dlrm_tpu import config as cfg
    from dlrm_tpu.run import _build_config

    k16, k128 = cfg.kaggle_config(16), cfg.kaggle_config(128)
    assert cfg.default_interaction_impl(k16, "gpu", True) == "fused"
    assert cfg.default_interaction_impl(k128, "gpu", True) == "fused"
    assert cfg.default_interaction_impl(k128, "gpu", False) == "gram"
    assert cfg.default_interaction_impl(k128, "cpu", True) == "gram"
    narrow = dataclasses.replace(k16, bottom_mlp_sizes=(13, 64, 8),
                                 feature_size=8)
    assert cfg.default_interaction_impl(narrow, "gpu", True) == "gram"

    base = dict(config="terabyte", feature_size=128, n_hot=None,
                bf16=False, pad_to=None,
                table_sizes=",".join(["64"] * 8), batch_size=32,
                chunk_budget_mb=None)
    # CPU backend (the test environment): the compiled gram
    c = _build_config(argparse.Namespace(**base, interaction=None))
    assert c.interaction_impl == "gram"
    # GPU backend: 8 visible devices means the sharded path -> gram; one
    # device (--sharded false) -> the fused kernel, at fs=128 and fs=16
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    c = _build_config(argparse.Namespace(**base, interaction=None))
    assert c.interaction_impl == "gram"
    c = _build_config(argparse.Namespace(**base, interaction=None,
                                         sharded=False))
    assert c.interaction_impl == "fused"
    c = _build_config(argparse.Namespace(
        **{**base, "feature_size": 16}, interaction=None, sharded=False))
    assert c.interaction_impl == "fused"
    # explicit flag overrides the auto choice
    c = _build_config(argparse.Namespace(**base, interaction="gram",
                                         sharded=False))
    assert c.interaction_impl == "gram"


def test_interaction_pallas_rejected(capsys):
    """The old "pallas" kernel is gone: --interaction pallas is refused at
    argument time, and a library config naming it fails at construction."""
    from dlrm_tpu import config as cfg
    from dlrm_tpu.run import main

    with pytest.raises(SystemExit) as e:
        main(["train", "--config", "tiny", "--interaction", "pallas",
              "--steps", "1"])
    assert e.value.code == 2
    assert "invalid choice: 'pallas'" in capsys.readouterr().err
    with pytest.raises(ValueError, match="interaction_impl 'pallas'"):
        cfg.tiny_config().__class__(
            bottom_mlp_sizes=(13, 8), top_mlp_sizes=(4, 1), feature_size=8,
            table_sizes=(4, 4), interaction_impl="pallas")


def test_sharded_path_refuses_fused_interaction():
    """Under a mesh the kernel would see the global batch: every sharded
    builder refuses interaction_impl='fused' up front."""
    import dataclasses

    from dlrm_tpu import config as cfg
    from dlrm_tpu.parallel.mesh import make_mesh
    from dlrm_tpu.parallel.placement import plan_placement
    from dlrm_tpu.train import metrics, train

    config = dataclasses.replace(cfg.tiny_config(feature_size=16),
                                 interaction_impl="fused")
    mesh = make_mesh(2)
    placement = plan_placement(config.table_sizes, 2, pack=config.pack)
    for build in (
            lambda: train.make_sharded_train_step(config, 0.1, mesh,
                                                  placement),
            lambda: train.make_sharded_train_block(config, 0.1, mesh,
                                                   placement),
            lambda: train.make_sharded_train_step_opt(
                config, optimizer="adagrad", lr=0.1, mesh=mesh,
                placement=placement),
            lambda: metrics.make_sharded_eval_forward(config, mesh,
                                                      placement)):
        with pytest.raises(ValueError, match="fused"):
            build()
