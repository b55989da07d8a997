"""chip_smoke.py on the CPU: its reference comparison (phase 3) on tiny
configs, and its refusals — off the GPU, and apart from the repo."""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dlrm_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def _config(feature_size, threshold):
    """Kaggle-shaped but tiny: big tables take the packed gather/scatter
    path, tables at or under ``threshold`` rows the dense-gradient one."""
    return dataclasses.replace(
        dlrm_tpu.tiny_config(num_tables=5, rows=64,
                             feature_size=feature_size),
        table_sizes=(3000, 40, 1500, 7, 900),
        small_table_threshold=threshold,
        chunk_budget_bytes=64 << 10)


def _skewed(config, batch, seed=1):
    return chip_smoke.skewed_batch(config, batch, seed=seed)


@pytest.mark.parametrize("feature_size,threshold", [
    (16, 64),    # pack 8, two small tables
    (8, 0),      # pack 16, every table on the scatter path
    (32, 2000),  # pack 4, most tables dense-gradient
])
def test_reference_comparison_passes_on_the_engine(feature_size,
                                                   threshold):
    config = _config(feature_size, threshold)
    params = dlrm_tpu.init_params(jax.random.key(0), config)
    batch = _skewed(config, 256)
    assert chip_smoke.dup_share(batch["sparse"]) > 0.3  # duplicates occur
    rep = chip_smoke.compare_with_reference(config, params, batch, 0.5)
    chip_smoke.check_reference_report(rep)
    assert rep["touched_rows"] == len(np.unique(
        batch["sparse"] + np.asarray(config.table_offsets)))


def test_reference_comparison_catches_a_wrong_update():
    """The comparison has teeth: a step that drops duplicate-id gradient
    sums (.set instead of .add) fails it."""
    config = _config(16, 0)
    params = dlrm_tpu.init_params(jax.random.key(0), config)
    batch = _skewed(config, 256)
    good = dlrm_tpu.make_jit_train_step(config, 0.5)

    def broken(p, d, s, l):
        new, loss = good(jax.tree.map(jnp.copy, p), d, s, l)
        emb = list(new["emb"])
        emb[0] = p["emb"][0]  # first chunk never updated
        return {**new, "emb": tuple(emb)}, loss

    rep = chip_smoke.compare_with_reference(config, params, batch, 0.5,
                                            step=broken)
    with pytest.raises(AssertionError):
        chip_smoke.check_reference_report(rep)


def test_logged_losses_reads_the_cli_status_lines():
    err = ("devices: 1 (gpu), sharded=False\n"
           "step 1 loss 0.69312 (32,768 examples/s)\n"
           "step 2 loss 0.69001 (65,536 examples/s)\n")
    assert chip_smoke.logged_losses(err) == [0.69312, 0.69001]


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_smoke_refuses_the_cpu():
    proc = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert proc.returncode != 0
    assert "needs a GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_smoke_alone_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in
                   proc.stdout.splitlines())
