"""Drive bench.py's full section sequence on CPU (--smoke).

The bench script's SECTION SEQUENCE is itself a correctness surface (a
section that reuses another's params under a different chunk geometry
crashes only there).  This test runs every section on tiny shapes and
asserts the final JSON line prints with every section's fragment present
and no ``*_error`` keys.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_bench_smoke_sequence_end_to_end():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--smoke"],
        env=env, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    last = proc.stdout.strip().splitlines()[-1]
    out = json.loads(last)
    errors = {k: v for k, v in out.items() if k.endswith("_error")}
    assert not errors, errors
    # every section's fragment must be present (block/K keys use the
    # smoke block size K=2)
    for key in ("value", "fs16_sgd_examples_per_s", "block2_examples_per_s",
                "adagrad_examples_per_s",
                "adagrad_block2_examples_per_s", "lookup_gb_s_logical",
                "b2048_examples_per_s", "eval_examples_per_s",
                "hosttier_b128_examples_per_s",
                "hosttier_block2_b128_examples_per_s",
                "fs128_sgd_gram_examples_per_s",
                "fs128_rowwise_adagrad_examples_per_s",
                "fs128_lookup_gb_s_logical",
                "fs128_sgd_block2_examples_per_s",
                "fs128_predict_examples_per_s",
                "fs128_int8_predict_examples_per_s"):
        assert key in out, f"missing fragment {key}: {out}"
        assert out[key] > 0, (key, out[key])


def _bench():
    sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        sys.path.remove(REPO)
    return bench


def test_time_window_ends_each_window_on_the_results(monkeypatch):
    """Every timing window ends in jax.block_until_ready on what its steps
    returned (JAX returns before the device finishes), and the median of
    the per-window step times is the result."""
    import jax

    bench = _bench()
    synced, clock = [], iter([0.0, 1.0, 1.0, 4.0, 4.0, 6.0])
    monkeypatch.setattr(jax, "block_until_ready",
                        lambda x: synced.append(x) or x)
    monkeypatch.setattr(bench.time, "perf_counter", lambda: next(clock))
    secs, per = bench.time_window(lambda n: ("state", n), n=2, repeats=3)
    assert synced == [("state", 2)] * 3
    assert per == [0.5, 1.5, 1.0]
    assert secs == 1.0


def test_bench_refuses_the_cpu_without_smoke():
    """Off the GPU the benchmark stops before any section: a CPU time must
    never be reported as a device number."""
    bench = _bench()
    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.run(smoke=False)


def test_bench_exits_nonzero_on_a_section_error(monkeypatch, capsys):
    bench = _bench()
    import dlrm_tpu.utils.backend as backend

    def boom(ctx, out):
        raise RuntimeError("section broke")

    monkeypatch.setattr(backend, "setup_compile_cache", lambda: None)
    monkeypatch.setattr(bench, "SECTIONS", (("boom", boom),))
    monkeypatch.setattr(sys, "argv", ["bench.py", "--smoke"])
    assert bench.main() == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["boom_error"] == "RuntimeError: section broke"
    assert out["device"]["platform"] == "cpu" and out["smoke"] is True


@pytest.mark.slow
def test_auc_curve_script_tiny():
    """make_auc_curve.py --tiny end-to-end on CPU: the AUC-curve script
    must stay runnable, not a one-off session."""
    out = os.path.join(REPO, ".pytest_auc_tiny.json")
    try:
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "make_auc_curve.py"),
             "--tiny", "--feature-size", "16", "--batch-size", "256",
             "--steps", "40", "--eval-every", "20", "--eval-batches",
             "2", "--out", out],
            env=env, capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-3000:]
        payload = json.loads(open(out).read())
        curve = payload["curve"]
        assert len(curve) == 3
        for row in curve:
            for key in ("accuracy", "auc", "loss", "examples", "step",
                        "wall_s"):
                assert key in row
        # the planted-truth task is learnable: AUC must rise from chance
        assert curve[-1]["auc"] > curve[0]["auc"] + 0.05
    finally:
        if os.path.exists(out):
            os.remove(out)
