"""Backend capability checks (dlrm_tpu/utils/backend.py): every device-
dependent choice asks the backend what it can do, never its name."""

import os
import subprocess
import sys

import jax
import pytest

from dlrm_tpu.utils import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_follows_the_environment(monkeypatch):
    """Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and the
    helper leaves JAX's setting alone."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(backend.CACHE_ENV, "/somewhere/else")
    assert backend.setup_compile_cache() == "/somewhere/else"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_a_fixed_path_in_the_checkout():
    """Unset: <checkout>/.jax_cache, the same path in every process (a
    child, so this test process keeps its own cache setting)."""
    env = {k: v for k, v in os.environ.items() if k != backend.CACHE_ENV}
    env["JAX_PLATFORMS"] = "cpu"
    code = ("import jax; from dlrm_tpu.utils import backend; "
            "print(backend.setup_compile_cache()); "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    want = os.path.join(REPO, ".jax_cache")
    assert out.stdout.split() == [want, want]


def test_compile_cache_is_not_set_on_import():
    env = {k: v for k, v in os.environ.items() if k != backend.CACHE_ENV}
    code = ("import jax, dlrm_tpu, dlrm_tpu.run, dlrm_tpu.utils.backend; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(env, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "None"


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="needs a GPU; JAX found 8 'cpu'"):
        backend.require_gpu("the benchmark")


def test_device_record_names_platform_kind_and_count():
    assert backend.device_record() == {"platform": "cpu", "kind": "cpu",
                                       "count": 8}


def test_gpu_name_and_power_without_nvidia_smi(monkeypatch):
    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(backend.subprocess, "run", missing)
    assert backend.gpu_name_and_power() is None


def test_cpu_cannot_pin_jit_outputs_but_computes_on_host():
    """JAX 0.9's CPU backend lists pinned_host, yet cannot place a jit
    output there; the probe asks the compiler, not the memory list."""
    dev = jax.devices()[0]
    assert "pinned_host" in {m.kind for m in dev.addressable_memories()}
    assert backend.can_pin_host_outputs() is False
    assert backend.host_compute_supported() is True


class _FakeMemory:
    def __init__(self, kind):
        self.kind = kind


class _FakeDevice:
    """A device with no pinned_host memory space."""
    platform = "gpu"

    def addressable_memories(self):
        return [_FakeMemory("device")]


def test_no_pinned_memory_means_no_pinning_and_no_host_tier():
    dev = _FakeDevice()
    assert backend.can_pin_host_outputs(dev) is False
    from dlrm_tpu.parallel import host_tier as ht
    assert ht.host_memory_supported(dev) is False
    with pytest.raises(ValueError, match="no pinned_host memory space"):
        ht._host_sharding(dev)


@pytest.mark.parametrize("can_pin", [True, False])
def test_capability_chooses_pinning(monkeypatch, can_pin):
    """Where outputs can be pinned, the tiered step donates the host stack
    and pins its output back to pinned_host; where not, it does neither
    (the CPU's route)."""
    import dlrm_tpu
    from dlrm_tpu.parallel import host_tier as ht

    calls = []
    monkeypatch.setattr(ht, "can_pin_host_outputs", lambda dev: can_pin)
    monkeypatch.setattr(jax, "jit",
                        lambda fn, **kw: calls.append(kw) or fn)
    config = dlrm_tpu.tiny_config(num_tables=2, rows=16, feature_size=8)
    plan = ht.plan_tiers(config, 16 * 8 * 4)
    ht.make_tiered_train_step(config, 0.1, plan)
    kw = calls[-1]
    if can_pin:
        assert kw["donate_argnums"] == (0,)
        assert kw["out_shardings"][0]["emb_host"].memory_kind == \
            "pinned_host"
    else:
        assert kw == {}


def test_host_tier_flags_refused_where_host_compute_is_missing(monkeypatch):
    from dlrm_tpu import run

    monkeypatch.setattr(backend, "host_compute_supported", lambda: False)
    for flag in (["--hbm-budget-gb", "0.001", "--sharded", "false"],
                 ["--host-tables", "1", "--sharded", "true"]):
        with pytest.raises(SystemExit, match="compute_on"):
            run.main(["train", "--config", "tiny", "--steps", "1",
                      "--batch-size", "8"] + flag)


def test_probe_results_are_cached(monkeypatch):
    dev = jax.devices()[0]
    first = (backend.host_compute_supported(dev),
             backend.can_pin_host_outputs(dev))
    monkeypatch.setattr(jax, "jit", lambda *a, **k: pytest.fail("re-probed"))
    assert (backend.host_compute_supported(dev),
            backend.can_pin_host_outputs(dev)) == first == (True, False)
