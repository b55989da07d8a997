"""What the JAX backend can do, asked of the backend itself.

Every device-dependent choice in the package goes through this module, and
each answer comes from compiling a tiny program rather than from the
platform's name: the CPU backend lists a ``pinned_host`` memory space yet
cannot place a jit output there, so neither the name nor the memory list
says whether the host tier can keep its stack pinned across steps.

Also here: the compile-cache setup the entry points share, the GPU check
that measurement paths use to refuse the CPU, and the card's name and power
limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import functools
import os
import subprocess
from typing import Optional

import jax
import jax.numpy as jnp

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache: a fixed path, because the path is part of what the
# cache is keyed on (a directory that moves never hits)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    this leaves the setting alone; otherwise the cache goes to
    ``<checkout>/.jax_cache``.  Returns the directory in use.  Called by the
    entry points (``run.main``, ``bench.py``, ``chip_smoke.py``), never on
    import."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def require_gpu(what: str = "this measurement"):
    """The visible devices, or SystemExit when they are not GPUs: a time
    taken on the CPU must never stand in for one taken on the card."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"{what} needs a GPU; JAX found {len(devs)} "
            f"'{devs[0].platform}' device(s)")
    return devs


def device_record(devices=None) -> dict:
    """The device as JAX reports it: platform, device_kind and count."""
    devs = devices if devices is not None else jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_and_power() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, read by
    a child process that never imports JAX; None where there is no
    ``nvidia-smi``."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip() if proc.returncode == 0 else None


def _default_device(device):
    return device if device is not None else jax.devices()[0]


@functools.lru_cache(maxsize=None)
def _pins_outputs(device) -> bool:
    from jax.experimental import compute_on

    # the host tier's pattern: a pinned operand updated by host compute and
    # returned pinned
    sh = jax.sharding.SingleDeviceSharding(device, memory_kind="pinned_host")

    def probe(x):
        with compute_on.compute_on("device_host"):
            return x * 2

    try:
        jax.jit(probe, out_shardings=sh).lower(jax.ShapeDtypeStruct(
            (8,), jnp.float32, sharding=sh)).compile()
    except jax.errors.JaxRuntimeError:
        return False
    return True


def can_pin_host_outputs(device=None) -> bool:
    """True when a jitted program can place an output in ``pinned_host``
    memory on ``device`` (default: the first device).

    Where it can, the host tier's train steps donate the host stack and
    pin their output back to host memory, so the stack never comes through
    device memory between steps.  Where it cannot (the CPU backend has no
    output-placement annotation), they run without donation and the
    updated stack returns in default memory: same numerics.  Cached per
    device; the probe compiles one 8-element program."""
    device = _default_device(device)
    if "pinned_host" not in {m.kind for m in device.addressable_memories()}:
        return False
    return _pins_outputs(device)


@functools.lru_cache(maxsize=None)
def _computes_on_host(device) -> bool:
    from jax.experimental import compute_on

    def probe(x):
        xh = jax.device_put(x, jax.memory.Space.Host)
        with compute_on.compute_on("device_host"):
            y = xh * 2
        return jax.device_put(y, jax.memory.Space.Device)

    try:
        jax.jit(probe).lower(jax.ShapeDtypeStruct(
            (8,), jnp.float32,
            sharding=jax.sharding.SingleDeviceSharding(device))).compile()
    except jax.errors.JaxRuntimeError:
        return False
    return True


def host_compute_supported(device=None) -> bool:
    """True when XLA lowers ``compute_on("device_host")`` regions on
    ``device`` — what the host tier's gather and scatter run in
    (parallel/host_tier.py).  Cached per device."""
    return _computes_on_host(_default_device(device))
