"""Synthetic-throughput benchmark of the DLRM training path on one GPU.

Runs the jitted train steps (forward + backward + dense update + sparse
embedding update, donated buffers) on synthetic Kaggle-shaped batches that
live on the device, and prints ONE JSON line of examples/s per section:

    {"metric": ..., "value": N, "unit": "examples/s/chip", "device": {...},
     "card": "<nvidia-smi name, power limit>", ...}

Every timing is the median over ``repeats`` windows of ``n`` steps, each
window ended by ``jax.block_until_ready`` on what its steps produced; the
per-window times are recorded beside each rate (``*_window_ms``).  The
first steps of every program are warm-up (compilation) and untimed.

Sections are fault-isolated: a failure records ``<section>_error`` and
the rest still run, but the script then exits non-zero.  Off the GPU the
benchmark refuses to run; ``--smoke`` runs every section on tiny shapes on
any backend (tests/test_bench_smoke.py) and reports no device numbers.

    python bench.py [--smoke] [--fs128-only]
"""

import dataclasses
import json
import statistics
import sys
import time

import numpy as np

BATCH = 32768          # reference experiment batch (src/DLRM.jl:82-83)
FEATURE_SIZE = 16      # reference kaggle_dlrm default (criteo.jl:412)
METRIC = f"dlrm_kaggle_fs{FEATURE_SIZE}_train_b{BATCH}"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def time_window(run_n, n, repeats):
    """Per-step seconds: the median over ``repeats`` windows, each calling
    ``run_n(n)`` (n steps) and ending in ``jax.block_until_ready`` on what
    it returns.  Returns (median, [per-window seconds per step])."""
    import jax

    per = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run_n(n))
        per.append((time.perf_counter() - t0) / n)
    return statistics.median(per), per


def _record_rate(out, key, batch, secs, per):
    out[f"{key}_examples_per_s"] = round(batch / secs, 1)
    out[f"{key}_window_ms"] = [round(p * 1e3, 4) for p in per]
    return out[f"{key}_examples_per_s"]


class Ctx:
    """Shared state between sections (configs, live params, data)."""

    def __init__(self, smoke):
        self.smoke = smoke
        self.batch = 256 if smoke else BATCH
        self.b2 = 128 if smoke else 2048
        self.be = 512 if smoke else (1 << 16)
        self.block_k = 2 if smoke else 8
        self.n = 2 if smoke else 10
        self.repeats = 1 if smoke else 3
        self.warmup = 2 if smoke else 3
        self.rng = np.random.default_rng(0)
        self.config = None
        self.params = None      # fs=16 params packed under self.config
        self.dense = self.sparse = self.labels = None
        self.block_data = None  # set by sec_fs16_block; regenerated by
        #                         sec_fs16_adagrad_block if that failed

    def make_config(self, feature_size=None, **kw):
        """Kaggle config, or a tiny kaggle-SHAPED config in smoke mode
        (26 tables with a deep-table mix so the 16 MB vs 64 MB chunk
        budgets pack different geometries)."""
        import dlrm_tpu
        fs = feature_size if feature_size is not None else FEATURE_SIZE
        if not self.smoke:
            return dlrm_tpu.kaggle_config(feature_size=fs, **kw)
        from dlrm_tpu.config import DLRMConfig
        sizes = tuple([120_000, 90_000, 60_000] + [2_000] * 23)
        return DLRMConfig(
            bottom_mlp_sizes=(13, 64, 32, fs),
            top_mlp_sizes=(64, 32, 1),
            feature_size=fs,
            table_sizes=sizes,
            **kw,
        )

    def make_batch(self, config, batch):
        rng = self.rng
        dense = np.ascontiguousarray(
            rng.normal(size=(batch, 13)).astype(np.float32))
        sparse = self.ids(config, batch)
        labels = (rng.random(batch) > 0.5).astype(np.float32)
        import jax.numpy as jnp
        return (jnp.asarray(dense), jnp.asarray(sparse), jnp.asarray(labels))

    def ids(self, config, batch, lead=()):
        return np.stack([self.rng.integers(0, s, size=lead + (batch,))
                         for s in config.table_sizes],
                        axis=-1).astype(np.int32)

    def interaction(self, config):
        """What the CLI runs on one device of this backend."""
        import jax
        from dlrm_tpu.config import default_interaction_impl
        return default_interaction_impl(config, jax.default_backend(), True)


def _steady(ctx, step, state, args, n=None, warmup=None):
    """Warm ``step`` up, then time it; ``step(state, *args) -> (state,
    loss)``.  Returns (seconds per step, per-window list, state)."""
    import jax

    box = [state]
    t0 = time.perf_counter()
    for _ in range(ctx.warmup if warmup is None else warmup):
        box[0], _ = step(box[0], *args)
    jax.block_until_ready(box[0])
    log(f"  compile+warmup {time.perf_counter() - t0:.1f} s")

    def run_n(k):
        for _ in range(k):
            box[0], _ = step(box[0], *args)
        return box[0]

    secs, per = time_window(run_n, n or ctx.n, ctx.repeats)
    return secs, per, box[0]


def _opt(step):
    """(params, opt, *batch) step -> the ((params, opt), *batch) form."""
    return lambda state, *a: step(*state, *a)


# -- sections -------------------------------------------------------------------

def sec_fs16_sgd(ctx, out):
    """Headline: exact-SGD train step at B=32768, fs=16, with the
    interaction the CLI picks on one device."""
    import jax
    import dataclasses as dc
    import dlrm_tpu

    config = ctx.make_config()
    config = dc.replace(config, interaction_impl=ctx.interaction(config))
    ctx.config = config
    log(f"model: kaggle fs={config.feature_size}, {config.total_rows:,} "
        f"rows, top_in={config.top_input}, interaction "
        f"{config.interaction_impl}")
    params = dlrm_tpu.init_params(jax.random.key(0), config)
    ctx.dense, ctx.sparse, ctx.labels = ctx.make_batch(config, ctx.batch)
    step = dlrm_tpu.make_jit_train_step(config, lr=0.1)
    secs, per, ctx.params = _steady(ctx, step, params,
                                    (ctx.dense, ctx.sparse, ctx.labels))
    log(f"fs16 sgd: {secs*1e3:.3f} ms -> {ctx.batch / secs:,.0f} ex/s")
    out["value"] = _record_rate(out, "fs16_sgd", ctx.batch, secs, per)


def sec_fs16_block(ctx, out):
    """Coalesced-update block mode (train.train_block, K steps per scatter
    — the reference BatchUpdater relaxation, bounded staleness < K)."""
    import jax
    import jax.numpy as jnp
    import dlrm_tpu
    from dlrm_tpu.train.train import make_jit_train_block

    config, rng, K, B = ctx.config, ctx.rng, ctx.block_k, ctx.batch
    kd = jnp.asarray(rng.normal(size=(K, B, 13)).astype(np.float32))
    ks = jnp.asarray(ctx.ids(config, B, (K,)))
    kl = jnp.asarray((rng.random((K, B)) > 0.5).astype(np.float32))
    ctx.block_data = (kd, ks, kl)
    blk = make_jit_train_block(config, lr=0.1, block=K)
    params = dlrm_tpu.init_params(jax.random.key(0), config)
    secs, per, _ = _steady(ctx, blk, params, (kd, ks, kl))
    secs /= K
    log(f"block K={K}: {secs*1e3:.3f} ms/step -> {B/secs:,.0f} ex/s")
    _record_rate(out, f"block{K}", B, secs, [p / K for p in per])


def sec_fs16_adagrad(ctx, out):
    """Exact per-step Adagrad via the per-chunk HYBRID implementation
    (optim.apply_adagrad_hybrid: dense-G for small chunks, dedup for the
    deep ones)."""
    import jax
    import dlrm_tpu
    from dlrm_tpu.train.train import init_opt_state, make_jit_train_step_opt

    config, B = ctx.config, ctx.batch
    params = dlrm_tpu.init_params(jax.random.key(0), config)
    opt = init_opt_state(params, config=config, optimizer="adagrad", lr=0.01)
    astep = make_jit_train_step_opt(config, optimizer="adagrad", lr=0.01,
                                    emb_impl="hybrid")
    secs, per, _ = _steady(ctx, _opt(astep), (params, opt),
                           (ctx.dense, ctx.sparse, ctx.labels))
    log(f"adagrad exact: {secs*1e3:.3f} ms/step -> {B/secs:,.0f} ex/s")
    _record_rate(out, "adagrad", B, secs, per)


def sec_fs16_adagrad_block(ctx, out):
    """Coalesced adagrad block (dense-G), lax.scan over micro-steps
    (unroll=False: a much faster first compile at a small steady-state
    cost)."""
    import jax
    import jax.numpy as jnp
    import dlrm_tpu
    from dlrm_tpu.train.train import (init_opt_state,
                                      make_jit_train_block_opt)

    config, K, B = ctx.config, ctx.block_k, ctx.batch
    if ctx.block_data is None:
        # sec_fs16_block failed before building the payload — regenerate
        # locally so this section stays fault-isolated from it
        rng = ctx.rng
        ctx.block_data = (
            jnp.asarray(rng.normal(size=(K, B, 13)).astype(np.float32)),
            jnp.asarray(ctx.ids(config, B, (K,))),
            jnp.asarray((rng.random((K, B)) > 0.5).astype(np.float32)))
    params = dlrm_tpu.init_params(jax.random.key(0), config)
    opt = init_opt_state(params, config=config, optimizer="adagrad", lr=0.01)
    ablk = make_jit_train_block_opt(config, optimizer="adagrad", lr=0.01,
                                    block=K, unroll=False)
    secs, per, _ = _steady(ctx, _opt(ablk), (params, opt), ctx.block_data)
    secs /= K
    log(f"adagrad block K={K}: {secs*1e3:.3f} ms/step -> "
        f"{B/secs:,.0f} ex/s")
    _record_rate(out, f"adagrad_block{K}", B, secs, [p / K for p in per])
    ctx.block_data = None  # free the K-step payload


def _lookup_rate(ctx, config, emb, B, key, out):
    """Jitted pooled lookup (mixed engine) alone.  GB/s is LOGICAL
    pooled-row bytes (B * T * D * itemsize) per second."""
    import jax
    import jax.numpy as jnp
    from dlrm_tpu.ops.embedding import mixed_lookup

    ids = jnp.asarray(ctx.ids(config, B))
    look = jax.jit(lambda e, s: mixed_lookup(e, s, config))
    jax.block_until_ready(look(emb, ids))
    secs, per = time_window(
        lambda k: [look(emb, ids) for _ in range(k)][-1], ctx.n,
        ctx.repeats)
    item = jnp.dtype(config.embedding_dtype).itemsize
    gbs = B * config.num_tables * config.feature_size * item / secs / 1e9
    log(f"{key}: {secs*1e3:.3f} ms -> {gbs:.1f} GB/s logical")
    out[f"{key}_gb_s_logical"] = round(gbs, 2)
    out[f"{key}_window_ms"] = [round(p * 1e3, 4) for p in per]


def sec_lookup(ctx, out):
    """Embedding-lookup bandwidth (BASELINE.json metric)."""
    import jax
    import dlrm_tpu

    params = dlrm_tpu.init_params(jax.random.key(0), ctx.config)
    _lookup_rate(ctx, ctx.config, params["emb"], ctx.batch, "lookup", out)


def sec_b2048(ctx, out):
    """Reference-protocol point (BASELINE.md): train at the reference's
    experiment batch B=2048 (script.jl:13) at the chunk budget run.py
    picks for it.  The config2 params live in their OWN variable: the
    eval section later calls forward() on ctx.params under ctx.config."""
    import jax
    import dlrm_tpu
    from dlrm_tpu import config as cfg_mod

    B2 = ctx.b2
    config2 = dataclasses.replace(
        ctx.config,
        chunk_budget_bytes=cfg_mod.auto_chunk_budget_bytes(B2))
    params2 = dlrm_tpu.init_params(jax.random.key(0), config2)
    args = (ctx.dense[:B2], ctx.sparse[:B2], ctx.labels[:B2])
    step2 = dlrm_tpu.make_jit_train_step(config2, lr=0.1)
    secs, per, _ = _steady(ctx, step2, params2, args,
                           n=None if ctx.smoke else 40)
    log(f"train b{B2}: {secs*1e3:.3f} ms/step -> {B2/secs:,.0f} ex/s")
    _record_rate(out, "b2048", B2, secs, per)


def sec_eval(ctx, out):
    """Eval throughput at the reference's 2^16 test batch
    (src/DLRM.jl:89-91): jitted forward only (the serving/eval inner
    loop), on ctx.params — packed under ctx.config."""
    import jax
    import jax.numpy as jnp
    from dlrm_tpu.models.dlrm import forward

    config, BE = ctx.config, ctx.be
    de = jnp.asarray(ctx.rng.normal(size=(BE, 13)).astype(np.float32))
    se = jnp.asarray(ctx.ids(config, BE))
    fwd = jax.jit(lambda p, d, s: forward(p, d, s, config))
    jax.block_until_ready(fwd(ctx.params, de, se))
    secs, per = time_window(
        lambda k: [fwd(ctx.params, de, se) for _ in range(k)][-1], ctx.n,
        ctx.repeats)
    log(f"eval b{BE}: {secs*1e3:.3f} ms -> {BE/secs:,.0f} ex/s")
    _record_rate(out, "eval", BE, secs, per)


def sec_hosttier(ctx, out):
    """Two-tier (device + pinned host) train step at B=8192 — the
    CachedArrays capability point (reference: slow-tier tables trainable
    at useful speed, src/cachedarrays.jl).  State is initialized on the
    device (values don't matter for timing); the batch is
    device-resident, so this is the pure step time."""
    import dataclasses as _dc
    import jax
    import jax.numpy as jnp
    import dlrm_tpu
    from dlrm_tpu.parallel import host_tier as ht

    config, rng = ctx.config, ctx.rng
    B = 128 if ctx.smoke else 8192
    budget = (4 << 20) if ctx.smoke else int(1.5 * (1 << 30))
    plan = ht.plan_tiers(config, budget)
    assert plan.host_tables and plan.device_tables, plan
    sh_host = ht._host_sharding(jax.devices()[0])
    D = config.feature_size
    # dense params from a same-topology tiny-tables config (bottom/top
    # shapes depend on MLP sizes + table COUNT only); device tier in
    # ENGINE chunks per the device sub-config
    small_cfg = _dc.replace(config, table_sizes=(8,) * len(
        config.table_sizes))
    p0 = dlrm_tpu.init_params(jax.random.key(0), small_cfg)
    dev_cfg = ht.device_subconfig(plan, config)
    keys = jax.random.split(jax.random.key(1), len(dev_cfg.emb_shapes) + 1)
    emb_dev = tuple(
        jax.jit(lambda k, s=s: 0.01 * jax.random.normal(
            k, s, jnp.float32))(keys[i])
        for i, s in enumerate(dev_cfg.emb_shapes))
    emb_host = jax.device_put(jax.jit(
        lambda k: 0.01 * jax.random.normal(
            k, (plan.host_rows * D,), jnp.float32))(keys[-1]), sh_host)
    params = {"bottom": p0["bottom"], "top": p0["top"],
              "emb_dev": emb_dev, "emb_host": emb_host}
    p0 = emb_dev = emb_host = None
    d = jnp.asarray(rng.normal(size=(B, 13)).astype(np.float32))
    s = jnp.asarray(ctx.ids(config, B))
    lab = jnp.asarray((rng.random(B) > 0.5).astype(np.float32))
    log(f"hosttier: host tables {list(plan.host_tables)}, "
        f"{plan.host_rows:,} rows pinned")
    step = ht.make_tiered_train_step(config, 0.1, plan)
    secs, per, params = _steady(ctx, step, params, (d, s, lab),
                                n=None if ctx.smoke else 5)
    log(f"hosttier sgd b{B}: {secs*1e3:.3f} ms/step -> {B/secs:,.0f} ex/s")
    _record_rate(out, f"hosttier_b{B}", B, secs, per)

    # coalesced tiered block K: ONE host gather + ONE host scatter per K
    # steps — amortizes the functional host scatter's full-stack copy
    K = ctx.block_k
    kd = jnp.asarray(rng.normal(size=(K, B, 13)).astype(np.float32))
    ks = jnp.asarray(ctx.ids(config, B, (K,)))
    kl = jnp.asarray((rng.random((K, B)) > 0.5).astype(np.float32))
    blk = ht.make_tiered_train_block(config, 0.1, plan)
    secs, per, _ = _steady(ctx, blk, params, (kd, ks, kl),
                           n=None if ctx.smoke else 3)
    secs /= K
    log(f"hosttier sgd block K={K} b{B}: {secs*1e3:.3f} ms/step -> "
        f"{B/secs:,.0f} ex/s")
    _record_rate(out, f"hosttier_block{K}_b{B}", B, secs,
                 [p / K for p in per])


def sec_fs128(ctx, out):
    """fs=128 operating point (the MLPerf/Terabyte feature size,
    criteo.jl:379-406; BASELINE config 4 north star).  pack = 128/128 = 1,
    so lane packing disables.  Kaggle tables at fs=128 are 17.3 GB in
    float32, which one 80 GB card holds."""
    # free the fs=16 model (2.2 GB) first
    ctx.params = ctx.dense = ctx.sparse = ctx.labels = None
    _bench_fs128(ctx, out)


def _bench_fs128(ctx, out):
    """Kaggle fs=128 (pack=1, f32 tables): exact SGD under the gram and
    fused interactions, then rowwise adagrad, pooled lookup, coalesced
    block and int8 quantized serving under the CLI's interaction.  Each
    subsection records its own error and the rest still run."""
    import jax
    import jax.numpy as jnp
    import dlrm_tpu
    from dlrm_tpu.train.train import (init_opt_state, make_jit_train_block,
                                      make_jit_train_step_opt)

    B = ctx.batch
    dense = jnp.asarray(ctx.rng.normal(size=(B, 13)).astype(np.float32))
    labels = jnp.asarray((ctx.rng.random(B) > 0.5).astype(np.float32))
    sparse = jnp.asarray(ctx.ids(ctx.make_config(128), B))
    base = ctx.make_config(feature_size=128)
    impls = ["gram"]
    if ctx.interaction(base) != "gram":
        impls.append(ctx.interaction(base))

    def sub(name, fn):
        try:
            fn()
        except Exception as e:  # record, keep measuring the rest
            log(f"fs128 {name} failed: {type(e).__name__}: {e}")
            out[f"fs128_{name}_error"] = f"{type(e).__name__}: {e}"

    for impl in impls:
        config = dataclasses.replace(base, interaction_impl=impl)

        def sgd(config=config, impl=impl):
            params = dlrm_tpu.init_params(jax.random.key(0), config)
            step = dlrm_tpu.make_jit_train_step(config, lr=0.1)
            t, per, _ = _steady(ctx, step, params,
                                (dense, sparse, labels))
            log(f"fs128 sgd [{impl}]: {t*1e3:.3f} ms/step -> "
                f"{B/t:,.0f} ex/s")
            _record_rate(out, f"fs128_sgd_{impl}", B, t, per)
        sub(f"sgd_{impl}", sgd)
    config = dataclasses.replace(base, interaction_impl=impls[-1])

    def rowwise():
        params = dlrm_tpu.init_params(jax.random.key(0), config)
        opt = init_opt_state(params, config=config,
                             optimizer="rowwise_adagrad", lr=0.01)
        astep = make_jit_train_step_opt(config, optimizer="rowwise_adagrad",
                                        lr=0.01)
        t, per, _ = _steady(ctx, _opt(astep), (params, opt),
                            (dense, sparse, labels))
        log(f"fs128 rowwise adagrad: {t*1e3:.3f} ms/step")
        _record_rate(out, "fs128_rowwise_adagrad", B, t, per)

    def lookup():
        params = dlrm_tpu.init_params(jax.random.key(0), config)
        _lookup_rate(ctx, config, params["emb"], B, "fs128_lookup", out)

    def block():
        K = ctx.block_k
        kd = jnp.asarray(ctx.rng.normal(size=(K, B, 13)).astype(np.float32))
        ks = jnp.asarray(ctx.ids(config, B, (K,)))
        kl = jnp.asarray((ctx.rng.random((K, B)) > 0.5).astype(np.float32))
        params = dlrm_tpu.init_params(jax.random.key(0), config)
        blk = make_jit_train_block(config, lr=0.1)
        t, per, _ = _steady(ctx, blk, params, (kd, ks, kl),
                            n=None if ctx.smoke else 3)
        t /= K
        log(f"fs128 sgd block K={K}: {t*1e3:.3f} ms/step")
        _record_rate(out, f"fs128_sgd_block{K}", B, t, [p / K for p in per])

    def int8():
        # forward-only serving throughput, f32 tables vs int8 + f32 scales;
        # quantize_emb(donate=True) frees each chunk inside its jitted
        # quantization call so both stacks never coexist
        from dlrm_tpu.ops.quant import quantize_emb
        params = dlrm_tpu.init_params(jax.random.key(0), config)
        fwd = jax.jit(lambda p, s: dlrm_tpu.forward(p, dense, s, config))

        def serve(p, key):
            jax.block_until_ready(fwd(p, sparse))
            t, per = time_window(
                lambda k: [fwd(p, sparse) for _ in range(k)][-1], ctx.n,
                ctx.repeats)
            log(f"fs128 predict [{key}]: {t*1e3:.3f} ms")
            _record_rate(out, key, B, t, per)

        serve(params, "fs128_predict")
        q = {"bottom": params["bottom"], "top": params["top"],
             "emb": quantize_emb(params["emb"], config, donate=True)}
        params = None  # emb chunks already freed by donation
        serve(q, "fs128_int8_predict")

    for name, fn in (("rowwise", rowwise), ("lookup", lookup),
                     ("block", block), ("int8", int8)):
        sub(name, fn)


SECTIONS = (
    ("fs16_sgd", sec_fs16_sgd),
    ("fs16_block", sec_fs16_block),
    ("fs16_adagrad", sec_fs16_adagrad),
    ("fs16_adagrad_block", sec_fs16_adagrad_block),
    ("lookup", sec_lookup),
    ("b2048", sec_b2048),
    ("eval", sec_eval),
    ("hosttier", sec_hosttier),
    ("fs128", sec_fs128),
)


def run(smoke=False, only=None):
    """Run the section sequence; returns the result dict (also printed as
    the final JSON line).  ``only``: iterable of section names to run."""
    from dlrm_tpu.utils import backend

    devices = (backend.require_gpu("bench.py (use --smoke off the GPU)")
               if not smoke else None)
    ctx = Ctx(smoke)
    out = {"metric": METRIC, "value": 0, "unit": "examples/s/chip",
           "device": backend.device_record(devices),
           "card": backend.gpu_name_and_power(),
           "smoke": smoke}
    log(f"device: {out['device']}, card: {out['card']}")
    for name, fn in SECTIONS:
        if only is not None and name not in only:
            continue
        try:
            fn(ctx, out)
        except Exception as e:
            log(f"section {name} failed: {type(e).__name__}: {e}")
            out[f"{name}_error"] = f"{type(e).__name__}: {e}"
        # emit the fragment as it lands so a later hard crash (OOM abort)
        # still leaves every finished number in the log
        log(f"[fragment after {name}] {json.dumps(out)}")
    if only == ("fs128",):
        out["metric"] = f"dlrm_kaggle_fs128_train_b{BATCH}"
        out["value"] = max((v for k, v in out.items()
                            if k.startswith("fs128_sgd_")
                            and k.endswith("_examples_per_s")), default=0)
    print(json.dumps(out))
    return out


def main():
    from dlrm_tpu.utils.backend import setup_compile_cache

    smoke = "--smoke" in sys.argv
    only = ("fs128",) if "--fs128-only" in sys.argv else None
    setup_compile_cache()
    out = run(smoke=smoke, only=only)
    errors = sorted(k for k in out if k.endswith("_error"))
    if errors:
        log(f"sections failed: {errors}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
