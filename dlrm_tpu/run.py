"""Command-line driver: the reference's ``script.jl`` / ``@setup`` reborn.

The reference configures experiments with Julia keyword args and an
``@setup`` macro (/root/reference/src/DLRM.jl:44-110, script.jl); SURVEY.md
§5 calls for a real config + CLI system.  Subcommands:

  preprocess   Criteo text -> binarized + vocab-reindexed dataset
  train        train a DLRM (synthetic or Criteo data), checkpoints + eval
  eval         accuracy / ROC-AUC / loss over a dataset
  predict      batch CTR scoring -> .npy (the serving surface)
  export       checkpoint -> PyTorch-interop HDF5 (io/hdf5.save_params)
  validate     PyTorch-fixture parity harness (validation.py)
  instrument   per-phase step-time breakdown (telemetry.InstrumentedTrainer)
  bench        quick synthetic-throughput benchmark

Run as ``python -m dlrm_tpu <subcommand> ...``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
import time
from typing import List, Optional

import numpy as np


# -- config plumbing -----------------------------------------------------------

def _build_config(args) -> "DLRMConfig":
    from dlrm_tpu import config as cfg

    presets = {
        "kaggle": cfg.kaggle_config,
        "terabyte": cfg.terabyte_config,
        "fixture": cfg.fixture_config,
        "tiny": cfg.tiny_config,
    }
    if args.config not in presets:
        raise SystemExit(f"unknown --config {args.config!r}; "
                         f"choose from {sorted(presets)}")
    kw = {}
    if args.config in ("kaggle", "terabyte"):
        kw["feature_size"] = args.feature_size
    c = presets[args.config](**kw)
    over = {}
    if args.interaction:
        over["interaction_impl"] = args.interaction
    else:
        import jax
        sharded = getattr(args, "sharded", None)
        one_device = (not sharded if sharded is not None
                      else len(jax.devices()) == 1)
        over["interaction_impl"] = cfg.default_interaction_impl(
            c, jax.default_backend(), one_device)
    if args.n_hot is not None:
        over["n_hot"] = args.n_hot
    if args.bf16:
        import jax.numpy as jnp
        over["compute_dtype"] = jnp.bfloat16
    if getattr(args, "bf16_tables", False):
        # the reference's BF16-embeddings experiment (@setup builds bf16
        # tables on the slow tier, src/DLRM.jl:44-110, cachedarrays.jl:6-19)
        import jax.numpy as jnp
        over["embedding_dtype"] = jnp.bfloat16
    if args.pad_to is not None:
        over["interaction_pad_to"] = args.pad_to
    if getattr(args, "remat", False):
        over["remat"] = True
    if getattr(args, "exchange_dtype", None) == "bf16":
        import jax.numpy as jnp
        over["exchange_dtype"] = jnp.bfloat16
    if args.table_sizes:
        over["table_sizes"] = tuple(
            int(s) for s in args.table_sizes.split(","))
    if getattr(args, "chunk_budget_mb", None) is not None:
        over["chunk_budget_bytes"] = args.chunk_budget_mb << 20
        over["deep_chunk_budget_bytes"] = args.chunk_budget_mb << 20
    elif getattr(args, "batch_size", None) is not None:
        # auto default (uniform since round 5 — the batch-keyed 64 MB
        # point did not replicate; see auto_chunk_budget_bytes) — applied
        # only when it differs from the preset's choice, and only the
        # general budget (the deep budget is an independent knob a preset
        # may set on its own)
        auto = cfg.auto_chunk_budget_bytes(args.batch_size)
        if auto != c.chunk_budget_bytes:
            over["chunk_budget_bytes"] = auto
    return dataclasses.replace(c, **over) if over else c


def _add_config_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default="kaggle",
                   help="preset: kaggle|terabyte|fixture|tiny")
    p.add_argument("--feature-size", type=int, default=16,
                   help="embedding dim (kaggle/terabyte presets)")
    p.add_argument("--interaction", default=None,
                   choices=["gram", "pairwise", "fused"],
                   help="interaction impl (default: the fused GPU kernel "
                   "on one GPU, gram elsewhere; config."
                   "default_interaction_impl)")
    p.add_argument("--n-hot", type=int, default=None,
                   help="multi-hot lookups per table (default preset)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute dtype for MLPs/interaction")
    p.add_argument("--bf16-tables", action="store_true",
                   help="bfloat16 embedding-table storage (halves table "
                   "device memory; the reference's BF16-embeddings "
                   "experiment)")
    p.add_argument("--pad-to", type=int, default=None,
                   help="pad interaction output width to a multiple")
    p.add_argument("--table-sizes", default=None,
                   help="comma-separated table row counts (overrides preset)")
    p.add_argument("--chunk-budget-mb", type=int, default=None,
                   help="embedding chunk budget in MB (default: "
                   "config.auto_chunk_budget_bytes)")
    p.add_argument("--validate-data", action="store_true",
                   help="scan every categorical id in --data against the "
                   "config's table sizes before running (one streaming "
                   "pass; catches config/dataset mismatches the hot path "
                   "deliberately does not check)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize the dense tower on backward "
                   "(jax.checkpoint): trade FLOPs for activation memory "
                   "at big batches / feature sizes")
    p.add_argument("--exchange-dtype", default=None,
                   choices=["f32", "bf16"],
                   help="wire dtype for the sharded embedding exchanges "
                   "(slot/cs all-to-all, rs reduce-scatter, cross-host "
                   "gradient fold); bf16 halves the per-step collective "
                   "bytes at one rounding per exchange")
    p.add_argument("--platform", default=None,
                   help="force the jax platform (e.g. cpu for a virtual "
                   "device mesh while a GPU is attached)")


def _strict_bool(s: str) -> bool:
    """argparse bool that REJECTS anything but true/false — a lambda
    comparing to 'true' silently maps typos ('1', 'yes') to False."""
    v = s.lower()
    if v not in ("true", "false"):
        raise argparse.ArgumentTypeError(f"expected true|false, got {s!r}")
    return v == "true"


def _apply_platform(args) -> None:
    """--platform: force the jax backend BEFORE any device use
    (jax.config.update wins over whatever JAX_PLATFORMS said)."""
    if getattr(args, "platform", None):
        import jax
        jax.config.update("jax_platforms", args.platform)


def _add_dist_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--distributed", action="store_true",
                   help="multi-process: jax.distributed.initialize before "
                   "device use (one launch of this command per process; "
                   "pass --coordinator, --num-processes and --process-id)")
    p.add_argument("--coordinator", default=None,
                   help="coordinator host:port (process 0's address)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def _block_iter(source, k: int):
    """Stack K consecutive batches host-side for the coalesced block step
    (train.train_block); a sub-K remainder at stream end is stacked as a
    shorter block (the block step recompiles once for its shape)."""
    buf = []

    def flush(buf):
        return {key: np.stack([np.asarray(x[key]) for x in buf])
                for key in buf[0]}

    for b in source:
        buf.append(b)
        if len(buf) == k:
            yield flush(buf)
            buf = []
    if buf:
        yield flush(buf)


def _with_lookahead(source):
    """One-batch lookahead for the pipelined host-tier step: each yielded
    batch carries the NEXT batch's sparse ids (the prefetch targets).  The
    final batch prefetches its own ids (result dropped at stream end)."""
    prev = None
    for b in source:
        if prev is not None:
            yield {**prev, "sparse_next": b["sparse"]}
        prev = b
    if prev is not None:
        yield {**prev, "sparse_next": prev["sparse"]}


def _crossed(prev: int, cur: int, every: Optional[int]) -> bool:
    """True when [prev, cur] crossed a multiple of ``every`` (block steps
    advance the step counter by K at a time)."""
    return bool(every) and (cur // every) > (prev // every)


def _data_iter(args, config, *, steps: Optional[int], seed: int = 0,
               rows=None):
    """Batch stream for a subcommand; ``rows=(lo, hi)`` (multi-host
    feeding, mesh.local_batch_rows) restricts every source to this
    process's rows of each GLOBAL batch — batch cadence and contents stay
    bit-identical to the single-process stream by construction."""
    from dlrm_tpu.data import synthetic
    from dlrm_tpu.data.criteo import DACLoader, load

    if args.data:
        dataset = load(args.data)
        if getattr(args, "validate_data", False):
            from dlrm_tpu.data.criteo import validate_ids
            validate_ids(dataset, config.table_sizes)
        loader = DACLoader(
            dataset, args.batch_size,
            drop_remainder=not getattr(args, "keep_remainder", False),
            shuffle=getattr(args, "shuffle", False),
            shuffle_rows=getattr(args, "shuffle_rows", False),
            shuffle_window=getattr(args, "shuffle_window", 8),
            seed=getattr(args, "seed", 0),
            local_rows=rows)
        if len(loader) == 0:
            raise SystemExit(
                f"dataset {args.data} has fewer records than one batch "
                f"({args.batch_size}); lower --batch-size")
        def gen():
            count = 0
            while steps is None or count < steps:
                for batch in loader:
                    yield batch
                    count += 1
                    if steps is not None and count >= steps:
                        return
                if steps is None:
                    return  # one epoch when steps unspecified
        return gen()
    if getattr(args, "synthetic", "uniform") == "skewed":
        truth = synthetic.ClickthroughModel(config, seed=12345)
        return truth.stream(args.batch_size, steps, seed + 1, rows=rows)
    return synthetic.batch_stream(config, args.batch_size, steps, seed,
                                  rows=rows)


def _maybe_init_distributed(args) -> bool:
    """--distributed: bring up multi-process JAX BEFORE any device use,
    from --coordinator/--num-processes/--process-id (a GPU cluster has no
    topology to auto-discover).  Returns True when this run spans
    multiple processes."""
    if not getattr(args, "distributed", False):
        return False
    from dlrm_tpu.parallel.mesh import init_distributed

    init_distributed(args.coordinator, args.num_processes, args.process_id)
    import jax
    return jax.process_count() > 1


# -- subcommands ---------------------------------------------------------------

def cmd_preprocess(args) -> int:
    from dlrm_tpu.data import criteo

    t0 = time.time()
    data = criteo.process(args.inputs, binpath=args.out,
                          vocab_path=args.vocab)
    vocab_sizes = None
    if args.vocab:
        vocab_sizes = criteo.Vocabulary.load(
            args.vocab if args.vocab.endswith(".npz")
            else args.vocab + ".npz").sizes
    print(json.dumps({"records": int(len(data)), "out": args.out,
                      "vocab_sizes": vocab_sizes,
                      "seconds": round(time.time() - t0, 2)}))
    return 0


def _train_plan(args, n_dev: int, multiproc: bool):
    """Validate the train flag lattice and derive the run plan (lr
    schedule, block size, clip, sharding layout) — the validation half of
    the old 613-line cmd_train, split out in round 5."""
    if args.data is None and args.steps is None:
        raise SystemExit("synthetic training needs --steps")
    if getattr(args, "epochs", None):
        if args.data is None:
            raise SystemExit("--epochs needs --data")
        if args.steps is not None:
            raise SystemExit("pass --steps or --epochs, not both")
        from dlrm_tpu.data.criteo import load as _dac_load
        per_epoch = len(_dac_load(args.data)) // args.batch_size
        if per_epoch == 0:
            raise SystemExit("dataset smaller than one batch")
        args.steps = args.epochs * per_epoch
    lr = args.lr
    if getattr(args, "lr_schedule", "constant") != "constant":
        from dlrm_tpu.train.optim import make_schedule
        lr = make_schedule(args.lr, schedule=args.lr_schedule,
                           warmup_steps=args.warmup_steps,
                           decay_start=args.decay_start,
                           decay_steps=args.decay_steps)
    # coalesced K-step block mode: the block step consumes schedules
    # directly (as a (K,) lr array per block), so the schedule-wrapping
    # opt-state path is only for block == 1
    block = max(int(getattr(args, "update_interval", 1) or 1), 1)
    clip = getattr(args, "grad_clip_norm", None)
    if clip is not None and args.hbm_budget_gb is not None:
        # the clip lives in the per-step and (round 5) block paths; the
        # two-tier step has its own pipelined structure — refuse rather
        # than silently train unclipped
        raise SystemExit("--grad-clip-norm supports the per-step and "
                         "block paths only; drop --hbm-budget-gb")
    sharded = args.sharded if args.sharded is not None else (n_dev > 1)
    _check_host_tier(args)
    if args.hbm_budget_gb is not None and sharded:
        # the two-tier layout is an elif of the sharded one — silently
        # ignoring the budget (and stamping two_tier=true into
        # run_meta.json alongside sharded=true, which every later
        # restore would trip over) is worse than refusing
        raise SystemExit(
            "--hbm-budget-gb is the single-chip two-tier layout and does "
            "not compose with the sharded path (auto-enabled here: "
            f"{n_dev} devices). Pass --sharded false for two-tier on one "
            "device, or use --host-tables N,M for host-resident tables "
            "under sharding")
    if multiproc:
        # multi-host: the global mesh spans every process's devices; the
        # single-chip and two-tier layouts are single-process by definition
        if not sharded:
            raise SystemExit("--distributed (multi-process) requires the "
                             "sharded path; drop --sharded=false")
        if args.batch_size % n_dev:
            raise SystemExit(f"--batch-size {args.batch_size} must divide "
                             f"evenly over the {n_dev}-device global mesh")
    # hybrid (dcn, ici) mesh: tables shard over the ICI axis only, batch
    # data-parallelism spans both axes (SURVEY.md §2.4 multi-host mapping)
    mesh_shape = getattr(args, "mesh_shape", None)
    dcn_n = ici_n = None
    if mesh_shape:
        if not sharded:
            raise SystemExit("--mesh-shape requires the sharded path")
        try:
            dcn_n, ici_n = (int(x) for x in
                            mesh_shape.lower().split("x"))
        except ValueError:
            raise SystemExit(f"--mesh-shape {mesh_shape!r}: want DCNxICI, "
                             "e.g. 2x4")
        if dcn_n < 1 or ici_n < 1:
            raise SystemExit(f"--mesh-shape {mesh_shape}: both dimensions "
                             "must be >= 1")
        if dcn_n * ici_n > n_dev:
            raise SystemExit(f"--mesh-shape {mesh_shape} needs "
                             f"{dcn_n * ici_n} devices, have {n_dev}")
        if args.batch_size % (dcn_n * ici_n):
            raise SystemExit(
                f"--batch-size {args.batch_size} must divide evenly over "
                f"the {dcn_n * ici_n}-device hybrid mesh")
    if getattr(args, "host_prefetch", False):
        if args.hbm_budget_gb is None:
            raise SystemExit("--host-prefetch is a two-tier feature; it "
                             "needs --hbm-budget-gb")
        if args.optimizer != "sgd" or callable(lr):
            raise SystemExit("--host-prefetch currently supports sgd "
                             "with a constant lr")
    if block > 1:
        if args.optimizer not in ("sgd", "adagrad", "rowwise_adagrad"):
            raise SystemExit("--update-interval > 1 requires sgd, "
                             "adagrad, or rowwise_adagrad")
        if args.hbm_budget_gb is not None:
            # round 5: tiered blocks coalesce the host writeback (one
            # host gather + one/two host scatters per K steps — the
            # dominant tiered cost, host_tier.tiered_train_block[_opt]);
            # scheduled-lr tiered blocks are not built
            if callable(lr):
                raise SystemExit(
                    "--update-interval > 1 with --hbm-budget-gb supports "
                    "a constant lr only")
            if getattr(args, "host_prefetch", False):
                raise SystemExit("--host-prefetch does not compose with "
                                 "--update-interval > 1 (the block IS "
                                 "the prefetch batching)")
    return argparse.Namespace(
        lr=lr, block=block, clip=clip, sharded=sharded, dcn_n=dcn_n,
        ici_n=ici_n, n_shards=(ici_n if ici_n else n_dev))


def _check_host_tier(args) -> None:
    """Refuse the host-tier flags where the backend cannot run the tier:
    its gather and scatter are compute_on("device_host") regions
    (parallel/host_tier.py), which only some XLA backends lower."""
    flags = [f for f, on in (
        ("--hbm-budget-gb", args.hbm_budget_gb is not None),
        ("--host-tables", bool(getattr(args, "host_tables", None))))
        if on]
    if not flags:
        return
    from dlrm_tpu.utils.backend import host_compute_supported
    if not host_compute_supported():
        import jax
        raise SystemExit(
            f"{' and '.join(flags)}: the host tier runs its gather and "
            "scatter in compute_on('device_host') regions, which XLA does "
            f"not lower on this backend ({jax.devices()[0].platform}); "
            "keep the tables on the device (drop the flag)")


def _resume(mgr, say, template, shardings=None, place=None):
    """The ONE restore path every training variant shares (round 4 had
    six near-identical copies).  Returns (state, start_step); ``state``
    is the freshly-initialized ``template`` when there is no checkpoint.
    ``place`` re-places a RESTORED payload (host numpy from orbax) into
    its runtime memory layout; templates are already placed."""
    if mgr is not None:
        restored = mgr.restore_latest(template=template,
                                      shardings=shardings)
        if restored is not None:
            payload, start_step = restored
            say(f"resumed from step {start_step}")
            return (place(payload) if place else payload), start_step
    return template, 0


def _plain_step(fn):
    """(p, d, s, l) -> (p, loss) step as the variant interface
    (p, batch) -> (p, loss, steps_advanced)."""
    def step(p, b):
        p2, loss = fn(p, b["dense"], b["sparse"], b["labels"])
        return p2, loss, 1
    return step


def _block_step(fn):
    """Block step: advances by the batch's leading K, reports the last
    micro-loss."""
    def step(p, b):
        p2, losses = fn(p, b["dense"], b["sparse"], b["labels"])
        return p2, losses[-1], int(b["dense"].shape[0])
    return step


def _build_single_variant(args, config, plan, params0, mgr, say):
    """Single-chip variant: plain SGD / opt-state step / coalesced block."""
    import jax
    import jax.numpy as jnp
    import dlrm_tpu

    lr, block, clip = plan.lr, plan.block, plan.clip
    v = argparse.Namespace(mesh=None, placement=None, batch_place=None,
                           wants_batch=False, align=None, start_step=0)
    # blocks carry the clip themselves (per-micro-step, train.train_block)
    # so only a block==1 sgd+clip run needs the opt-state step
    v.uses_opt = (args.optimizer != "sgd"
                  or (clip is not None and block == 1))
    asarray = functools.partial(jax.tree.map, jnp.asarray)
    if not v.uses_opt:
        v.params, v.start_step = _resume(mgr, say, params0, place=asarray)
        if block > 1:
            from dlrm_tpu.train.train import make_jit_train_block
            blk = make_jit_train_block(config, lr, block,
                                       grad_clip_norm=clip)
            if hasattr(blk, "step"):  # scheduled lr: stay step-aligned
                v.align = lambda s: setattr(blk, "step", s)
            v.step = _block_step(blk)
        else:
            step_fn = dlrm_tpu.make_jit_train_step(config, lr)
            if callable(lr):
                step_fn.step = v.start_step
            v.step = _plain_step(step_fn)
        v.ckpt_payload = lambda: v.params
    else:
        from dlrm_tpu.train.train import (init_opt_state,
                                          make_jit_train_block_opt,
                                          make_jit_train_step_opt)
        opt_state = init_opt_state(params0, config=config,
                                   optimizer=args.optimizer, lr=lr)
        full, v.start_step = _resume(
            mgr, say, {"params": params0, "opt": opt_state}, place=asarray)
        v.params = full["params"]
        box = {"opt": full["opt"]}
        if block > 1:
            # block mode has two exact impls (dense_g = the measured
            # optimum, dedup = low-memory); the per-chunk hybrid is an
            # exact-K=1 construct, so the CLI default maps to dense_g
            blk_impl = getattr(args, "adagrad_impl", "hybrid")
            if blk_impl.startswith("hybrid"):
                blk_impl = "dense_g"
            blk_opt = make_jit_train_block_opt(
                config, optimizer=args.optimizer, lr=lr, block=block,
                adagrad_impl=blk_impl,
                unroll=not getattr(args, "block_scan", False),
                grad_clip_norm=clip)

            def step(p, b):
                (p2, box["opt"]), losses = blk_opt(
                    p, box["opt"], b["dense"], b["sparse"], b["labels"])
                return p2, losses[-1], int(b["dense"].shape[0])
        else:
            opt_step = make_jit_train_step_opt(
                config, optimizer=args.optimizer, lr=lr,
                emb_impl=getattr(args, "adagrad_impl", "dedup"),
                grad_clip_norm=clip)

            def step(p, b):
                (p2, box["opt"]), loss = opt_step(
                    p, box["opt"], b["dense"], b["sparse"], b["labels"])
                return p2, loss, 1
        v.step = step
        v.ckpt_payload = lambda: {"params": v.params, "opt": box["opt"]}
    v.eval_view = lambda: v.params
    return v


def _build_sharded_variant(args, config, plan, params0, mgr, say):
    """Hybrid-parallel variant: mesh + placement, sharded step/block."""
    import jax
    import dlrm_tpu
    from dlrm_tpu.parallel import embedding as pemb
    from dlrm_tpu.parallel.mesh import (batch_sharding,
                                        block_batch_sharding, make_mesh,
                                        param_shardings)
    from dlrm_tpu.parallel.placement import plan_placement
    from dlrm_tpu.train.train import (init_sharded_opt_state,
                                      make_sharded_train_block,
                                      make_sharded_train_block_opt,
                                      make_sharded_train_step,
                                      make_sharded_train_step_opt,
                                      sharded_opt_shardings)

    lr, block, clip = plan.lr, plan.block, plan.clip
    cs_tables = tuple(int(x) for x in args.col_sharded_tables.split(",")
                      ) if args.col_sharded_tables else ()
    host_tabs = tuple(int(x) for x in args.host_tables.split(",")
                      ) if getattr(args, "host_tables", None) else ()
    if plan.ici_n:
        from dlrm_tpu.parallel.mesh import make_mesh_2d
        mesh = make_mesh_2d(plan.dcn_n, plan.ici_n)
    else:
        mesh = make_mesh(plan.n_shards)
    placement = plan_placement(
        config.table_sizes, plan.n_shards,
        pack=config.pack if not cs_tables else 1,
        max_rows_per_shard=args.max_rows_per_shard,
        col_sharded_tables=cs_tables, host_tables=host_tabs)
    if placement.row_sharded:
        say(f"row-sharded tables: {list(placement.row_sharded)}")
    if placement.host_row_sharded:
        say("host-resident row-sharded tables: "
            f"{list(placement.host_row_sharded)}")
    if placement.col_sharded:
        say(f"column-sharded tables: {list(placement.col_sharded)}")
    sh_params = {
        "bottom": params0["bottom"],
        "emb": pemb.shard_tables(params0["emb"], placement, config),
        "top": params0["top"],
    }
    if placement.col_sharded:
        sh_params["emb_cs"] = pemb.shard_col_tables(params0["emb"],
                                                    placement, config)
    if placement.host_row_sharded:
        sh_params["emb_h"] = pemb.shard_host_tables(params0["emb"],
                                                    placement, config)
    shardings = param_shardings(mesh, sh_params)

    v = argparse.Namespace(mesh=mesh, placement=placement,
                           wants_batch=False, align=None, start_step=0)
    # blocks carry schedules (as a (K,) lr array) and the clip themselves;
    # only block==1 runs with a schedule or clip need the opt-state step
    v.uses_opt = (args.optimizer != "sgd"
                  or (block == 1 and (callable(lr) or clip is not None)))
    if not v.uses_opt:
        sh_params, v.start_step = _resume(mgr, say, sh_params, shardings)
        v.params = jax.device_put(sh_params, shardings)
        if block > 1:
            blk = make_sharded_train_block(config, lr, mesh, placement,
                                           block, grad_clip_norm=clip)
            if hasattr(blk, "step"):  # scheduled lr: stay step-aligned
                v.align = lambda s: setattr(blk, "step", s)
            v.step = _block_step(blk)
        else:
            v.step = _plain_step(
                make_sharded_train_step(config, lr, mesh, placement))
        v.ckpt_payload = lambda: v.params
    else:
        opt_state = init_sharded_opt_state(
            sh_params, config=config, optimizer=args.optimizer, lr=lr,
            mesh=mesh)
        # the Adagrad accumulators / schedule count checkpoint alongside
        # the params (accumulator sharded like the tables) — resuming
        # must not reset the trajectory
        full, v.start_step = _resume(
            mgr, say, {"params": sh_params, "opt": opt_state},
            {"params": shardings,
             "opt": sharded_opt_shardings(opt_state, mesh)})
        v.params = jax.device_put(full["params"], shardings)
        box = {"opt": full["opt"]}
        if block > 1:
            blk_opt = make_sharded_train_block_opt(
                config, optimizer=args.optimizer, lr=lr, mesh=mesh,
                placement=placement, block=block,
                unroll=not getattr(args, "block_scan", False),
                grad_clip_norm=clip)

            def step(p, b):
                (p2, box["opt"]), losses = blk_opt(
                    p, box["opt"], b["dense"], b["sparse"], b["labels"])
                return p2, losses[-1], int(b["dense"].shape[0])
        else:
            opt_step = make_sharded_train_step_opt(
                config, optimizer=args.optimizer, lr=lr, mesh=mesh,
                placement=placement, grad_clip_norm=clip)

            def step(p, b):
                (p2, box["opt"]), loss = opt_step(
                    p, box["opt"], b["dense"], b["sparse"], b["labels"])
                return p2, loss, 1
        v.step = step
        v.ckpt_payload = lambda: {"params": v.params, "opt": box["opt"]}
    bs = batch_sharding(mesh)
    if block > 1:
        stacked = block_batch_sharding(mesh)
        v.batch_place = (lambda b: stacked
                         if np.asarray(b["dense"]).ndim == 3 else bs)
    else:
        v.batch_place = bs
    v.eval_view = lambda: v.params  # sharded eval runs ON the mesh
    return v


def _build_tiered_variant(args, config, plan, params0, mgr, say):
    """Two-tier (HBM + pinned host) variant — the reference's
    CacheManager localsize knob (src/DLRM.jl:47-53): spill the biggest
    tables to host memory."""
    import jax
    import jax.numpy as jnp
    from dlrm_tpu.parallel import host_tier as ht

    lr = plan.lr
    tiers = ht.plan_tiers(config, int(args.hbm_budget_gb * (1 << 30)))
    say(f"host-tier tables: {list(tiers.host_tables)} "
        f"({tiers.host_rows:,} rows)")
    if mgr is not None and 0 in (tiers.device_rows, tiers.host_rows):
        # orbax cannot serialize zero-size arrays; an empty tier only
        # happens at degenerate budgets (nothing fits / nothing spills)
        raise SystemExit(
            "--ckpt-dir with --hbm-budget-gb needs both tiers "
            "non-empty (adjust the budget so at least one table stays "
            "on device and one spills)")
    tiered0 = ht.init_tiered_params(params0, tiers, config)

    v = argparse.Namespace(mesh=None, placement=None, batch_place=None,
                           wants_batch=False, align=None, start_step=0)
    v.uses_opt = args.optimizer != "sgd" or callable(lr)
    if not v.uses_opt:
        # checkpoints are memory-space-agnostic; restore re-pins the host
        # tier (and its accumulator) to pinned_host
        v.params, v.start_step = _resume(
            mgr, say, tiered0,
            place=functools.partial(ht.place_tiered, plan=tiers,
                                    config=config))
        if plan.block > 1:
            # coalesced tiered block: ONE host gather + ONE host scatter
            # per K steps (host_tier.tiered_train_block)
            blk = ht.make_tiered_train_block(config, args.lr, tiers,
                                             plan.block)
            v.step = _block_step(blk)
        elif getattr(args, "host_prefetch", False):
            # software-pipelined host tier: batch N+1's host gather is
            # the LAST host op of step N's program (exact by data
            # dependency through the updated stack); the batch stream
            # is wrapped with a one-batch lookahead by the caller
            if not tiers.host_tables:
                raise SystemExit("--host-prefetch needs a host tier "
                                 "(lower --hbm-budget-gb)")
            pipe_step = ht.make_tiered_pipelined_step(config, args.lr,
                                                      tiers)
            box = {"pref": None}

            def step(p, b):
                if box["pref"] is None:  # pipeline preamble
                    box["pref"] = ht.prime_host_prefetch(
                        p["emb_host"], b["sparse"], tiers)
                (p2, box["pref"]), loss = pipe_step(
                    p, box["pref"], b["dense"], b["sparse"], b["labels"],
                    b["sparse_next"])
                return p2, loss, 1
            v.wants_batch = True
            v.step = step
        else:
            v.step = _plain_step(
                ht.make_tiered_train_step(config, args.lr, tiers))
        v.ckpt_payload = lambda: v.params
    else:
        opt_state = ht.init_tiered_opt_state(
            tiered0, config=config, optimizer=args.optimizer, lr=lr,
            plan=tiers)
        full, v.start_step = _resume(
            mgr, say, {"params": tiered0, "opt": opt_state},
            place=lambda f: {"params": ht.place_tiered(
                                 f["params"], plan=tiers, config=config),
                             "opt": ht.place_tiered_opt(f["opt"])})
        v.params = full["params"]
        box = {"opt": full["opt"]}
        if plan.block > 1:
            blk_opt = ht.make_tiered_train_block_opt(
                config, optimizer=args.optimizer, lr=lr, plan=tiers)

            def step(p, b):
                (p2, box["opt"]), losses = blk_opt(
                    p, box["opt"], b["dense"], b["sparse"], b["labels"])
                return p2, losses[-1], int(b["dense"].shape[0])
        else:
            opt_step = ht.make_tiered_train_step_opt(
                config, optimizer=args.optimizer, lr=lr, plan=tiers)

            def step(p, b):
                (p2, box["opt"]), loss = opt_step(
                    p, box["opt"], b["dense"], b["sparse"], b["labels"])
                return p2, loss, 1
        v.step = step
        v.ckpt_payload = lambda: {"params": v.params, "opt": box["opt"]}

    def eval_view():
        # params in the standard storage layout for metrics.evaluate
        from dlrm_tpu.ops import embedding as emb_ops
        t = v.params
        logical = ht.merge_tiers(t["emb_dev"], t["emb_host"], tiers,
                                 config)
        return {"bottom": t["bottom"],
                "emb": jax.tree.map(
                    jnp.asarray, emb_ops.pack_tables(logical, config)),
                "top": t["top"]}
    v.eval_view = eval_view
    return v


def _write_run_meta(args, config, plan, v, lead) -> None:
    """Sidecar describing the run's storage layout, so `eval --ckpt-dir`
    can rebuild the placement and unshard on any topology."""
    import jax.numpy as jnp
    import os

    meta_path = os.path.join(os.path.abspath(args.ckpt_dir),
                             "run_meta.json")
    cs_meta = ([int(x) for x in args.col_sharded_tables.split(",")]
               if args.col_sharded_tables else [])
    meta_payload = {
        "sharded": bool(plan.sharded),
        # the table-sharding (ICI) axis size — what placement and
        # unshard need; the DCN axis only replicates
        "num_shards": plan.n_shards,
        "mesh_shape": ([plan.dcn_n, plan.ici_n] if plan.ici_n else None),
        "pack": config.pack if not cs_meta else 1,
        "max_rows_per_shard": args.max_rows_per_shard,
        "col_sharded_tables": cs_meta,
        "host_tables": ([int(x) for x in args.host_tables.split(",")]
                        if getattr(args, "host_tables", None) else []),
        "optimizer": args.optimizer,
        "two_tier": bool(args.hbm_budget_gb is not None),
        "hbm_budget_gb": args.hbm_budget_gb,
        # whether checkpoints wrap as {"params", "opt"} — taken from the
        # variant's single source of truth (round 4 computed this twice,
        # inconsistently, for sgd+clip runs)
        "wrapped_opt": bool(v.uses_opt),
        "table_sizes": list(config.table_sizes),
        "bf16_tables": bool(getattr(args, "bf16_tables", False)),
        # chunk geometry keys storage layout (--chunk-budget-mb
        # overrides); eval/predict must rebuild the TRAINING run's
        # layout whatever budget it used
        "chunk_budget_bytes": config.chunk_budget_bytes,
        "deep_chunk_budget_bytes": config.deep_chunk_budget_bytes,
        # numerics record (not a layout key): what wire dtype the
        # run's exchanges used (library callers can set any dtype
        # on the config — record the actual one, not the flag)
        "exchange_dtype": (
            None if config.exchange_dtype is None
            else jnp.dtype(config.exchange_dtype).name),
    }
    if lead:  # one writer; orbax array writes stay collective
        with open(meta_path, "w") as f:
            json.dump(meta_payload, f)


def cmd_train(args) -> int:
    _apply_platform(args)
    multiproc = _maybe_init_distributed(args)
    import jax
    import jax.numpy as jnp
    import dlrm_tpu
    from dlrm_tpu.data.prefetch import device_prefetch
    from dlrm_tpu.io.checkpoint import CheckpointManager
    from dlrm_tpu.parallel.mesh import is_lead_process
    from dlrm_tpu.train.metrics import evaluate

    # one process owns stdout/metadata; every process runs the collectives
    lead = is_lead_process() if multiproc else True
    config = _build_config(args)
    n_dev = len(jax.devices())
    plan = _train_plan(args, n_dev, multiproc)

    def say(*a):  # stderr status lines: one process's voice, not N copies
        if lead:
            print(*a, file=sys.stderr)

    say(f"devices: {n_dev} ({jax.devices()[0].platform}), "
        f"sharded={plan.sharded}"
        + (f", processes={jax.process_count()}" if multiproc else "")
        + (f", mesh={plan.dcn_n}x{plan.ici_n} (dcn x ici)"
           if plan.ici_n else ""))
    params0 = dlrm_tpu.init_params(jax.random.key(config.seed), config)
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir,
                                save_interval=args.save_interval,
                                max_to_keep=args.max_to_keep)

    if plan.sharded:
        v = _build_sharded_variant(args, config, plan, params0, mgr, say)
    elif args.hbm_budget_gb is not None:
        v = _build_tiered_variant(args, config, plan, params0, mgr, say)
    else:
        v = _build_single_variant(args, config, plan, params0, mgr, say)
    if args.ckpt_dir:
        _write_run_meta(args, config, plan, v, lead)

    # multi-host feeding: which global batch rows THIS process materializes
    # (mesh.local_batch_rows derives the stripe from the batch sharding's
    # own index map); single-process feeds the whole batch
    feed_rows = None
    if multiproc:
        from dlrm_tpu.parallel.mesh import batch_sharding, local_batch_rows
        feed_rows = local_batch_rows(batch_sharding(v.mesh),
                                     args.batch_size)

    replica_check = None
    if getattr(args, "paranoid", None):
        if not (plan.sharded and plan.ici_n):
            raise SystemExit("--paranoid guards the hybrid (DCNxICI) "
                             "mesh; it needs --mesh-shape")
        from dlrm_tpu.parallel.embedding import make_dcn_replica_check
        replica_check = make_dcn_replica_check(v.mesh)

    eval_record: List[dict] = []
    eval_cache: dict = {}

    def run_eval(eval_iter):
        """Evaluate with whatever layout the training path uses: the
        sharded path evals ON the mesh (the tables are never gathered to
        one host — metrics.sharded_evaluate), the others through the
        standard storage view."""
        if plan.sharded:
            from dlrm_tpu.train.metrics import (make_sharded_eval_forward,
                                                sharded_evaluate)
            if "fwd" not in eval_cache:  # compile the mesh forward once
                eval_cache["fwd"] = make_sharded_eval_forward(
                    config, v.mesh, v.placement)
            return sharded_evaluate(v.params, eval_iter, config,
                                    mesh=v.mesh, placement=v.placement,
                                    fwd=eval_cache["fwd"])
        return evaluate(v.eval_view(), eval_iter, config)

    def make_eval_iter(seed=10_000):
        # the reference's Every(test, n) combinator (train/utils.jl:11-46)
        eval_data = args.eval_data or args.data
        eval_steps = args.eval_steps
        if eval_data is None and eval_steps is None:
            eval_steps = 10  # synthetic eval needs a bound
        return _data_iter(
            argparse.Namespace(data=eval_data,
                               batch_size=args.batch_size,
                               synthetic=getattr(args, "synthetic",
                                                 "uniform"),
                               # eval covers the dataset's trailing
                               # partial batch (sharded_evaluate pads it
                               # to a mesh multiple); multi-host feeding
                               # needs even stripes -> full batches
                               keep_remainder=feed_rows is None),
            config, steps=eval_steps, seed=seed, rows=feed_rows)

    def periodic_eval():
        m = run_eval(make_eval_iter())
        m["step"] = step
        if lead:  # metrics are globally reduced — identical on all procs
            eval_record.append(m)
            print(f"eval @ step {step}: acc={m['accuracy']:.4f} "
                  f"auc={m['auc']:.4f} loss={m['loss']:.5f}",
                  file=sys.stderr)

    losses: List[float] = []
    t_start = time.time()
    step = prev = v.start_step
    start_step = v.start_step
    remaining = (None if args.steps is None
                 else max(args.steps - start_step, 0))
    source = _data_iter(args, config, steps=remaining, seed=args.seed,
                        rows=feed_rows)
    if plan.block > 1:
        source = _block_iter(source, plan.block)
    if v.wants_batch:
        source = _with_lookahead(source)
    profiling = False
    loss = None
    for b in device_prefetch(source, size=args.prefetch,
                             sharding=v.batch_place,
                             global_batch=(args.batch_size if multiproc
                                           else None)):
        if args.profile_dir is not None:
            # capture a jax.profiler trace of steps ~3..6 after warmup;
            # the named_scope phases (lookup/interaction/...) appear in
            # the trace
            if not profiling and step >= start_step + 3:
                jax.profiler.start_trace(args.profile_dir)
                profiling = True
            elif profiling and step >= start_step + 6:
                jax.block_until_ready(v.params)
                jax.profiler.stop_trace()
                profiling = False
                args.profile_dir = None
                say("profile written")
        prev = step
        if v.align is not None:
            v.align(step)  # scheduled-lr block wrappers: stay aligned
        v.params, loss, advanced = v.step(v.params, b)
        step += advanced
        if _crossed(prev, step, args.log_every):
            loss = float(loss)
            losses.append(loss)
            dt = time.time() - t_start
            eps = (step - start_step) * args.batch_size / max(dt, 1e-9)
            say(f"step {step} loss {loss:.5f} "
                f"({eps:,.0f} examples/s)")
        if _crossed(prev, step, args.eval_every):
            periodic_eval()
        if replica_check is not None and _crossed(prev, step,
                                                  args.paranoid):
            if not bool(np.asarray(replica_check(v.params)).all()):
                raise RuntimeError(
                    f"--paranoid: DCN table replicas DIVERGED at step "
                    f"{step} — a sparse update was not DCN-invariant "
                    "(see parallel/embedding._dcn_fold)")
        if mgr is not None and _crossed(prev, step, mgr.save_interval):
            mgr.save(step, v.ckpt_payload())
    if profiling:
        jax.block_until_ready(v.params)
        jax.profiler.stop_trace()
        say("profile written (stream ended mid-capture)")
    if mgr is not None:
        if mgr.latest_step() != step:  # maybe_save may have just saved it
            mgr.save(step, v.ckpt_payload(), force=True)
        mgr.wait_until_finished()
        mgr.close()

    # ``losses`` records only --log-every crossings; a short run (fewer
    # steps than log_every) must still report its final loss — append it
    # unless the last iteration just logged this very value
    if step > start_step and not _crossed(prev, step, args.log_every):
        losses.append(float(loss))
    result = {"steps": step - start_step,
              "final_loss": losses[-1] if losses else None,
              "seconds": round(time.time() - t_start, 2)}
    if eval_record:
        result["eval_record"] = eval_record
    if args.eval_data or args.eval_after:
        # same bounding rule as periodic_eval: only an all-synthetic eval
        # needs the default 10-batch cap — a real --eval-data file must
        # be consumed in full (bounding on args.data here would silently
        # truncate it)
        result["eval"] = run_eval(make_eval_iter())
    if lead:
        print(json.dumps(result))
    return 0


def _read_run_meta(ckpt_dir) -> dict:
    import os
    meta_path = os.path.join(os.path.abspath(ckpt_dir), "run_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def _check_meta_sizes(meta, config):
    meta_sizes = tuple(meta.get("table_sizes", config.table_sizes))
    if meta_sizes != config.table_sizes:
        raise SystemExit(
            f"checkpoint was trained with table sizes {list(meta_sizes)} "
            f"but the eval config has {list(config.table_sizes)}; pass "
            "the training run's --table-sizes/--config to eval")
    return meta_sizes


def _try_load_sharded_ctx(args, config, meta=None):
    """Restore a SHARDED checkpoint directly onto a mesh, placement and
    all — the tables are never gathered to one host (a Terabyte-scale
    sharded checkpoint cannot be unsharded; the reference has no serving
    path at all, train/utils.jl:31-46): shardings are built from the
    checkpoint METADATA so every shard streams straight to its device.
    Returns (params, mesh, placement) or None when the checkpoint isn't
    sharded / not enough devices are visible (callers then fall back to
    the unshard path)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from dlrm_tpu.io.checkpoint import (checkpoint_metadata,
                                        restore_checkpoint)
    from dlrm_tpu.parallel.mesh import make_mesh, param_shardings
    from dlrm_tpu.parallel.placement import plan_placement

    if not args.ckpt_dir:
        return None
    if meta is None:
        meta = _read_run_meta(args.ckpt_dir)
    if not meta.get("sharded"):
        return None
    n = int(meta["num_shards"])
    if len(jax.devices()) < n:
        print(f"sharded checkpoint needs {n} devices, have "
              f"{len(jax.devices())}; falling back to unshard",
              file=sys.stderr)
        return None
    _check_meta_sizes(meta, config)
    if meta.get("host_tables"):
        from dlrm_tpu.parallel.host_tier import host_memory_supported
        if not host_memory_supported():
            return None
    mesh = make_mesh(n)
    abstract = checkpoint_metadata(args.ckpt_dir)
    wrapped = isinstance(abstract, dict) and "opt" in abstract
    params_abs = abstract["params"] if wrapped else abstract
    shardings = param_shardings(mesh, params_abs)
    if wrapped:
        # the optimizer state restores sharded too (the Adagrad
        # accumulator mirrors the table stack — it must not gather to
        # one host either), then drops: eval/serve don't need it
        opt_abs = abstract["opt"]
        repl = NamedSharding(mesh, P())
        opt_sh = jax.tree.map(lambda _: repl, opt_abs)
        if "emb_acc" in opt_abs and not isinstance(
                opt_abs["emb_acc"], (tuple, list)):
            opt_sh["emb_acc"] = NamedSharding(mesh, P("d"))
        if opt_abs.get("emb_acc_cs"):
            # rowwise cs accumulators checkpoint as replicated (R,)
            # vectors; elementwise ones shard like the lane slices
            opt_sh["emb_acc_cs"] = jax.tree.map(
                lambda a: NamedSharding(
                    mesh, P() if a.ndim == 1 else P("d")),
                opt_abs["emb_acc_cs"])
        if "emb_acc_h" in opt_abs and not isinstance(
                opt_abs["emb_acc_h"], (tuple, list)):
            opt_sh["emb_acc_h"] = NamedSharding(
                mesh, P("d"), memory_kind="pinned_host")
        template = {"params": params_abs, "opt": opt_abs}
        full_sh = {"params": shardings, "opt": opt_sh}
    else:
        template, full_sh = params_abs, shardings
    payload, _ = restore_checkpoint(args.ckpt_dir, template=template,
                                    shardings=full_sh)
    if wrapped:
        payload = payload["params"]
    placement = plan_placement(
        tuple(meta["table_sizes"]), n, pack=meta.get("pack", 1),
        max_rows_per_shard=meta.get("max_rows_per_shard"),
        col_sharded_tables=meta.get("col_sharded_tables", ()),
        host_tables=meta.get("host_tables", ()))
    return payload, mesh, placement


def _try_load_quantized_sharded_ctx(args, config):
    """int8 SHARDED serving: restore the sharded checkpoint host-side
    (numpy), quantize the shard stacks in host RAM, and ship only
    int8 + scales to the mesh — the full-precision stack never touches
    device memory.  This is the Terabyte-scale serving path: fs=128
    tables are ~451 GB f32 / ~225 GB bf16 (more than four 80 GB cards
    hold) vs ~113 GB int8.  Single-process (the host-side restore holds one
    full-precision copy in host RAM); the pinned-host stack (if any)
    stays full-precision — it occupies host RAM, not HBM.
    Returns (params, mesh, placement) or None to fall back."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from dlrm_tpu.io.checkpoint import restore_checkpoint
    from dlrm_tpu.ops import quant as quant_ops
    from dlrm_tpu.parallel.mesh import make_mesh
    from dlrm_tpu.parallel.placement import plan_placement

    if not args.ckpt_dir:
        return None
    meta = _read_run_meta(args.ckpt_dir)
    if not meta.get("sharded"):
        return None
    n = int(meta["num_shards"])
    if len(jax.devices()) < n:
        print(f"sharded checkpoint needs {n} devices, have "
              f"{len(jax.devices())}; falling back to unshard",
              file=sys.stderr)
        return None
    _check_meta_sizes(meta, config)
    if meta.get("host_tables"):
        from dlrm_tpu.parallel.host_tier import host_memory_supported
        if not host_memory_supported():
            return None
    payload, _ = restore_checkpoint(args.ckpt_dir)  # host numpy arrays
    if isinstance(payload, dict) and "opt" in payload:
        payload = payload["params"]
    placement = plan_placement(
        tuple(meta["table_sizes"]), n, pack=meta.get("pack", 1),
        max_rows_per_shard=meta.get("max_rows_per_shard"),
        col_sharded_tables=meta.get("col_sharded_tables", ()),
        host_tables=meta.get("host_tables", ()))
    mesh = make_mesh(n)
    shd = NamedSharding(mesh, P("d"))
    emb_np = np.asarray(payload["emb"])
    d = emb_np.shape[-1] // placement.pack
    q, s = quant_ops.quantize_sharded_stack(emb_np, placement.pack, d)
    del emb_np
    params = {
        "bottom": jax.tree.map(jnp.asarray, payload["bottom"]),
        "top": jax.tree.map(jnp.asarray, payload["top"]),
        "emb": jax.device_put(q, shd),
        "emb_scales": jax.device_put(s, shd),
    }
    if placement.col_sharded:
        qcs, scs = quant_ops.quantize_col_shards(
            [np.asarray(a) for a in payload["emb_cs"]])
        params["emb_cs"] = tuple(jax.device_put(a, shd) for a in qcs)
        params["emb_cs_scales"] = tuple(
            jax.device_put(a, shd) for a in scs)
    if placement.host_row_sharded:
        params["emb_h"] = jax.device_put(
            jnp.asarray(np.asarray(payload["emb_h"])),
            NamedSharding(mesh, P("d"), memory_kind="pinned_host"))
    return params, mesh, placement


def _load_eval_params(args, config, host: bool = False):
    """Load params in the standard storage layout from --ckpt-dir (any
    training run's layout, rebuilt via run_meta.json) or --hdf5 (PyTorch
    interop format).  Returns (params, config).

    ``host``: keep the arrays numpy/host-resident (checkpoints restore
    as host arrays) instead of device_put-ing them — the quantized
    serving path transforms them host-side first, because the
    full-precision stack may not fit device HBM at all."""
    import jax
    import jax.numpy as jnp
    from dlrm_tpu.io.checkpoint import restore_checkpoint

    if args.ckpt_dir:
        meta = _read_run_meta(args.ckpt_dir)
        if meta.get("bf16_tables") and not getattr(args, "bf16_tables",
                                                   False):
            # storage dtype changes the chunk geometry (config.py
            # chunk_budget math) — apply the training run's choice
            config = dataclasses.replace(config,
                                         embedding_dtype=jnp.bfloat16)
        if meta.get("chunk_budget_bytes"):
            # ditto for the chunk budget itself (batch-size-keyed default
            # means eval at a different batch size would otherwise rebuild
            # a different chunk split than the checkpoint's)
            config = dataclasses.replace(
                config,
                chunk_budget_bytes=int(meta["chunk_budget_bytes"]),
                deep_chunk_budget_bytes=int(
                    meta.get("deep_chunk_budget_bytes",
                             meta["chunk_budget_bytes"])))
        # template-less restore is topology-independent (metadata-driven
        # abstract template in io/checkpoint.py); optimizer-state runs wrap
        # the params as {"params": ..., "opt": ...}
        params, step = restore_checkpoint(args.ckpt_dir)
        if isinstance(params, dict) and "opt" in params:
            params = params["params"]
        if meta.get("quantized"):
            # pre-quantized serving artifact (`export --quantize int8`):
            # rebuild the QuantEmb from the plain-dict checkpoint layout
            # (a custom pytree node would not survive template-less
            # restore) — ready to serve, no re-quantization pass
            from dlrm_tpu.ops.quant import QuantEmb, check_quant_storage
            _check_meta_sizes(meta, config)
            qemb = QuantEmb(tuple(params["emb_q"]["chunks"]),
                            tuple(params["emb_q"]["scales"]))
            check_quant_storage(qemb, config)
            params = {"bottom": params["bottom"], "emb": qemb,
                      "top": params["top"]}
            if not host:
                params = jax.tree.map(jnp.asarray, params)
            return params, config
        if meta.get("two_tier"):
            # reassemble the tier split (device + pinned-host stacks) into
            # the standard engine storage for host-side eval/predict
            from dlrm_tpu.ops import embedding as emb_ops
            from dlrm_tpu.parallel import host_tier as ht
            _check_meta_sizes(meta, config)
            plan = ht.plan_tiers(config,
                                 int(meta["hbm_budget_gb"] * (1 << 30)))
            logical = ht.merge_tiers(params["emb_dev"],
                                     np.asarray(params["emb_host"]),
                                     plan, config)
            params = {"bottom": params["bottom"],
                      "emb": emb_ops.pack_tables(logical, config),
                      "top": params["top"]}
        if meta.get("sharded"):
            # rebuild the training run's placement and undo the sharded
            # (N, local_rows, W) layout into the standard storage
            from dlrm_tpu.ops import embedding as emb_ops
            from dlrm_tpu.parallel import embedding as pemb
            from dlrm_tpu.parallel.placement import plan_placement
            meta_sizes = _check_meta_sizes(meta, config)
            placement = plan_placement(
                meta_sizes, meta["num_shards"], pack=meta.get("pack", 1),
                max_rows_per_shard=meta.get("max_rows_per_shard"),
                col_sharded_tables=meta.get("col_sharded_tables", ()),
                host_tables=meta.get("host_tables", ()))
            logical = pemb.unshard_tables(
                np.asarray(params["emb"]), placement, config,
                host=(np.asarray(params["emb_h"])
                      if "emb_h" in params else None))
            if placement.col_sharded:
                cs_tabs = pemb.unshard_col_tables(
                    [np.asarray(a) for a in params["emb_cs"]], placement)
                for k, t in enumerate(placement.col_sharded):
                    off = config.table_offsets[t]
                    logical[off:off + config.table_sizes[t]] = cs_tabs[k]
            params = {"bottom": params["bottom"],
                      "emb": emb_ops.pack_tables(logical, config),
                      "top": params["top"]}
        if not host:
            params = jax.tree.map(jnp.asarray, params)
    elif args.hdf5:
        from dlrm_tpu.io import hdf5 as h5io
        params, config = h5io.load_params(args.hdf5)
        if not host:
            params = jax.tree.map(jnp.asarray, params)
    else:
        raise SystemExit("need --ckpt-dir or --hdf5")
    return params, config


def _quantizing(args) -> bool:
    return getattr(args, "quantize_tables", None) == "int8"


def _maybe_quantize(args, params, config):
    """Apply --quantize-tables (post-training int8) to host-loaded
    params, then place on device.

    Quantization runs HOST-side (numpy) on the not-yet-device_put
    arrays: the f32/bf16 stack this feature exists for (Kaggle fs=128 =
    17.3 GB f32) may not fit device HBM at all, so only the int8 chunks
    + scales (and the small dense towers) ever reach the device.  When
    not quantizing, this completes the deferred device placement."""
    import jax
    import jax.numpy as jnp

    from dlrm_tpu.ops.quant import QuantEmb

    if _quantizing(args) and not isinstance(params["emb"], QuantEmb):
        from dlrm_tpu.ops.quant import quantize_emb_host

        if getattr(args, "ckpt_dir", None) and \
                _read_run_meta(args.ckpt_dir).get("sharded"):
            print("quantized serving unshards the checkpoint on this "
                  "host (host memory, not HBM) before int8 conversion",
                  file=sys.stderr)
        params = {"bottom": params["bottom"],
                  "emb": quantize_emb_host(params["emb"], config),
                  "top": params["top"]}
    return jax.tree.map(jnp.asarray, params)


def cmd_eval(args) -> int:
    _apply_platform(args)
    multiproc = _maybe_init_distributed(args)
    import jax
    from dlrm_tpu.parallel.mesh import is_lead_process
    from dlrm_tpu.train.metrics import evaluate, sharded_evaluate

    lead = is_lead_process() if multiproc else True
    config = _build_config(args)
    # synthetic fallback needs a bound or evaluate() would never terminate
    eval_steps = args.eval_steps or (None if args.data else 10)
    meta = _read_run_meta(args.ckpt_dir) if args.ckpt_dir else {}
    if multiproc and args.quantize_tables:
        raise SystemExit("--quantize-tables is a single-host serving path "
                         "(quantized on-mesh placement is not implemented); "
                         "drop --distributed")
    ctx = None
    if meta.get("sharded"):
        n_sh = int(meta["num_shards"])
        if args.batch_size % n_sh:
            # fall back to the unshard path (tested behavior; fine when
            # the tables fit one host) but say so LOUDLY — at Terabyte
            # scale the unshard materializes the full logical stack on
            # one host and the user should fix the batch size instead
            if lead:
                print(f"--batch-size {args.batch_size} is not divisible "
                      f"by the checkpoint's {n_sh} shards; falling back "
                      "to UNSHARDED eval (materializes the full table "
                      "stack on this host — use e.g. --batch-size "
                      f"{(args.batch_size // n_sh + 1) * n_sh} for "
                      "on-mesh eval)", file=sys.stderr)
        elif args.quantize_tables:
            # int8 on-mesh eval: host-side quantization of the shard
            # stacks, only int8+scales reach HBM
            ctx = _try_load_quantized_sharded_ctx(args, config)
        else:
            ctx = _try_load_sharded_ctx(args, config, meta=meta)
    if multiproc and ctx is None:
        raise SystemExit("--distributed eval needs a SHARDED checkpoint "
                         "whose shard count fits the global mesh (on-mesh "
                         "eval is the only multi-process eval path)")
    if ctx is not None:
        # on-mesh eval: the tables stay sharded (mandatory at scales where
        # the logical stack doesn't fit one host)
        params, mesh, placement = ctx
        rows = None
        if multiproc:
            from dlrm_tpu.parallel.mesh import (batch_sharding,
                                                local_batch_rows)
            n_dev = mesh.devices.size
            if args.batch_size % n_dev:
                # uneven stripes would give each process a different
                # local*process_count global shape downstream — fail
                # clearly instead of hanging in the collective
                raise SystemExit(f"--distributed eval: --batch-size "
                                 f"{args.batch_size} must be divisible "
                                 f"by the {n_dev}-device mesh")
            rows = local_batch_rows(batch_sharding(mesh), args.batch_size)
        # single-process on-mesh eval pads the ragged tail batch to a
        # mesh multiple inside sharded_evaluate, so it covers EVERY row;
        # multi-host feeding needs even per-process stripes (full batches)
        args.keep_remainder = not multiproc
        data = _data_iter(args, config, steps=eval_steps, rows=rows)
        m = sharded_evaluate(params, data, config, mesh=mesh,
                             placement=placement)
        if lead:
            print(json.dumps(m))
        return 0
    params, config = _load_eval_params(args, config,
                                       host=_quantizing(args))
    params = _maybe_quantize(args, params, config)
    args.keep_remainder = True  # metrics must cover every dataset row
    data = _data_iter(args, config, steps=eval_steps)
    print(json.dumps(evaluate(params, data, config)))
    return 0


def cmd_predict(args) -> int:
    """Batch serving: write CTR scores for a dataset to a .npy file.

    The reference has no serving path (scores only appear inside test(),
    train/utils.jl:31-46); this is the production inference surface: one
    jitted forward, streaming batches, scores written in input order."""
    import jax
    import jax.numpy as jnp
    from dlrm_tpu.models.dlrm import forward

    if args.data is None:
        raise SystemExit("predict needs --data")
    _apply_platform(args)
    if _maybe_init_distributed(args):
        raise SystemExit("predict is single-process (scores stream to one "
                         ".npy); run it on one host — a sharded checkpoint "
                         "still serves on-mesh there")
    config = _build_config(args)
    # quantized sharded checkpoints serve ON the mesh too: the shard
    # stacks quantize host-side and only int8+scales reach HBM
    ctx = (_try_load_quantized_sharded_ctx(args, config)
           if args.quantize_tables else
           _try_load_sharded_ctx(args, config))
    args.keep_remainder = True  # serving must score EVERY row
    t0 = time.time()
    if ctx is not None:
        # score ON the mesh: sharded checkpoints (possibly bigger than one
        # host's memory) serve without ever materializing the logical stack;
        # ragged tails are padded to a mesh multiple and trimmed after
        from dlrm_tpu.parallel.mesh import batch_sharding
        from dlrm_tpu.train.metrics import make_sharded_eval_forward

        params, mesh, placement = ctx
        sfwd = make_sharded_eval_forward(config, mesh, placement)
        dense_params = {"bottom": params["bottom"], "top": params["top"]}
        bs = batch_sharding(mesh)
        nd = mesh.devices.size

        def score(batch):
            d = np.asarray(batch["dense"])
            s = np.asarray(batch["sparse"])
            b = d.shape[0]
            pad = (-b) % nd
            if pad:  # repeat the last row; trimmed below
                d = np.concatenate([d, np.repeat(d[-1:], pad, 0)])
                s = np.concatenate([s, np.repeat(s[-1:], pad, 0)])
            preds = sfwd(dense_params, params["emb"],
                         params.get("emb_h"), params.get("emb_cs", ()),
                         params.get("emb_scales"),
                         params.get("emb_cs_scales", ()),
                         jax.device_put(jnp.asarray(d), bs),
                         jax.device_put(jnp.asarray(s), bs))
            return np.asarray(preds)[:b]
    else:
        params, config = _load_eval_params(args, config,
                                           host=_quantizing(args))
        params = _maybe_quantize(args, params, config)
        fwd = jax.jit(lambda p, d, s: forward(p, d, s, config))

        def score(batch):
            return np.asarray(fwd(params, jnp.asarray(batch["dense"]),
                                  jnp.asarray(batch["sparse"])))

    data = _data_iter(args, config, steps=None)
    scores = []
    n = 0
    for batch in data:
        scores.append(score(batch))
        n += scores[-1].shape[0]
    out = np.concatenate(scores) if scores else np.zeros((0,), np.float32)
    np.save(args.out, out)
    print(json.dumps({"examples": int(n), "out": args.out,
                      "seconds": round(time.time() - t0, 2),
                      "mean_score": float(out.mean()) if n else None}))
    return 0


def cmd_export(args) -> int:
    """Export a checkpoint to the PyTorch-interop HDF5 layout (per-table
    emb_{i} + bot_l/top_l.{j}.weight|bias, (out, in) weights) — the
    format the reference can only LOAD (criteo.jl:464-534); with this the
    interop loop closes in both directions: train here, consume there.

    ``--quantize int8``: instead write a READY-TO-SERVE quantized
    checkpoint directory (int8 chunks + scales + dense towers +
    run_meta.json) — production servers then restore ~4x fewer bytes
    and skip the per-start quantization pass over the full-precision
    stack; eval/predict detect the artifact via run_meta and serve it
    directly."""
    import os

    # like every other subcommand: --platform must be applied BEFORE
    # anything initializes the backend
    _apply_platform(args)
    config = _build_config(args)
    if getattr(args, "quantize", None) == "int8":
        import jax.numpy as jnp
        from dlrm_tpu.io.checkpoint import save_checkpoint
        from dlrm_tpu.ops.quant import quantize_emb_host, table_bytes

        params, config = _load_eval_params(args, config, host=True)
        qemb = quantize_emb_host(params["emb"], config)
        payload = {"bottom": params["bottom"], "top": params["top"],
                   # plain dict, not the QuantEmb node: a custom pytree
                   # would not survive the template-less restore
                   "emb_q": {"chunks": qemb.chunks,
                             "scales": qemb.scales}}
        save_checkpoint(args.out, 0, payload)
        meta = {
            "quantized": "int8",
            "table_sizes": list(config.table_sizes),
            # geometry keys _load_eval_params applies before the
            # QuantEmb shape check (source storage dtype + chunk split)
            "bf16_tables": jnp.dtype(config.embedding_dtype
                                     ) == jnp.bfloat16,
            "chunk_budget_bytes": config.chunk_budget_bytes,
            "deep_chunk_budget_bytes": config.deep_chunk_budget_bytes,
        }
        with open(os.path.join(os.path.abspath(args.out),
                               "run_meta.json"), "w") as f:
            json.dump(meta, f)
        print(json.dumps({"out": args.out,
                          "tables": config.num_tables,
                          "total_rows": config.total_rows,
                          "table_bytes": table_bytes(qemb),
                          "quantized": "int8"}))
        return 0
    from dlrm_tpu.io.hdf5 import save_params

    params, config = _load_eval_params(args, config)
    save_params(args.out, params, config)
    print(json.dumps({"out": args.out,
                      "tables": config.num_tables,
                      "total_rows": config.total_rows,
                      "bytes": os.path.getsize(args.out)}))
    return 0


def cmd_validate(args) -> int:
    from dlrm_tpu.validation import validate

    ok = True
    for path in args.fixtures:
        try:
            report = validate(path, learning_rate=args.lr)
            worst = max(v["max_abs_err"] for v in report.values())
            print(json.dumps({"fixture": path, "ok": True,
                              "checks": len(report),
                              "worst_abs_err": worst}))
        except AssertionError as e:
            ok = False
            print(json.dumps({"fixture": path, "ok": False,
                              "error": str(e)}))
    return 0 if ok else 1


def cmd_instrument(args) -> int:
    _apply_platform(args)
    from dlrm_tpu import init_params
    from dlrm_tpu.data import synthetic
    from dlrm_tpu.utils.telemetry import InstrumentedTrainer, Recorder
    import jax

    config = _build_config(args)
    params = init_params(jax.random.key(config.seed), config)
    trainer = InstrumentedTrainer(config, args.lr)
    rec = Recorder()
    rng = np.random.default_rng(args.seed)
    for i in range(args.steps or 10):
        batch = synthetic.random_batch(rng, config, args.batch_size)
        params, loss = trainer.step(params, batch,
                                    rec if i > 0 else (lambda s: None))
    print(json.dumps({"phase_ms": rec.summary(), "loss": loss}))
    return 0


def cmd_bench(args) -> int:
    _apply_platform(args)
    import jax
    import jax.numpy as jnp
    import dlrm_tpu
    from dlrm_tpu.data import synthetic

    config = _build_config(args)
    params = dlrm_tpu.init_params(jax.random.key(config.seed), config)
    rng = np.random.default_rng(0)
    batch = synthetic.random_batch(rng, config, args.batch_size)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = dlrm_tpu.make_jit_train_step(config, args.lr)
    for _ in range(5):
        params, loss = step(params, batch["dense"], batch["sparse"],
                            batch["labels"])
    jax.block_until_ready(params)
    iters = args.steps or 20
    t0 = time.perf_counter()
    for _ in range(iters):
        params, loss = step(params, batch["dense"], batch["sparse"],
                            batch["labels"])
    jax.block_until_ready(params)
    dt = (time.perf_counter() - t0) / iters
    print(json.dumps({"step_ms": round(dt * 1e3, 3),
                      "examples_per_s": round(args.batch_size / dt, 1)}))
    return 0


# -- argument parsing ----------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dlrm_tpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("preprocess", help="Criteo text -> binary + vocab")
    pp.add_argument("inputs", nargs="+", help="text shards (.txt or .gz)")
    pp.add_argument("--out", required=True, help="output binary path")
    pp.add_argument("--vocab", default=None, help="output vocab .npz path")
    pp.set_defaults(fn=cmd_preprocess)

    tr = sub.add_parser("train", help="train a DLRM")
    _add_config_flags(tr)
    tr.add_argument("--data", default=None, help="binarized dataset "
                    "(default: synthetic)")
    tr.add_argument("--synthetic", default="uniform",
                    help="uniform | skewed (learnable Zipf-id CTR with a "
                    "planted ground truth)")
    tr.add_argument("--eval-data", default=None)
    tr.add_argument("--eval-after", action="store_true")
    tr.add_argument("--eval-every", type=int, default=None,
                    help="evaluate every N steps")
    tr.add_argument("--eval-steps", type=int, default=None)
    tr.add_argument("--shuffle", action="store_true",
                    help="shuffle batch windows each epoch")
    tr.add_argument("--shuffle-rows", action="store_true",
                    help="chunked-permutation ROW shuffle (MLPerf-style): "
                    "permute rows within a window of --shuffle-window "
                    "batches and permute window order; bounded mmap "
                    "locality")
    tr.add_argument("--shuffle-window", type=int, default=8,
                    help="row-shuffle window size in batches")
    tr.add_argument("--batch-size", type=int, default=2048)
    tr.add_argument("--lr", type=float, default=0.1)
    tr.add_argument("--optimizer", default="sgd",
                    help="sgd | adagrad | rowwise_adagrad (one f32 "
                    "accumulator scalar per row, 1/D the optimizer memory "
                    "— the torchrec production default); every optimizer "
                    "runs on every placement: single-chip, sharded "
                    "(slot/row/column/host-resident), two-tier, blocks")
    tr.add_argument("--grad-clip-norm", type=float, default=None,
                    help="global-norm gradient clipping over the step's "
                    "full gradient (dense towers + embedding cotangent). "
                    "Bounds SGD steps directly; Adagrad-family sparse "
                    "steps are gradient-scale invariant, so pick lr "
                    "there (per-step optimizer paths only)")
    tr.add_argument("--lr-schedule", default="constant",
                    help="constant | warmup_poly_decay (MLPerf-style)")
    tr.add_argument("--warmup-steps", type=int, default=0)
    tr.add_argument("--decay-start", type=int, default=0)
    tr.add_argument("--decay-steps", type=int, default=0)
    tr.add_argument("--steps", type=int, default=None)
    tr.add_argument("--epochs", type=int, default=None,
                    help="train for N epochs over --data (alternative "
                    "to --steps)")
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--log-every", type=int, default=100)
    tr.add_argument("--prefetch", type=int, default=2,
                    help="batches transferred to device ahead of compute")
    tr.add_argument("--update-interval", type=int, default=1,
                    help="coalesce the big-table embedding updates of K "
                    "consecutive steps into one scatter (sgd) or one "
                    "dedup-then-apply (adagrad) per chunk per block "
                    "(bounded staleness < K steps, the reference's "
                    "BatchUpdater relaxation)")
    tr.add_argument("--adagrad-impl", default="hybrid",
                    help="exact-adagrad embedding update implementation "
                    "(single-chip): hybrid (default; per-chunk selection "
                    "— dense-G where full-chunk passes are cheaper than "
                    "the dedup argsort: -15%% step time, ~25x faster "
                    "compile) | dedup | dense_g; all exact, same results")
    tr.add_argument("--block-scan", action="store_true",
                    help="adagrad/rowwise blocks: lax.scan over "
                    "micro-steps instead of unrolling — ~8x faster first "
                    "compile, ~5%% slower steady-state (good for short "
                    "runs)")
    tr.add_argument("--profile-dir", default=None,
                    help="capture a jax.profiler trace of a few steps")
    tr.add_argument("--host-prefetch", action="store_true",
                    help="two-tier: software-pipeline the host-tier "
                    "gather — batch N+1's spilled rows are gathered at "
                    "the END of step N's program, after its update "
                    "scatter (exact by data dependency), so step N+1 "
                    "never waits on a host gather at program start")
    tr.add_argument("--hbm-budget-gb", type=float, default=None,
                    help="two-tier tables: spill biggest tables to host "
                    "memory until the device tier fits this many GiB "
                    "(the reference's CacheManager localsize)")
    tr.add_argument("--ckpt-dir", default=None)
    tr.add_argument("--save-interval", type=int, default=1000)
    tr.add_argument("--max-to-keep", type=int, default=3)
    tr.add_argument("--sharded", type=_strict_bool,
                    default=None, help="force hybrid-parallel path: "
                    "true|false (default: auto if >1 device)")
    tr.add_argument("--paranoid", type=int, default=None,
                    help="hybrid mesh debug: every N steps, verify the "
                    "tables are bit-identical across DCN replicas (XOR "
                    "checksum + tiny DCN all-gather); aborts on "
                    "divergence")
    tr.add_argument("--mesh-shape", default=None,
                    help="DCNxICI hybrid mesh, e.g. 2x4 = hosts x cards "
                    "per host: tables shard over the intra-host (ICI) "
                    "axis only (the all-to-all stays inside a host), batch "
                    "data-parallelism spans both axes; sparse updates are "
                    "all-gathered across hosts (DCN) compressed")
    tr.add_argument("--max-rows-per-shard", type=int, default=None,
                    help="row-shard tables bigger than this across the "
                    "mesh (for tables larger than one device's HBM)")
    tr.add_argument("--col-sharded-tables", default=None,
                    help="comma-separated table indices to column-shard "
                    "(feature-dim slices; requires unpacked storage)")
    tr.add_argument("--host-tables", default=None,
                    help="comma-separated table indices to keep in HOST "
                    "memory, row-sharded: each shard stores its block in "
                    "its pinned-host space (tables bigger than the whole "
                    "slice's HBM; sgd or adagrad)")
    _add_dist_flags(tr)
    tr.set_defaults(fn=cmd_train)

    ev = sub.add_parser("eval", help="accuracy / AUC / loss")
    _add_config_flags(ev)
    ev.add_argument("--data", default=None)
    ev.add_argument("--ckpt-dir", default=None)
    ev.add_argument("--hdf5", default=None)
    ev.add_argument("--batch-size", type=int, default=16384)
    ev.add_argument("--eval-steps", type=int, default=None)
    ev.add_argument("--quantize-tables", default=None, choices=["int8"],
                    help="post-training table quantization for serving "
                    "(symmetric per-row int8; ~4x smaller than f32)")
    _add_dist_flags(ev)
    ev.set_defaults(fn=cmd_eval)

    pr = sub.add_parser("predict", help="batch CTR scoring -> .npy")
    _add_config_flags(pr)
    pr.add_argument("--data", default=None, help="binarized dataset")
    pr.add_argument("--ckpt-dir", default=None)
    pr.add_argument("--hdf5", default=None)
    pr.add_argument("--batch-size", type=int, default=16384)
    pr.add_argument("--out", required=True, help="output .npy path")
    pr.add_argument("--quantize-tables", default=None, choices=["int8"],
                    help="post-training table quantization for serving "
                    "(symmetric per-row int8; ~4x smaller than f32)")
    _add_dist_flags(pr)
    pr.set_defaults(fn=cmd_predict)

    ex = sub.add_parser("export", help="checkpoint -> PyTorch-interop HDF5")
    _add_config_flags(ex)
    ex.add_argument("--ckpt-dir", default=None)
    ex.add_argument("--hdf5", default=None,
                    help="re-export from an HDF5 model instead")
    ex.add_argument("--out", required=True,
                    help="output .hdf5 path (or directory with "
                    "--quantize)")
    ex.add_argument("--quantize", default=None, choices=["int8"],
                    help="write a ready-to-serve int8 checkpoint "
                    "directory instead of HDF5 (eval/predict serve it "
                    "directly, no per-start quantization pass)")
    ex.set_defaults(fn=cmd_export)

    va = sub.add_parser("validate", help="PyTorch-fixture parity")
    va.add_argument("fixtures", nargs="+")
    va.add_argument("--lr", type=float, default=10.0)
    va.set_defaults(fn=cmd_validate)

    ins = sub.add_parser("instrument", help="per-phase step breakdown")
    _add_config_flags(ins)
    ins.add_argument("--batch-size", type=int, default=2048)
    ins.add_argument("--lr", type=float, default=0.1)
    ins.add_argument("--steps", type=int, default=10)
    ins.add_argument("--seed", type=int, default=0)
    ins.set_defaults(fn=cmd_instrument)

    be = sub.add_parser("bench", help="synthetic throughput")
    _add_config_flags(be)
    be.add_argument("--batch-size", type=int, default=32768)
    be.add_argument("--lr", type=float, default=0.1)
    be.add_argument("--steps", type=int, default=20)
    be.set_defaults(fn=cmd_bench)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    from dlrm_tpu.utils.backend import setup_compile_cache

    args = build_parser().parse_args(argv)
    setup_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
