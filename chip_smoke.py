"""Proof that the DLRM training path runs on an NVIDIA GPU.

    python chip_smoke.py             # one card: phases 1-6 below
    python chip_smoke.py --chips 4   # four cards: the sharded step only

One process owns the card(s); the CLI runs in-process through
``dlrm_tpu.run.main``.  Phases, in order, each printing what it finds:

  1. device      nvidia-smi's name and power limit, JAX's devices; exits
                 non-zero unless the platform is "gpu"
  2. compile     the Kaggle fs=16 exact-SGD step at B=32768: compile time
                 and ``memory_analysis()``
  3. reference   one such step on Zipf-skewed ids against a plain float32
                 reference (unpacked tables, jnp.take, dense jax.grad, SGD)
                 at matmul precision "highest"; then the default-precision
                 step's loss gap, and stored rows read back bit for bit
  4. cli train   ``train --config kaggle --feature-size 16`` for 20 steps
                 with --eval-after: finite, falling loss and eval metrics
  5. fs=128      the same CLI at --feature-size 128 (f32 tables, default
                 interaction) for a few steps, and the fused interaction
                 kernel against ``ops.interaction.dot_interaction``
  6. host tier   the largest tables spilled to pinned host memory: the
                 CLI with --hbm-budget-gb, and three tiered steps against
                 the single-tier step

``--chips 4``: a Kaggle fs=16, B=32768 (global) sharded step on a 1-D mesh
of the four cards, with slot placement and row-sharded tables (forced by
max_rows_per_shard), against the single-card step on the same batch at
"highest"; then the CLI's sharded train for a few steps.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Any failed phase raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

BATCH = 32768
LR = 0.1
# phase 6: spills Kaggle fs=16's three largest tables (1.2 GB of 2.2 GB)
HOST_TIER_BUDGET_GB = 1.0
HOST_TIER_BATCH = 8192
# Phase 3, both sides at matmul precision "highest": the loss may differ by
# float32 rounding of the summation order only, every weight and table row
# by sums of a few thousand duplicate-id gradients taken in another order.
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
# Phase 5: the fused kernel sums 128 products per gram entry in its own
# order; errors relative to the largest reference magnitude.
KERNEL_RTOL = 1e-6


def say(*a):
    print(*a, flush=True)


# -- the plain float32 reference (phase 3; also tests/test_chip_smoke.py) ----

def reference_loss(dense_params, tables, dense, sparse, labels, config):
    """The DLRM forward and loss written plainly: one (R, D) array per
    table, jnp.take lookups, the gram interaction, jnp matmuls."""
    import jax
    import jax.numpy as jnp

    from dlrm_tpu.ops.loss import bce_loss

    cols = []
    for t, tab in enumerate(tables):
        rows = jnp.take(tab, sparse[:, t], axis=0)
        cols.append(rows.sum(axis=1) if rows.ndim == 3 else rows)
    pooled = jnp.stack(cols, axis=1)                       # (B, T, D)
    x = dense
    for layer in dense_params["bottom"]:
        x = jax.nn.relu(x @ layer["w"] + layer["b"])
    b, d = x.shape
    feats = jnp.concatenate([x[:, None, :], pooled.reshape(b, -1, d)], 1)
    z = jnp.einsum("bfd,bgd->bfg", feats, feats)
    i, j = np.tril_indices(feats.shape[1], k=-1)
    h = jnp.concatenate([x, z[:, i, j]], axis=1)
    h = jnp.pad(h, ((0, 0), (0, config.top_input - h.shape[1])))
    top = dense_params["top"]
    for k, layer in enumerate(top):
        h = h @ layer["w"] + layer["b"]
        h = jax.nn.sigmoid(h) if k == len(top) - 1 else jax.nn.relu(h)
    return bce_loss(h[:, 0], labels)


def reference_step(dense_params, tables, dense, sparse, labels, config, lr):
    """Dense jax.grad through :func:`reference_loss`, then plain SGD."""
    import jax

    loss, (g_dense, g_tabs) = jax.value_and_grad(
        reference_loss, argnums=(0, 1))(dense_params, tables, dense,
                                         sparse, labels, config)
    new_dense = jax.tree.map(lambda p, g: p - lr * g, dense_params, g_dense)
    new_tabs = [t - lr * g for t, g in zip(tables, g_tabs)]
    return loss, new_dense, new_tabs


def logical_tables(emb, config):
    """Engine storage -> host (total_rows, D) numpy stack."""
    import jax

    from dlrm_tpu.ops import embedding as emb_ops

    return np.asarray(emb_ops.unpack_tables(
        tuple(np.asarray(c) for c in jax.device_get(emb)), config))


def compare_with_reference(config, params, batch, lr, step=None):
    """Run the engine's SGD step and the reference step on ``batch`` from
    the same ``params``; returns the errors the tolerances apply to.

    ``step`` defaults to ``make_jit_train_step(config, lr)``; params are
    copied first (the engine step donates them)."""
    import jax
    import jax.numpy as jnp

    import dlrm_tpu

    dense, sparse, labels = (jnp.asarray(batch[k])
                             for k in ("dense", "sparse", "labels"))
    before = logical_tables(params["emb"], config)
    dense_params = {"bottom": params["bottom"], "top": params["top"]}
    tables = [jnp.asarray(before[o:o + n]) for o, n in
              zip(config.table_offsets, config.table_sizes)]
    ref = jax.jit(reference_step, static_argnums=(5, 6))
    r_loss, r_dense, r_tabs = ref(dense_params, tables, dense, sparse,
                                  labels, config, lr)
    r_tabs = np.concatenate([np.asarray(t) for t in r_tabs])
    tables = None
    if step is None:
        step = dlrm_tpu.make_jit_train_step(config, lr)
    new, loss = step(jax.tree.map(jnp.copy, params), dense, sparse, labels)
    got = logical_tables(new["emb"], config)

    sp = np.asarray(batch["sparse"]).reshape(sparse.shape[0],
                                             config.num_tables, -1)
    touched = np.unique(np.concatenate(
        [sp[:, t].ravel() + config.table_offsets[t]
         for t in range(config.num_tables)]))
    untouched = np.ones(len(before), bool)
    untouched[touched] = False
    w_err = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                for a, b in zip(jax.tree.leaves(
                    {"bottom": new["bottom"], "top": new["top"]}),
                    jax.tree.leaves(r_dense)))
    return {
        "loss": float(loss), "ref_loss": float(r_loss),
        "loss_rel_err": abs(float(loss) - float(r_loss))
        / abs(float(r_loss)),
        "weight_max_abs_err": w_err,
        "touched_rows": int(touched.size),
        "row_max_abs_err": float(np.max(np.abs(got[touched]
                                               - r_tabs[touched]))),
        "untouched_rows_unchanged": bool(np.array_equal(
            got[untouched], before[untouched])),
    }


def check_reference_report(rep: dict) -> None:
    assert rep["loss_rel_err"] <= LOSS_RTOL, rep
    assert rep["weight_max_abs_err"] <= PARAM_ATOL, rep
    assert rep["row_max_abs_err"] <= PARAM_ATOL, rep
    assert rep["untouched_rows_unchanged"], rep


# -- helpers ---------------------------------------------------------------------

class _Tee(io.TextIOBase):
    """Copy what the CLI writes to a buffer and on to the real stream."""

    def __init__(self, stream):
        self.stream, self.buf = stream, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


def run_cli(argv):
    """``dlrm_tpu.run.main(argv)`` in this process; returns (result JSON,
    stderr text).  Raises on a non-zero return."""
    from dlrm_tpu import run

    say("$ python -m dlrm_tpu " + " ".join(argv))
    out, err = _Tee(sys.stdout), _Tee(sys.stderr)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(argv)
    if rc != 0:
        raise RuntimeError(f"CLI returned {rc}: {argv}")
    say(f"  ({time.perf_counter() - t0:.1f} s)")
    lines = [ln for ln in out.buf.getvalue().splitlines() if ln.strip()]
    return json.loads(lines[-1]), err.buf.getvalue()


def logged_losses(stderr_text):
    return [float(ln.split()[3]) for ln in stderr_text.splitlines()
            if ln.startswith("step ") and " loss " in ln]


def skewed_batch(config, batch, seed=1):
    from dlrm_tpu.data.synthetic import ClickthroughModel

    truth = ClickthroughModel(config, seed=12345)
    return truth.batch(np.random.default_rng(seed), batch)


def dup_share(sparse):
    """Mean share of duplicate ids per table column."""
    n = sparse.shape[0]
    return float(np.mean([1 - np.unique(sparse[:, t]).size / n
                          for t in range(sparse.shape[1])]))


# -- phases ----------------------------------------------------------------------

def phase_device(chips):
    import jax

    from dlrm_tpu.utils import backend

    say("[1 device]")
    smi = backend.gpu_name_and_power()
    say(f"  nvidia-smi: {smi if smi is not None else 'not available'}")
    devs = backend.require_gpu("chip_smoke.py")
    rec = backend.device_record(devs)
    say(f"  jax {jax.__version__}: {rec['count']} x {rec['kind']} "
        f"(platform {rec['platform']})")
    if len(devs) < chips:
        raise SystemExit(f"--chips {chips} needs {chips} devices, JAX "
                         f"found {len(devs)}")
    say(f"  compile cache: {backend.setup_compile_cache()}")
    return rec, smi


def kaggle(fs, **kw):
    import jax

    from dlrm_tpu import config as cfg

    c = cfg.kaggle_config(fs, **kw)
    if "interaction_impl" not in kw:  # what the CLI picks on one card
        import dataclasses
        c = dataclasses.replace(c, interaction_impl=cfg.default_interaction_impl(
            c, jax.default_backend(), True))
    return c


def phase_compile():
    import jax
    import jax.numpy as jnp

    import dlrm_tpu

    say("[2 compile]")
    config = kaggle(16)
    say(f"  Kaggle fs=16: {config.total_rows:,} rows in "
        f"{config.num_chunks} chunks, interaction {config.interaction_impl}")
    params = dlrm_tpu.init_params(jax.random.key(0), config)
    batch = skewed_batch(config, BATCH)
    args = [jnp.asarray(batch[k]) for k in ("dense", "sparse", "labels")]
    step = dlrm_tpu.make_jit_train_step(config, LR)
    t0 = time.perf_counter()
    compiled = step.lower(params, *args).compile()
    say(f"  compile: {time.perf_counter() - t0:.1f} s")
    say(f"  memory_analysis: {compiled.memory_analysis()}")
    return config, params, batch, step


def phase_reference(config, params, batch, step):
    import jax
    import jax.numpy as jnp

    from dlrm_tpu.ops import embedding as emb_ops

    say("[3 reference]")
    say(f"  batch: {BATCH} skewed ids, mean duplicate share per table "
        f"{dup_share(batch['sparse']):.4f}")
    with jax.default_matmul_precision("highest"):
        rep = compare_with_reference(config, params, batch, LR)
    say("  highest: " + json.dumps(rep))
    check_reference_report(rep)
    say(f"  within loss rtol {LOSS_RTOL}, weight/row atol {PARAM_ATOL}")
    _, loss = step(jax.tree.map(jnp.copy, params),
                   *(jnp.asarray(batch[k])
                     for k in ("dense", "sparse", "labels")))
    say(f"  default precision (TF32 products): loss {float(loss):.7f}, gap "
        f"to the reference {abs(float(loss) - rep['ref_loss']):.3e}")
    got = np.asarray(jax.jit(lambda e, s: emb_ops.mixed_lookup(
        e, s, config))(params["emb"], jnp.asarray(batch["sparse"])))
    stored = logical_tables(params["emb"], config)[
        batch["sparse"] + np.asarray(config.table_offsets)]
    assert np.array_equal(got, stored), "lookup changed stored rows"
    say("  lookup at default precision returns stored rows bit for bit")


def phase_cli_train():
    say("[4 cli train]")
    res, err = run_cli([
        "train", "--config", "kaggle", "--feature-size", "16",
        "--batch-size", str(BATCH), "--steps", "20", "--synthetic",
        "skewed", "--eval-after", "--log-every", "1"])
    losses = logged_losses(err)
    assert len(losses) == 20 and np.all(np.isfinite(losses)), losses
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    say(f"  loss {losses[0]:.5f} -> {losses[-1]:.5f} (mean of first five "
        f"{first:.5f}, last five {last:.5f})")
    assert last < first, "loss did not fall"
    ev = res["eval"]
    for k in ("accuracy", "auc", "loss"):
        assert np.isfinite(ev[k]), ev
    say(f"  eval: accuracy {ev['accuracy']:.4f} auc {ev['auc']:.4f} "
        f"loss {ev['loss']:.5f}")


def phase_fs128():
    import jax
    import jax.numpy as jnp

    from dlrm_tpu.ops import interaction_triton as it
    from dlrm_tpu.ops.interaction import dot_interaction

    say("[5 fs=128]")
    res, err = run_cli([
        "train", "--config", "kaggle", "--feature-size", "128",
        "--batch-size", str(BATCH), "--steps", "4", "--synthetic",
        "skewed", "--log-every", "1"])
    losses = logged_losses(err)
    assert len(losses) == 4 and np.all(np.isfinite(losses)), losses
    say(f"  f32 tables, losses {[round(x, 5) for x in losses]}")
    f, d = 27, 128
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(BATCH, d)).astype(np.float32))
    feats = jnp.asarray(rng.normal(size=(BATCH, f - 1, d)).astype(
        np.float32))
    cot = jnp.asarray(rng.normal(
        size=(BATCH, d + f * (f - 1) // 2)).astype(np.float32))
    with jax.default_matmul_precision("highest"):
        for name, fn in (("fused", it.fused_dot_interaction),
                         ("gram", dot_interaction)):
            out, vjp = jax.vjp(fn, x, feats)
            res_ = (out,) + vjp(cot)
            if name == "fused":
                got = [np.asarray(a) for a in res_]
            else:
                want = [np.asarray(a) for a in res_]
    for part, g, w in zip(("forward", "d_x", "d_feats"), got, want):
        err_ = float(np.max(np.abs(g - w)))
        scale = float(np.max(np.abs(w)))
        say(f"  fused vs gram {part}: max abs err {err_:.3e} "
            f"(max |gram| {scale:.3e})")
        assert err_ <= KERNEL_RTOL * scale, (part, err_, scale)


def phase_host_tier():
    import jax
    import jax.numpy as jnp

    import dlrm_tpu
    from dlrm_tpu.parallel import host_tier as ht
    from dlrm_tpu.utils import backend

    say("[6 host tier]")
    say(f"  compute_on('device_host') lowers: "
        f"{backend.host_compute_supported()}; pinned jit outputs: "
        f"{backend.can_pin_host_outputs()}")
    b, budget_gb = HOST_TIER_BATCH, HOST_TIER_BUDGET_GB
    run_cli(["train", "--config", "kaggle", "--feature-size", "16",
             "--batch-size", str(b), "--steps", "2", "--synthetic",
             "skewed", "--hbm-budget-gb", str(budget_gb),
             "--log-every", "1"])
    config = kaggle(16)
    plan = ht.plan_tiers(config, int(budget_gb * (1 << 30)))
    assert plan.host_tables and plan.device_tables, plan
    say(f"  host tables {list(plan.host_tables)} ({plan.host_rows:,} rows "
        f"pinned), {len(plan.device_tables)} tables on the device")
    params = dlrm_tpu.init_params(jax.random.key(0), config)
    batches = [skewed_batch(config, b, seed=s) for s in (1, 2, 3)]
    with jax.default_matmul_precision("highest"):
        tiered = ht.init_tiered_params(params, plan, config)
        single = jax.tree.map(jnp.copy, params)
        params = None
        t_step = ht.make_tiered_train_step(config, LR, plan)
        s_step = dlrm_tpu.make_jit_train_step(config, LR)
        for k, bt in enumerate(batches):
            args = [jnp.asarray(bt[key])
                    for key in ("dense", "sparse", "labels")]
            tiered, t_loss = t_step(tiered, *args)
            single, s_loss = s_step(single, *args)
            say(f"  step {k + 1}: tiered loss {float(t_loss):.7f}, "
                f"single-tier {float(s_loss):.7f}")
            assert abs(float(t_loss) - float(s_loss)) <= \
                LOSS_RTOL * abs(float(s_loss))
    merged = ht.merge_tiers(tiered["emb_dev"], np.asarray(
        tiered["emb_host"]), plan, config)
    row_err = float(np.max(np.abs(merged - logical_tables(single["emb"],
                                                          config))))
    w_err = max(float(np.max(np.abs(np.asarray(a) - np.asarray(c))))
                for a, c in zip(
                    jax.tree.leaves([tiered["bottom"], tiered["top"]]),
                    jax.tree.leaves([single["bottom"], single["top"]])))
    say(f"  after 3 steps: table max abs err {row_err:.3e}, weights "
        f"{w_err:.3e}")
    assert row_err <= PARAM_ATOL and w_err <= PARAM_ATOL


def phase_checkpoint():
    """A save and restore through orbax, where it is installed."""
    import jax
    import jax.numpy as jnp

    from dlrm_tpu.io import checkpoint

    if checkpoint.ocp is None:
        say("[checkpoint] skipped: orbax-checkpoint is not installed")
        return
    tree = {"w": jnp.arange(12.0).reshape(3, 4), "b": jnp.ones(3)}
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save_checkpoint(d, 7, tree)
        got, step = checkpoint.restore_checkpoint(d)
    assert step == 7 and all(np.array_equal(np.asarray(a), np.asarray(b))
                             for a, b in zip(jax.tree.leaves(got),
                                             jax.tree.leaves(tree)))
    say("[checkpoint] orbax save/restore round trip ok")


def phase_sharded(chips):
    import jax
    import jax.numpy as jnp

    import dlrm_tpu
    from dlrm_tpu.parallel import embedding as pemb
    from dlrm_tpu.parallel.mesh import (batch_sharding, make_mesh,
                                        param_shardings)
    from dlrm_tpu.parallel.placement import plan_placement
    from dlrm_tpu.train.train import make_sharded_train_step

    say(f"[sharded] Kaggle fs=16, B={BATCH} over a 1-D mesh of {chips}")
    config = kaggle(16, interaction_impl="gram")
    max_rows = 4_000_000
    placement = plan_placement(config.table_sizes, chips, pack=config.pack,
                               max_rows_per_shard=max_rows)
    assert placement.row_sharded, placement
    say(f"  row-sharded tables (> {max_rows:,} rows): "
        f"{list(placement.row_sharded)}; the rest slot-placed")
    mesh = make_mesh(chips)
    say(f"  mesh devices: {[str(d) for d in mesh.devices.ravel()]}")
    params = dlrm_tpu.init_params(jax.random.key(0), config)
    batch = skewed_batch(config, BATCH)
    # host copies: the sharded step donates its buffers, which must not be
    # the single-card params'
    sh = {"bottom": jax.device_get(params["bottom"]),
          "top": jax.device_get(params["top"]),
          "emb": pemb.shard_tables(params["emb"], placement, config)}
    sh = jax.device_put(sh, param_shardings(mesh, sh))
    bs = batch_sharding(mesh)
    args = [jax.device_put(jnp.asarray(batch[k]), bs)
            for k in ("dense", "sparse", "labels")]
    with jax.default_matmul_precision("highest"):
        step = make_sharded_train_step(config, LR, mesh, placement)
        t0 = time.perf_counter()
        new_sh, loss = step(sh, *args)
        loss = float(loss)
        say(f"  sharded step (compile + run): "
            f"{time.perf_counter() - t0:.1f} s")
        shards = {d.id for d in new_sh["emb"].sharding.device_set}
        assert len(shards) == chips, shards
        single = dlrm_tpu.make_jit_train_step(config, LR)
        new_1, loss_1 = single(params, *(jnp.asarray(batch[k]) for k in
                                         ("dense", "sparse", "labels")))
        loss_1 = float(loss_1)
    got = pemb.unshard_tables(np.asarray(new_sh["emb"]), placement, config)
    want = logical_tables(new_1["emb"], config)
    row_err = float(np.max(np.abs(got - want)))
    w_err = max(float(np.max(np.abs(np.asarray(a) - np.asarray(c))))
                for a, c in zip(
                    jax.tree.leaves([new_sh["bottom"], new_sh["top"]]),
                    jax.tree.leaves([new_1["bottom"], new_1["top"]])))
    rel = abs(loss - loss_1) / abs(loss_1)
    say(f"  loss sharded {loss:.7f} vs one card {loss_1:.7f} (rel "
        f"{rel:.2e}); tables max abs err {row_err:.3e}; weights "
        f"{w_err:.3e}")
    assert rel <= LOSS_RTOL and row_err <= PARAM_ATOL and \
        w_err <= PARAM_ATOL
    new_sh = sh = new_1 = params = None
    res, err = run_cli([
        "train", "--config", "kaggle", "--feature-size", "16",
        "--batch-size", str(BATCH), "--steps", "3", "--synthetic",
        "skewed", "--max-rows-per-shard", str(max_rows),
        "--log-every", "1"])
    assert "sharded=True" in err, err
    losses = logged_losses(err)
    assert len(losses) == 3 and np.all(np.isfinite(losses)), losses


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chips", type=int, default=1, choices=[1, 4],
                   help="4: run only the sharded path and its one-card "
                   "comparison")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    rec, smi = phase_device(args.chips)
    if args.chips == 1:
        config, params, batch, step = phase_compile()
        phase_reference(config, params, batch, step)
        params = batch = step = None
        phase_cli_train()
        phase_fs128()
        phase_host_tier()
        phase_checkpoint()
    else:
        phase_sharded(args.chips)
    say(f"all phases passed in {time.perf_counter() - t0:.0f} s")
    say(f"card: {smi}")
    say(json.dumps({"ok": True, "device": rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
