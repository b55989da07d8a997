"""Time-to-AUC curve generator on the planted-truth synthetic task.

The Criteo north star (BASELINE.json: AUC 0.8025 on real Terabyte data)
is unreachable in this zero-egress environment, so the stand-in is the
Kaggle-scale skewed synthetic with a planted Zipf CTR ground truth
(data/synthetic.ClickthroughModel — same generator the CLI's
``--synthetic skewed`` uses, seed 12345).  This script writes one curve
per feature size (``AUC_CURVE_fs<fs>.json`` by default):

* fs=16 (``--feature-size 16``): adagrad, lr 0.005;
* fs=128, the MLPerf/Terabyte shape (criteo.jl:379-406): f32 tables
  (17.3 GB, which one 80 GB card holds), rowwise adagrad, lr 0.002
  (adagrad first steps are sign-updates of magnitude lr per element;
  lr=0.05 saturates the fs=128 interaction inputs while lr=0.002
  trains).

Each curve row records wall-clock seconds (including compile), examples
consumed, and held-out accuracy / AUC / loss.

Run on the GPU (``--tiny`` runs a tiny config anywhere):
    python make_auc_curve.py --feature-size 128 --steps 600 \
        --eval-every 50 --out AUC_CURVE_fs128.json
"""

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--feature-size", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=32768)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--optimizer", default=None,
                    help="default: rowwise_adagrad at fs>=128, adagrad "
                         "below")
    ap.add_argument("--out", default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config (CPU smoke of the script itself)")
    args = ap.parse_args()

    from dlrm_tpu.utils import backend
    if not args.tiny:
        backend.require_gpu("make_auc_curve.py (use --tiny off the GPU)")
    backend.setup_compile_cache()
    import jax
    import jax.numpy as jnp
    import dlrm_tpu
    from dlrm_tpu.data.synthetic import ClickthroughModel
    from dlrm_tpu.train.metrics import evaluate
    from dlrm_tpu.train.train import init_opt_state, make_jit_train_step_opt

    fs = args.feature_size
    optimizer = args.optimizer or ("rowwise_adagrad" if fs >= 128
                                   else "adagrad")
    lr = args.lr if args.lr is not None else (0.002 if fs >= 128 else 0.005)
    out_path = args.out or f"AUC_CURVE_fs{fs}.json"
    kw = {}
    if args.tiny:
        import dataclasses
        config = dataclasses.replace(
            dlrm_tpu.tiny_config(num_tables=6, rows=512, feature_size=fs),
            table_sizes=(512, 2000, 64, 4096, 256, 1024), **kw)
    else:
        config = dlrm_tpu.kaggle_config(feature_size=fs, **kw)
    B = args.batch_size
    log(f"config: kaggle fs={fs} {config.total_rows:,} rows, "
        f"optimizer={optimizer} lr={lr} B={B}")

    t0 = time.time()
    truth = ClickthroughModel(config, seed=12345)
    params = dlrm_tpu.init_params(jax.random.key(0), config)
    opt = init_opt_state(params, config=config, optimizer=optimizer, lr=lr)
    step = make_jit_train_step_opt(config, optimizer=optimizer, lr=lr)

    def eval_iter():
        return truth.stream(B, steps=args.eval_batches, seed=777)

    curve = []

    def eval_point(n_steps):
        m = evaluate(params, eval_iter(), config)
        m["examples"] = n_steps * B
        m["step"] = n_steps
        m["wall_s"] = round(time.time() - t0, 1)
        curve.append({k: (round(float(v), 6) if isinstance(v, float)
                          else v) for k, v in m.items()})
        log(f"step {n_steps}: acc={m['accuracy']:.4f} auc={m['auc']:.4f} "
            f"loss={m['loss']:.5f} wall={m['wall_s']}s")

    eval_point(0)
    n = 0
    for batch in truth.stream(B, steps=args.steps, seed=1):
        (params, opt), loss = step(params, opt,
                                   jnp.asarray(batch["dense"]),
                                   jnp.asarray(batch["sparse"]),
                                   jnp.asarray(batch["labels"]))
        n += 1
        if n % args.eval_every == 0:
            eval_point(n)
    if n % args.eval_every:
        eval_point(n)

    payload = {
        "task": "kaggle-scale skewed synthetic (planted Zipf CTR ground "
                "truth; real Criteo DAC unavailable: zero-egress "
                "environment)",
        "config": f"kaggle fs={fs} B={B} {optimizer} lr={lr}"
                  + (" bf16-tables" if fs >= 128 else ""),
        "budget_examples": args.steps * B,
        "seed": 12345,
        "curve": curve,
    }
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=1)
    log(f"wrote {out_path} ({len(curve)} points, "
        f"final auc {curve[-1]['auc']:.4f})")
    print(json.dumps({"metric": f"auc_curve_fs{fs}",
                      "value": curve[-1]["auc"],
                      "unit": "auc", "points": len(curve)}))


if __name__ == "__main__":
    main()
