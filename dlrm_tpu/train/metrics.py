"""Evaluation metrics: accuracy (the reference's ``test``,
/root/reference/src/train/utils.jl:31-46), ROC AUC (the Criteo north-star
metric the reference lacks), and the ``Every`` periodic-callback combinator
(utils.jl:11-29)."""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np


def binary_accuracy(preds, labels) -> float:
    """Fraction of round(pred) == label (reference test(), utils.jl:38-42)."""
    preds = np.asarray(preds).ravel()
    labels = np.asarray(labels).ravel()
    return float(np.mean((preds >= 0.5) == (labels >= 0.5)))


def auc_roc(preds, labels) -> float:
    """Exact ROC AUC via the rank statistic (Mann-Whitney U), with average
    ranks for ties.  Host-side numpy; for on-device streaming use
    StreamingAUC."""
    preds = np.asarray(preds, np.float64).ravel()
    labels = np.asarray(labels).ravel() >= 0.5
    pos = labels.sum()
    neg = labels.size - pos
    if pos == 0 or neg == 0:
        return float("nan")
    order = np.argsort(preds, kind="mergesort")
    sorted_preds = preds[order]
    ranks = np.empty(labels.size, np.float64)
    # average ranks over tie groups
    i = 0
    while i < labels.size:
        j = i
        while j + 1 < labels.size and sorted_preds[j + 1] == sorted_preds[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    pos_rank_sum = ranks[labels].sum()
    return float((pos_rank_sum - pos * (pos + 1) / 2) / (pos * neg))


@functools.partial(jax.jit, static_argnames=("num_buckets",))
def _auc_device_update(preds, labels, *, num_buckets: int):
    b = jnp.clip((preds * num_buckets).astype(jnp.int32), 0,
                 num_buckets - 1)
    labels = (labels >= 0.5).astype(jnp.float32)
    pos = jnp.zeros(num_buckets, jnp.float32).at[b].add(labels)
    neg = jnp.zeros(num_buckets, jnp.float32).at[b].add(1.0 - labels)
    return pos, neg


class StreamingAUC:
    """Histogram-bucketed streaming AUC for large eval sets: O(buckets)
    memory, device-side accumulation, one tiny transfer per batch.

    Predictions are sigmoid outputs in [0, 1]; bucketed uniformly.  AUC is
    computed from the per-bucket positive/negative counts with the
    trapezoid (tie-averaged) correction — exact up to bucket resolution.
    """

    def __init__(self, num_buckets: int = 1 << 14):
        self.num_buckets = num_buckets
        self.pos = np.zeros(num_buckets, np.float64)
        self.neg = np.zeros(num_buckets, np.float64)

    def update(self, preds, labels) -> None:
        # module-level jit: every StreamingAUC instance (one per eval
        # call) must reuse ONE compiled program, not retrace
        pos, neg = _auc_device_update(preds, labels,
                                      num_buckets=self.num_buckets)
        self.pos += np.asarray(pos, np.float64)
        self.neg += np.asarray(neg, np.float64)

    def compute(self) -> float:
        pos, neg = self.pos, self.neg
        p, n = pos.sum(), neg.sum()
        if p == 0 or n == 0:
            return float("nan")
        # P(score_pos > score_neg) + 0.5 P(equal), bucket-resolution exact
        neg_below = np.concatenate([[0.0], np.cumsum(neg)[:-1]])
        u = (pos * (neg_below + 0.5 * neg)).sum()
        return float(u / (p * n))

    def reset(self) -> None:
        self.pos[:] = 0
        self.neg[:] = 0


class Every:
    """Run ``fn`` every ``n`` calls (reference Every, utils.jl:11-29)."""

    def __init__(self, fn: Callable[[], None], n: int):
        self.fn = fn
        self.n = int(n)
        self.count = 0

    def __call__(self) -> None:
        self.count += 1
        if self.count % self.n == 0:
            self.fn()


def _accumulate(data: Iterable, predict_batch: Callable, *,
                record: Optional[List[float]], auc_buckets: int,
                mp_reduce: bool = False) -> Dict[str, float]:
    """Shared metric loop: accuracy + streaming AUC + mean loss over
    batches scored by ``predict_batch(batch) -> preds``.

    ``mp_reduce``: multi-host mode — each process scores only its LOCAL
    rows (preds/labels are process-local numpy), and the additive counters
    (correct/total/loss_sum + the AUC histograms) are summed across
    processes at the end, so every process reports identical global
    metrics."""
    from dlrm_tpu.ops.loss import bce_loss

    auc = StreamingAUC(auc_buckets)
    correct = 0
    total = 0
    loss_sum = 0.0
    for batch in data:
        preds = predict_batch(batch)
        labels = jnp.asarray(batch["labels"])
        # ONE device->host transfer of the predictions per batch
        p = np.asarray(preds)
        l = np.asarray(labels)
        auc.update(p, l)
        loss_sum += float(bce_loss(preds, labels)) * l.shape[0]
        correct += int(((p >= 0.5) == (l >= 0.5)).sum())
        total += l.shape[0]
    if mp_reduce and jax.process_count() > 1:
        from jax.experimental import multihost_utils

        counts = np.concatenate([[correct, total],
                                 auc.pos, auc.neg]).astype(np.float64)
        # The allgather rides the device mesh, so f64 degrades to f32 in
        # transport.  Counts must stay integer-exact past 2^24 (Terabyte
        # eval is ~89M rows), so ship each count as two f32-exact halves
        # (hi/lo base 2^24 — exact per process up to 2^48) and recombine
        # after the f64 host-side sum.  loss_sum is a genuine float; f32
        # transport precision is fine for it.
        hi = np.floor(counts / 2.0**24)
        lo = counts - hi * 2.0**24
        packed = np.concatenate([hi, lo, [loss_sum]])
        gathered = np.asarray(
            multihost_utils.process_allgather(packed),
            np.float64).sum(axis=0)
        k = counts.shape[0]
        counts = gathered[:k] * 2.0**24 + gathered[k:2 * k]
        loss_sum = float(gathered[2 * k])
        # hand back Python scalars (np.float32 breaks json.dumps
        # downstream)
        correct, total = float(counts[0]), int(counts[1])
        auc.pos = counts[2:2 + auc.num_buckets]
        auc.neg = counts[2 + auc.num_buckets:]
    acc = correct / max(total, 1)
    if record is not None:
        record.append(acc)  # reference: push!(record, accuracy)
    return {"accuracy": acc, "auc": auc.compute(),
            "loss": loss_sum / max(total, 1), "examples": total}


_EVAL_FWD_CACHE: dict = {}


def _eval_forward(config):
    """Jitted eval forward, cached per config — periodic evals must reuse
    one compiled program, not retrace a fresh lambda every call."""
    fwd = _EVAL_FWD_CACHE.get(config)
    if fwd is None:
        from dlrm_tpu.models.dlrm import forward

        fwd = jax.jit(lambda p, d, s: forward(p, d, s, config))
        _EVAL_FWD_CACHE[config] = fwd
    return fwd


def evaluate(params: dict, data: Iterable, config, *,
             record: Optional[List[float]] = None,
             auc_buckets: int = 1 << 14) -> Dict[str, float]:
    """Full-dataset eval: accuracy + streaming AUC + mean loss.

    The reference's test() computes accuracy only and appends to a record
    vector (utils.jl:31-46); AUC is the Criteo benchmark target (BASELINE)."""
    fwd = _eval_forward(config)
    return _accumulate(
        data,
        lambda b: fwd(params, jnp.asarray(b["dense"]),
                      jnp.asarray(b["sparse"])),
        record=record, auc_buckets=auc_buckets)


def make_sharded_eval_forward(config, mesh, placement, axis: str = "d"):
    """Jitted on-mesh eval forward; build ONCE per (config, mesh,
    placement) and pass to :func:`sharded_evaluate` — a fresh jit per eval
    would recompile the whole mesh program every time."""
    from dlrm_tpu.models.dlrm import forward_from_pooled
    from dlrm_tpu.parallel import embedding as pemb
    from dlrm_tpu.train.train import check_mesh_interaction

    check_mesh_interaction(config)

    @jax.jit
    def fwd(dp, emb, emb_h, cs, scales, cs_scales, dense, sparse):
        pooled = pemb.sharded_lookup(
            emb, sparse, mesh=mesh, placement=placement, axis=axis,
            cs=cs, emb_h=emb_h, exchange_dtype=config.exchange_dtype,
            scales=scales, cs_scales=cs_scales)
        return forward_from_pooled(dp, pooled, dense, config)

    return fwd


def sharded_evaluate(params: dict, data: Iterable, config, *, mesh,
                     placement, axis: str = "d", fwd=None,
                     record: Optional[List[float]] = None,
                     auc_buckets: int = 1 << 14) -> Dict[str, float]:
    """Eval directly on the sharded parameters — the forward runs on the
    mesh (sharded lookup + data-parallel MLPs) and only the (B,) prediction
    vector comes to host per batch, so the tables are never gathered (they
    may not fit one host for Terabyte-scale configs).  Pass ``fwd`` from
    :func:`make_sharded_eval_forward` to reuse the compiled program across
    periodic evals.

    Ragged trailing batches (dataset size not a multiple of the batch
    size) are padded to a mesh multiple by repeating the last row and the
    padded predictions are trimmed before accumulation, so every dataset
    row counts exactly once — matching the reference's ``test()`` which
    covers every row (utils.jl:31-46).  Multi-host feeding requires even
    per-process stripes and keeps full batches (run.py enforces it)."""
    from dlrm_tpu.parallel.mesh import batch_sharding

    if fwd is None:
        fwd = make_sharded_eval_forward(config, mesh, placement, axis)
    dense_params = {"bottom": params["bottom"], "top": params["top"]}
    bs = batch_sharding(mesh, axis)
    multiproc = jax.process_count() > 1
    n_dev = mesh.devices.size

    def predict_batch(batch):
        dense = np.asarray(batch["dense"])
        sparse = np.asarray(batch["sparse"])
        b = dense.shape[0]
        pad = 0 if multiproc else (-b) % n_dev
        if pad:  # repeat the last row; predictions trimmed below
            dense = np.concatenate([dense, np.repeat(dense[-1:], pad, 0)])
            sparse = np.concatenate([sparse,
                                     np.repeat(sparse[-1:], pad, 0)])
        if multiproc:
            # multi-host: ``batch`` holds this process's LOCAL rows; build
            # the global batch from every process's slice, run the mesh
            # forward, and hand back only the local prediction rows
            # (global-index order) for process-local accumulation
            ratio = jax.process_count()
            dense = jax.make_array_from_process_local_data(
                bs, dense, global_shape=(dense.shape[0] * ratio,)
                + dense.shape[1:])
            sparse = jax.make_array_from_process_local_data(
                bs, sparse, global_shape=(sparse.shape[0] * ratio,)
                + sparse.shape[1:])
        else:
            dense = jax.device_put(jnp.asarray(dense), bs)
            sparse = jax.device_put(jnp.asarray(sparse), bs)
        preds = fwd(dense_params, params["emb"], params.get("emb_h"),
                    params.get("emb_cs", ()),
                    params.get("emb_scales"),
                    params.get("emb_cs_scales", ()), dense, sparse)
        if multiproc:
            parts = {(s.index[0].start or 0): np.asarray(s.data)
                     for s in preds.addressable_shards}  # dedupe replicas
            local = np.concatenate([parts[k] for k in sorted(parts)])
            if local.shape[0] != len(batch["labels"]):
                raise RuntimeError(
                    f"eval forward returned {local.shape[0]} local rows "
                    f"for {len(batch['labels'])} local labels — the mesh "
                    "output sharding no longer stripes the batch per "
                    "process")
            return local
        return np.asarray(preds)[:b] if pad else preds

    return _accumulate(data, predict_batch, record=record,
                       auc_buckets=auc_buckets, mp_reduce=multiproc)
