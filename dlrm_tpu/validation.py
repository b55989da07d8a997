"""PyTorch-fixture parity harness.

Port of the reference's validator (/root/reference/src/validation.jl:1-146):
load a PyTorch-exported model + inputs from HDF5, check the inference loss,
run ONE SGD step at lr=10, then assert the updated
weights/biases/embeddings match the PyTorch dump:

  * our updated parameters must equal the dump's ``update_*`` datasets —
    since both sides start from the SAME loaded originals and apply
    p' = p - lr*g with the same lr, this is exactly a per-layer gradient
    parity check (g_ours == (original - update_*) / lr) without forming
    the quotient,
  * and the dump's original != updated, for weights AND biases (guards
    against trivial passes, validation.jl:97-121).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import jax
import jax.numpy as jnp

from dlrm_tpu.io import hdf5 as h5io
from dlrm_tpu.models import dlrm as model_lib
from dlrm_tpu.ops.loss import bce_loss
from dlrm_tpu.train.train import train_step


def _check(name: str, a, b, atol: float, rtol: float, report: Dict) -> None:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    ok = np.allclose(a, b, atol=atol, rtol=rtol)
    report[name] = {"max_abs_err": err, "ok": bool(ok)}
    if not ok:
        raise AssertionError(f"parity failure at {name}: max|err|={err}")


def validate(path: str, learning_rate: float = 10.0, atol: float = 1e-4,
             rtol: float = 1e-4) -> Dict:
    """Run the full parity protocol against one fixture; returns a report of
    per-check max errors.  Raises AssertionError on any mismatch.

    Numerics are pinned to full-precision matmuls for the duration — parity
    against the PyTorch float32 dump must not depend on the ambient
    ``jax_default_matmul_precision`` (the GPU's default runs float32
    products in TF32; this harness is the one place that must not).
    """
    with jax.default_matmul_precision("highest"):
        return _validate(path, learning_rate, atol, rtol)


def _validate(path: str, learning_rate: float, atol: float, rtol: float
              ) -> Dict:
    params, config = h5io.load_params(path)
    inputs = h5io.load_inputs(path)
    ref = h5io.load_reference_outputs(path)
    report: Dict = {}

    params = jax.tree.map(jnp.asarray, params)
    dense = jnp.asarray(inputs["dense"])
    sparse = jnp.asarray(inputs["sparse"])
    labels = jnp.asarray(inputs["labels"])

    # --- inference parity (validation.jl:12-21) ---
    out = model_lib.forward(params, dense, sparse, config)
    loss = bce_loss(out, labels)
    _check("loss", loss, ref["loss"], atol, rtol, report)
    _check("mlp_top", np.asarray(out)[:, None], ref["mlp_top"], atol, rtol,
           report)

    # --- one SGD step (validation.jl:23-33) ---
    original = jax.tree.map(np.asarray, params)
    new_params, _ = jax.jit(
        lambda p, d, s, l: train_step(p, d, s, l, config=config,
                                      lr=learning_rate)
    )(params, dense, sparse, labels)
    new_params = jax.tree.map(np.asarray, new_params)

    # --- MLPs (validation.jl:74-123) ---
    for key, ours_new, ours_old, hprefix in (
        ("top", new_params["top"], original["top"], "update_top"),
        ("bottom", new_params["bottom"], original["bottom"], "update_bot"),
    ):
        layer_ids = sorted(
            {int(k.split("_")[-1].split(".")[0])
             for k in ref if k.startswith(hprefix)})
        assert len(layer_ids) == len(ours_new), (key, layer_ids)
        for i, lid in enumerate(layer_ids):
            upd_w = ref[f"{hprefix}_{lid}.weight"].T  # (out,in)->(in,out)
            upd_b = ref[f"{hprefix}_{lid}.bias"]
            if np.allclose(upd_w, ours_old[i]["w"]):
                raise AssertionError(
                    f"{key} layer {i}: PyTorch original weight == updated "
                    "(trivial pass guard, validation.jl:97)")
            if np.allclose(upd_b, ours_old[i]["b"]):
                raise AssertionError(
                    f"{key} layer {i}: PyTorch original bias == updated "
                    "(trivial pass guard, validation.jl:97)")
            _check(f"{key}.{i}.weight", ours_new[i]["w"], upd_w, atol, rtol,
                   report)
            _check(f"{key}.{i}.bias", ours_new[i]["b"], upd_b, atol, rtol,
                   report)

    # --- embeddings (validation.jl:125-146) ---
    for t in range(config.num_tables):
        upd = ref[f"update_emb_{t}"]
        ours = model_lib.get_table(new_params, config, t)
        orig = model_lib.get_table(original, config, t)
        if np.allclose(upd, orig):
            raise AssertionError(
                f"table {t}: PyTorch original == updated (trivial pass)")
        _check(f"emb_{t}", ours, upd, atol, rtol, report)

    return report
