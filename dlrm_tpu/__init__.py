"""dlrm_tpu — a DLRM training framework in JAX (XLA, Pallas, shard_map).

Brand-new implementation with the capabilities of darchr/DLRM.jl (reference
mounted at /root/reference; structural map in SURVEY.md): end-to-end DLRM
CTR training on Criteo, validated against the reference's PyTorch HDF5
fixtures, with sharded embedding tables, compressed sparse gradients, and a
single jitted train step, running on NVIDIA GPUs.
"""

from dlrm_tpu.config import (
    DLRMConfig,
    KAGGLE_TABLE_SIZES,
    TERABYTE_TABLE_SIZES,
    fixture_config,
    kaggle_config,
    multi_fixture_config,
    terabyte_config,
    tiny_config,
)
from dlrm_tpu.models.dlrm import forward, init_params
from dlrm_tpu.ops.loss import bce_loss
from dlrm_tpu.ops.quant import quantize_params  # int8 serving
from dlrm_tpu.train.train import (train, train_step, make_jit_train_step,
                                  init_opt_state, make_jit_train_step_opt)

__all__ = [
    "DLRMConfig", "KAGGLE_TABLE_SIZES", "TERABYTE_TABLE_SIZES",
    "fixture_config", "kaggle_config", "multi_fixture_config",
    "terabyte_config", "tiny_config", "forward", "init_params", "bce_loss",
    "train", "train_step", "make_jit_train_step",
    "init_opt_state", "make_jit_train_step_opt", "quantize_params",
]

__version__ = "0.1.0"
