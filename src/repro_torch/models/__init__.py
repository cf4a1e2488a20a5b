"""Model zoo of the port, every assigned family: the GQA transformer, dense
(smollm-135m, yi-34b, ...), MoE (moonshot-v1-16b-a3b, dbrx-132b) and VLM
with M-RoPE (qwen2-vl-2b); Mamba-2 SSD (mamba2-130m); the Griffin hybrid
(recurrentgemma-2b); and the encoder-decoder (seamless-m4t-large-v2).
Layer-stacked parameters under the JAX package's names, run by Python
loops over layers, with logical-axis parameter specs consumed by
``repro_torch.sharding``."""

from .model import (
    ExecConfig,
    Model,
    cross_entropy,
    decode_input_specs,
    prefill_batch_specs,
    train_batch_specs,
)
from .params import (
    ParamSpec,
    abstract_params,
    init_params,
    logical_axes,
    map_specs,
    param_bytes,
    param_count,
)

__all__ = [
    "ExecConfig",
    "Model",
    "cross_entropy",
    "decode_input_specs",
    "prefill_batch_specs",
    "train_batch_specs",
    "ParamSpec",
    "abstract_params",
    "init_params",
    "logical_axes",
    "map_specs",
    "param_bytes",
    "param_count",
]
