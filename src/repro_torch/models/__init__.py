"""Model zoo of the port, every assigned family: the GQA transformer, dense
(smollm-135m, yi-34b, ...), MoE (moonshot-v1-16b-a3b, dbrx-132b) and VLM
with M-RoPE (qwen2-vl-2b); Mamba-2 SSD (mamba2-130m); the Griffin hybrid
(recurrentgemma-2b); and the encoder-decoder (seamless-m4t-large-v2).
Layer-stacked parameters under the JAX package's names, run by Python
loops over layers."""

from .model import ExecConfig, Model, cross_entropy
from .params import ParamSpec, init_params, logical_axes, map_specs, param_count

__all__ = ["ExecConfig", "Model", "cross_entropy", "ParamSpec", "init_params", "logical_axes",
           "map_specs", "param_count"]
