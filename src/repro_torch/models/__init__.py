"""Model zoo of the port: the dense GQA transformer (smollm-135m), Mamba-2
SSD (mamba2-130m) and Griffin hybrid (recurrentgemma-2b) families,
layer-stacked parameters under the JAX package's names, run by Python
loops over layers.  The other families are not ported yet (ROADMAP queue
1, item 8)."""

from .model import ExecConfig, Model
from .params import ParamSpec, init_params, map_specs, param_count

__all__ = ["ExecConfig", "Model", "ParamSpec", "init_params", "map_specs", "param_count"]
