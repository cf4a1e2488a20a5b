"""Model zoo of the port: the dense GQA transformer (smollm-135m) and
Mamba-2 SSD (mamba2-130m) families, layer-stacked parameters under the
JAX package's names, run by Python loops over layers.  The other families
are not ported yet (ROADMAP queue 1, item 8)."""

from .model import ExecConfig, Model
from .params import ParamSpec, init_params, map_specs, param_count

__all__ = ["ExecConfig", "Model", "ParamSpec", "init_params", "map_specs", "param_count"]
