"""Model facade over every assigned architecture family.

``Model`` is an ``nn.Module`` holding the stacked parameter tree under the
JAX package's names (``embed``, ``blocks.attn.wq``, ``super.0.log_lambda``,
...), and exposes the serving entry points:

* ``forward``      — full-sequence logits (prefill without cache)
* ``prefill``      — full sequence -> (last_logits, decode state)
* ``decode_step``  — one token + state -> (logits, state)
* ``init_state``   — the zero decode state

and training's, which take the parameter tree as an argument, as the JAX
package's do (a model built with ``params={}`` holds no weights of its own:
training's weights are the train state's):

* ``loss``         — ``(params, batch) -> (loss, {"ce", "aux"})``, with grad
* ``init``         — a float32 parameter tree drawn from a generator
* ``param_axes``   — the logical-axes tree

and the dry-run's abstract builders, meta tensors of the JAX package's
shapes and dtypes that allocate nothing: ``Model.abstract_params`` /
``abstract_state`` and ``train_batch_specs`` / ``prefill_batch_specs`` /
``decode_input_specs``.

It dispatches on ``cfg.family``: ``dense``, ``moe`` and ``vlm`` to
``transformer``, ``ssm`` to ``ssm``, ``hybrid`` to ``rglru``, ``encdec`` to
``encdec``.  The parameters live on ``device``, ``"cuda"`` unless the
caller asks for another: building a model without ``device=`` on a host
with no card raises.
"""

from __future__ import annotations

import operator
from typing import Any

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..configs.shapes import InputShape
from ..sharding.ctx import gather_for_use, logsumexp, take_last
from . import encdec, rglru, ssm, transformer
from .params import abstract_params, init_params, logical_axes, param_count
from .transformer import ExecConfig

__all__ = [
    "Model",
    "ExecConfig",
    "cross_entropy",
    "resolve_device",
    "train_batch_specs",
    "prefill_batch_specs",
    "decode_input_specs",
    "VLM_PATCHES",
]

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
VLM_PATCHES = 256  # vision-frontend stub: fixed patch-embedding prefix


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device on a host without one
    raises rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} asked for, but no CUDA device is present; pass device='cpu' "
            "to run the plain torch path on the CPU"
        )
    return dev


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE at float32.  logits: (B, S, V); labels: (B, S)
    (already aligned)."""
    lf = logits.float()
    # on vocab-sharded DTensor logits the max and the sum reduce across
    # devices, where torch.logsumexp would gather the rows whole
    lse = logsumexp(lf)
    ll = take_last(lf, labels.long())  # (B, S, 1)
    return torch.mean(lse[..., None] - ll)


class _Tree(nn.Module):
    """A nested parameter dict as a module tree: leaves are (frozen)
    parameters, sub-dicts are submodules, names as in the dict."""

    def __init__(self, tree: dict) -> None:
        super().__init__()
        for name, node in tree.items():
            if isinstance(node, dict):
                self.add_module(name, _Tree(node))
            else:
                self.register_parameter(name, nn.Parameter(node, requires_grad=False))

    def as_dict(self) -> dict:
        out: dict[str, Any] = dict(self._parameters)
        out.update({name: mod.as_dict() for name, mod in self._modules.items()})
        return out


class Model(nn.Module):
    """A ported model.  ``params``: a tree of tensors with the spec tree's
    names and shapes (``convert.params_from`` builds one from the JAX
    package's), or ``{}`` for a model that holds none (training's, run
    through ``loss``); without it the parameters are drawn by
    ``init_params`` from ``generator`` (a fresh one seeded 0 on ``device``
    if none is given).  ``dtype`` overrides the stored type of every
    parameter (the JAX package stores float32 and casts at use)."""

    def __init__(
        self,
        cfg: ModelConfig,
        ex: ExecConfig | None = None,
        *,
        params: dict | None = None,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        self.cfg = cfg
        self.ex = ex or ExecConfig()
        self.device = resolve_device(device)
        if params is None:
            gen = generator or torch.Generator(self.device).manual_seed(0)
            params = init_params(self.specs(), gen, self.device, dtype)
        else:
            params = _to(params, self.device, dtype)
        self.tree = _Tree(params)

    # ---- parameters -----------------------------------------------------
    def specs(self) -> dict:
        if self.cfg.family == "ssm":
            return ssm.ssm_specs(self.cfg)
        if self.cfg.family == "hybrid":
            return rglru.hybrid_specs(self.cfg)
        if self.cfg.family == "encdec":
            return encdec.encdec_specs(self.cfg)
        return transformer.lm_specs(self.cfg)

    @property
    def params(self) -> dict:
        """The parameter tree as nested dicts (the tensors themselves)."""
        return self.tree.as_dict()

    def n_params(self) -> int:
        return param_count(self.specs())

    def abstract_params(self, dtype: str | None = None) -> dict:
        """The parameter tree as meta tensors, of the specs' stored dtypes
        or all of ``dtype`` (a name, e.g. "bfloat16")."""
        tree = abstract_params(self.specs())
        if dtype is None:
            return tree
        dt = getattr(torch, dtype)
        return _map(lambda t: torch.empty(t.shape, dtype=dt, device="meta"), tree)

    def init(self, generator: torch.Generator) -> dict:
        """A float32 parameter tree on the model's device, drawn from
        ``generator`` (which lives there) by ``init_params``."""
        return init_params(self.specs(), generator, self.device)

    def param_axes(self) -> dict:
        return logical_axes(self.specs())

    # ---- training / full forward ----------------------------------------
    def _full(self, params: dict, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """(logits, aux) of the full sequence."""
        cfg, ex = self.cfg, self.ex
        params = _for_use(params)
        if cfg.family == "ssm":
            return ssm.ssm_forward(cfg, ex, params, batch)
        if cfg.family == "hybrid":
            return rglru.hybrid_forward(cfg, ex, params, batch)
        if cfg.family == "encdec":
            return encdec.encdec_forward(cfg, ex, params, batch)
        return transformer.lm_forward(cfg, ex, params, batch)

    def loss(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Next-token CE of ``logits[:, :-1]`` against ``labels[:, 1:]`` plus
        ``moe_aux_coef`` x the MoE load-balance loss; returns (loss, {"ce",
        "aux"}).  Runs with grad (the caller's mode): on ``attn_impl="xla"``
        every op is differentiable.  Latent attention has no training path
        (it serves alone): it raises."""
        if getattr(self.cfg, "mla", False):
            raise NotImplementedError(f"{self.cfg.name}: latent attention serves alone; "
                                      "training it is out of this port's scope")
        logits, aux = self._full(params, batch)
        ce = cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
        return ce + self.ex.moe_aux_coef * aux, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def forward(self, batch: dict) -> torch.Tensor:
        return self._full(self.params, batch)[0]

    # ---- serving --------------------------------------------------------
    @torch.no_grad()
    def prefill(self, batch: dict):
        """Returns (last_token_logits, decode_state)."""
        params = _for_use(self.params)
        if self.cfg.family == "ssm":
            logits, _, state = ssm.ssm_forward(
                self.cfg, self.ex, params, batch, return_state=True
            )
        elif self.cfg.family == "hybrid":
            logits, _, state = rglru.hybrid_forward(
                self.cfg, self.ex, params, batch, return_state=True
            )
        elif self.cfg.family == "encdec":
            logits, _, state = encdec.encdec_forward(
                self.cfg, self.ex, params, batch, return_cache=True
            )
        else:
            logits, _, state = transformer.lm_forward(
                self.cfg, self.ex, params, batch, return_cache=True
            )
        return logits[:, -1].clone(), state  # a copy: the (B, S, V) logits are freed

    @torch.no_grad()
    def decode_step(self, state, tokens: torch.Tensor, idx: int | torch.Tensor):
        """One token a row at cache position ``idx``; returns (logits,
        state).  The state is updated in place and returned.  ``idx`` is an
        int or a 0-d integer tensor on the model's device, as the JAX
        package's decode takes a traced int32: a tensor is read on the
        device alone (no host sync), so one captured step serves every
        position.  Either gives the same logits and state bit for bit."""
        params = _for_use(self.params)
        if not isinstance(idx, torch.Tensor):
            idx = operator.index(idx)  # numpy ints too
        if self.cfg.family == "ssm":
            return ssm.ssm_decode_step(self.cfg, self.ex, params, state, tokens, idx)
        if self.cfg.family == "hybrid":
            return rglru.hybrid_decode_step(self.cfg, self.ex, params, state, tokens, idx)
        if self.cfg.family == "encdec":
            return encdec.encdec_decode_step(self.cfg, self.ex, params, state, tokens, idx)
        return transformer.lm_decode_step(self.cfg, self.ex, params, state, tokens, idx)

    def init_state(self, batch_size: int, max_len: int, enc_len: int | None = None):
        """The zero decode state; an enc-dec model's cross cache holds
        ``enc_len`` encoder positions (``max_len`` if not given)."""
        return _init_state(self.cfg, batch_size, max_len, enc_len, self.device)

    def abstract_state(self, batch_size: int, max_len: int, enc_len: int | None = None):
        """``init_state``'s tree as meta tensors."""
        return _init_state(self.cfg, batch_size, max_len, enc_len, torch.device("meta"))


def _for_use(params: dict) -> dict:
    """The top-level weights (embedding, head, final norms) as the model
    uses them (``gather_for_use``: FSDP shards gathered under
    ``activation_sharding``, the identity otherwise); the layer stacks are
    gathered a layer at a time by ``transformer._layer``."""
    return {k: v if isinstance(v, dict) else gather_for_use(v) for k, v in params.items()}


def _init_state(cfg: ModelConfig, batch_size: int, max_len: int, enc_len: int | None, device):
    if cfg.family == "ssm":
        return ssm.init_ssm_state(cfg, batch_size, device=device)
    if cfg.family == "hybrid":  # fixed-size: max_len is not used
        return rglru.init_hybrid_state(cfg, batch_size, device=device)
    if cfg.family == "encdec":
        return encdec.init_encdec_cache(cfg, batch_size, max_len, enc_len or max_len,
                                        device=device)
    return transformer.init_cache(cfg, batch_size, max_len, device=device)


def _map(fn, tree: dict) -> dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _to(tree: dict, device: torch.device, dtype: torch.dtype | None) -> dict:
    return {
        k: _to(v, device, dtype) if isinstance(v, dict) else v.to(device=device, dtype=dtype)
        for k, v in tree.items()
    }


# ---------------------------------------------------------------------------
# Abstract input builders (meta tensors: no allocation)
# ---------------------------------------------------------------------------


def _meta(shape, dtype: str) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=getattr(torch, dtype), device="meta")


def train_batch_specs(cfg: ModelConfig, shape: InputShape) -> dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    emb_dt = cfg.dtype
    if cfg.family == "encdec":
        return {
            "enc_embeds": _meta((B, S, cfg.d_model), emb_dt),
            "tokens": _meta((B, S), "int32"),
            "labels": _meta((B, S), "int32"),
        }
    if cfg.family == "vlm":
        P = VLM_PATCHES
        return {
            "tokens": _meta((B, S - P), "int32"),
            "patch_embeds": _meta((B, P, cfg.d_model), emb_dt),
            "positions": _meta((B, S, 3), "int32"),
            "labels": _meta((B, S), "int32"),
        }
    return {
        "tokens": _meta((B, S), "int32"),
        "labels": _meta((B, S), "int32"),
    }


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape) -> dict[str, Any]:
    specs = train_batch_specs(cfg, shape)
    specs.pop("labels")
    return specs


def decode_input_specs(cfg: ModelConfig, shape: InputShape) -> dict[str, Any]:
    """Inputs for one serve_step: new token ids + fill index + state."""
    B, T = shape.global_batch, shape.seq_len
    return {
        "tokens": _meta((B,), "int32"),
        "idx": _meta((), "int32"),
        "state": _init_state(cfg, B, T, min(T, 4096), torch.device("meta")),
    }
