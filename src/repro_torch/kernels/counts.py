"""The kernels' launch counts, read, set and added to together, and the
launches that kernel names stand for.

Each CUDA wrapper adds one to its count where it launches its kernel
(``flash_attention_cuda.launches`` and ``.mma_launches``,
``decode_attention_cuda.launches``, ``mla_decode_cuda.launches``,
``ssd_scan_cuda.launches`` and ``.mma_launches``,
``rglru_scan_cuda.launches``, ``rotary_cuda.launches``, the two sweeps'
``launches``), and nowhere else.  A CUDA graph that replays a captured
step launches its kernels with no wrapper running, so the counts do not
see a replay: the serving engine
(``serve.graphs.CudaGraphStep``) takes back what a capture added (a
capture launches nothing, through ``add``) and keeps its own tally of its
replays.  ``seen`` reads the launches that kernel names stand for: a
captured graph's kernel nodes (what each replay launches) or a profiler's
device events.  ``chip_smoke.py`` reads the counts around each
main-path run through ``reset`` and ``read``.
"""

from __future__ import annotations

import re
from typing import Iterable

from .decode_attention import decode_attention_cuda
from .flash_attention import flash_attention_cuda
from .mla_decode import mla_decode_cuda
from .placement_step import placement_sweep_batch_cuda, placement_sweep_cuda
from .rglru_scan import rglru_scan_cuda
from .rotary import rotary_cuda
from .ssd_scan import ssd_scan_cuda

__all__ = ["read", "reset", "add", "delta", "total", "seen", "prefill_launches",
           "decode_launches"]

# name -> (wrapper, attribute); "<kernel>_mma" counts the launches of the
# tensor-core kernel, a part of "<kernel>"'s
_COUNTERS = {
    "placement_sweep": (placement_sweep_cuda, "launches"),
    "placement_sweep_batch": (placement_sweep_batch_cuda, "launches"),
    "flash_attention": (flash_attention_cuda, "launches"),
    "flash_attention_mma": (flash_attention_cuda, "mma_launches"),
    "decode_attention": (decode_attention_cuda, "launches"),
    "mla_decode": (mla_decode_cuda, "launches"),
    "ssd_scan": (ssd_scan_cuda, "launches"),
    "ssd_scan_mma": (ssd_scan_cuda, "mma_launches"),
    "rglru_scan": (rglru_scan_cuda, "launches"),
    "rotary": (rotary_cuda, "launches"),
}


def _rotary_layers(cfg) -> int:
    """Layers whose self-attention rotates q and k: every attention layer
    of a model with RoPE or M-RoPE (the hybrid's local attention always;
    an enc-dec's decoder, whose cross-attention does not)."""
    if cfg.family in ("hybrid", "ssm"):
        return cfg.layer_kinds().count("attn")
    rotates = cfg.rope == "rope" if cfg.family == "encdec" else cfg.rope != "none"
    return cfg.n_layers if rotates else 0


def prefill_launches(cfg) -> dict[str, int]:
    """A prefill's launches of a model of config ``cfg``: one a layer by
    the layer's kind (flash attention, SSD scan, RG-LRU scan), the rotary
    kernel one a layer that rotates; an enc-dec model's flash attention
    and rotary also one an encoder layer, and its flash attention two a
    decoder layer (self- and cross-attention)."""
    kinds = cfg.layer_kinds()
    want = {"flash_attention": kinds.count("attn"), "ssd_scan": kinds.count("ssm"),
            "rglru_scan": kinds.count("rec"), "rotary": _rotary_layers(cfg)}
    if cfg.family == "encdec":
        want["flash_attention"] += cfg.enc_layers + cfg.n_layers
        want["rotary"] += cfg.enc_layers if want["rotary"] else 0
    return {k: n for k, n in want.items() if n}


def decode_launches(cfg, steps: int) -> dict[str, int]:
    """``steps`` decode steps' launches of a model of config ``cfg``: one
    decode attention a layer with a KV cache, two an enc-dec decoder layer
    (self- and cross-attention), one latent decode a layer under latent
    attention (the ssm and hybrid families decode without one); the rotary
    kernel one a layer that rotates."""
    n = {"dense": cfg.n_layers, "moe": cfg.n_layers, "vlm": cfg.n_layers,
         "encdec": 2 * cfg.n_layers}.get(cfg.family, 0)
    name = "mla_decode" if getattr(cfg, "mla", False) else "decode_attention"
    out = {name: n * steps, "rotary": _rotary_layers(cfg) * steps}
    return {k: v for k, v in out.items() if v}


def read() -> dict[str, int]:
    """Every count, by name."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTERS.items()}


def reset() -> None:
    """Set every count to 0."""
    for fn, attr in _COUNTERS.values():
        setattr(fn, attr, 0)


def add(counts: dict[str, int]) -> None:
    """Add ``counts`` (by name; negative to take back) to the counts."""
    for name, n in counts.items():
        fn, attr = _COUNTERS[name]
        setattr(fn, attr, getattr(fn, attr) + n)


def delta(after: dict[str, int], before: dict[str, int]) -> dict[str, int]:
    """The counts that moved from ``before`` to ``after`` (``read()``s),
    those that did not left out."""
    return {name: after[name] - before[name] for name in after if after[name] != before[name]}


# name -> the kernel symbols one launch of the wrapper runs one of, as a
# profiler names them (the bf16 SSD scan runs four passes; its output pass,
# which every call runs once, stands for the call; decode attention's and
# latent decode's split kernels stand for a call, whose merge kernel runs
# when it has two splits or more)
_SYMBOLS = {
    "placement_sweep": ("placement_sweep_kernel",),
    "placement_sweep_batch": ("placement_sweep_batch_kernel",),
    "flash_attention": ("flash_attention_kernel", "flash_attention_kernel_mma"),
    "flash_attention_mma": ("flash_attention_kernel_mma",),
    "decode_attention": ("decode_attention_kernel",),
    "mla_decode": ("mla_decode_kernel", "mla_decode_mma_kernel"),
    "ssd_scan": ("ssd_scan_kernel", "ssd_out_kernel"),
    "ssd_scan_mma": ("ssd_out_kernel",),
    "rglru_scan": ("rglru_chunk_scan_kernel",),
    "rotary": ("rotary_kernel",),
}


def total(*launches: dict[str, int]) -> dict[str, int]:
    """Launch counts by name summed over ``launches`` (a prefill's and its
    decode steps', say: both run the rotary kernel)."""
    out: dict[str, int] = {}
    for part in launches:
        for name, n in part.items():
            out[name] = out.get(name, 0) + n
    return out


def seen(kernel_names: Iterable[str]) -> dict[str, int]:
    """The wrappers' launches that the device kernels ``kernel_names`` (one
    name an executed kernel, demangled as ``torch.profiler`` names its device
    events, e.g. ``void flash_attention_kernel_mma<64>(...)``, or mangled as
    a CUDA graph's kernel nodes name theirs, e.g.
    ``_ZN12_GLOBAL__N_126flash_attention_kernel_mmaILi64EEvPK...``) stand
    for, by the names ``read`` uses; those with none left out."""
    names = list(kernel_names)
    out = {}
    for name, symbols in _SYMBOLS.items():
        # a mangled name spells an identifier as its length, then its
        # letters: the length tells flash_attention_kernel from
        # flash_attention_kernel_mma where no word boundary does
        pattern = re.compile("|".join([rf"\b{s}\b" for s in symbols]
                                      + [f"{len(s)}{s}" for s in symbols]))
        n = sum(1 for k in names if pattern.search(k))
        if n:
            out[name] = n
    return out
