"""The kernels' launch counts, read, set and added to together, and the
launches that kernel names stand for.

Each CUDA wrapper adds one to its count where it launches its kernel
(``flash_attention_cuda.launches``, say, and ``.mma_launches``), and
nowhere else, and declares beside the counts its ``counters``: each
count's name here -> (its attribute, the kernel symbols one counted launch
runs one of, as a profiler names them).  A CUDA graph that replays a
captured step launches its kernels with no wrapper running, so the counts
do not see a replay: ``graphs.CudaGraphStep`` takes back what a capture
added (a capture launches nothing, through ``add``) and keeps its own
tally of its replays.  ``seen`` reads the launches that kernel names
stand for: a captured graph's kernel nodes (what each replay launches) or
a profiler's device events.  ``chip_smoke.py`` reads the counts around
each main-path run through ``reset`` and ``read``.
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

__all__ = ["read", "reset", "add", "delta", "total", "seen"]

# the wrappers that count their launches; a new kernel's goes here
_WRAPPERS = (placement_sweep_cuda, placement_sweep_batch_cuda, flash_attention_cuda,
             decode_attention_cuda, mla_decode_cuda, ssd_scan_cuda, rglru_scan_cuda, rotary_cuda)
_COUNTERS = {name: (fn, attr) for fn in _WRAPPERS for name, (attr, _) in fn.counters.items()}
_SYMBOLS = {name: symbols for fn in _WRAPPERS for name, (_, symbols) in fn.counters.items()}


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
