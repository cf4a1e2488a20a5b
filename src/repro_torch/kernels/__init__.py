"""Hand-written CUDA kernels of the port, each beside its plain torch version.

``ops`` dispatches on the tensors' device (CPU: plain version, CUDA: the
kernel): ``placement_sweep`` / ``placement_sweep_batch`` (the Alg-2
sweeps), ``flash_attention`` (the prefill's flash kernel; at one query
position the decode kernel, ``decode_attention``), ``mla_decode`` (latent
attention's decode), ``rotary`` (RoPE or M-RoPE of a layer's q and k),
``ssd_scan`` and ``rglru_scan`` (the serving path's prefill).  ``ref`` holds the ML
kernels' plain oracles; ``_build`` compiles ``csrc/*.cu`` with ``nvcc``
on first launch; ``counts`` reads and moves the wrappers' launch counts
together (a captured step's replays add to them).
"""

from . import ref

__all__ = ["ref"]
