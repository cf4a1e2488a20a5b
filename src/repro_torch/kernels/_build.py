"""Build and load the package's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source into a shared library with a plain C
interface, which is loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  Libraries land in ``build/repro_torch/`` at the root of
the checkout, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and
an unchanged one loads the library already there.  Beside each library
lies ptxas's report of its kernels' registers and spills
(:func:`build_log`).  Nothing is built at import time:
:func:`load_library` runs on a kernel's first launch.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .. import trace

__all__ = [
    "MAX_SMEM", "NVCC_FLAGS", "build_dir", "build_log", "check_cuda", "flags", "launch",
    "load_library",
]

_CSRC = Path(__file__).resolve().parent / "csrc"

# sm_90a: Hopper with its architecture-specific features; ptxas reports each
# kernel's registers and spills.  No source builds with fast-math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)
# -fmad=false keeps the placement sweeps' float64 chains exact against the
# plain engine; the ML kernels fuse their multiply-adds.
_SOURCE_FLAGS = {
    "placement_sweep": ("-fmad=false",),
    "placement_sweep_batch": ("-fmad=false",),
}

MAX_SMEM = 232_448  # bytes of shared memory one H100 block may use

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    """``build/repro_torch`` under the checkout root (``.gitignore`` lists it)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from source on first use and need the CUDA toolkit"
    )


def flags(name: str) -> tuple[str, ...]:
    """nvcc's flags for ``csrc/<name>.cu``."""
    return (*NVCC_FLAGS, *_SOURCE_FLAGS.get(name, ()))


def _digest(src: Path, headers: list[Path], flag_list: tuple[str, ...]) -> str:
    """Hash of what a library is built from: the source, every shared
    header (a source may include any of them, in a fixed order) and the
    flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in headers:
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flag_list).encode())
    return h.hexdigest()


def _library(name: str) -> Path:
    src = _CSRC / f"{name}.cu"
    digest = _digest(src, sorted(_CSRC.glob("*.cuh")), flags(name))
    return build_dir() / f"lib{name}_{digest[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas's register and spill report) from building
    ``csrc/<name>.cu``; empty before the build."""
    log = _library(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _build(name: str) -> Path:
    out = _library(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags(name), "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    # which kernel this process built from source, not found in the cache
    trace.count(f"kernels.builds.{name}")
    trace.count("kernels.build_s", time.perf_counter() - t0)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}.cu:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            _LIBS[name] = lib
        return lib


def launch(name: str, symbol: str, argtypes: list, args: tuple, device: torch.device) -> None:
    """Call ``csrc/<name>.cu``'s C launcher ``symbol`` on the current stream
    of ``device``, passing the stream as its last argument; raise on the
    ``cudaGetLastError`` code it returns (its ``<name>_error_string`` names
    it).  Every wrapper of the package launches through here."""
    lib = load_library(name)
    fn = getattr(lib, symbol)
    err_string = getattr(lib, f"{name}_error_string")
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err_string.argtypes = [ctypes.c_int]
        err_string.restype = ctypes.c_char_p
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: {err_string(err).decode()} ({err})")


def check_no_grad(kernel: str, **named: torch.Tensor) -> None:
    """Raise when grad mode is on and a named tensor requires grad: the
    kernels have no backward, and an output without a ``grad_fn`` would
    leave everything upstream of it silently untrained."""
    needy = [name for name, t in named.items() if t.requires_grad]
    if needy and torch.is_grad_enabled():
        raise RuntimeError(
            f"{kernel} has no backward, and {', '.join(needy)} require grad: train on the "
            f'differentiable route, ExecConfig(attn_impl="xla"), or call the kernel under '
            f"torch.no_grad()")


def check_cuda(smem: int, **named: torch.Tensor) -> None:
    """Raise unless every named tensor is a contiguous CUDA tensor and a
    block's ``smem`` bytes of shared memory fit the card."""
    for name, t in named.items():
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernels need CUDA tensors, got {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if smem > MAX_SMEM:
        raise ValueError(f"a block needs {smem} bytes of shared memory (> {MAX_SMEM})")
