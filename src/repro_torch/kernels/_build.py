"""Build and load the package's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source into a shared library with a plain C
interface, which is loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  Libraries land in ``build/repro_torch/`` at the root of
the checkout, named by a hash of the source and flags, so an edited source
rebuilds and an unchanged one loads the library already there.  Nothing is
built at import time: :func:`load_library` runs on a kernel's first launch.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["MAX_SMEM", "NVCC_FLAGS", "build_dir", "check_cuda", "launch", "load_library"]

_CSRC = Path(__file__).resolve().parent / "csrc"

# sm_90a: Hopper with its architecture-specific features.  -fmad=false and
# no fast-math keep the placement sweep's float64 chain exact.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

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


def _build(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = build_dir() / f"lib{src.stem}_{digest[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src.name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(_CSRC / f"{name}.cu")))
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
