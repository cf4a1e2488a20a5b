"""Fault-tolerant checkpointing, in the JAX package's layout.

Layout:  <dir>/step_<N>/
            manifest.json      — one entry a leaf (file, shape, dtype) and meta
            arr_<i>.npy        — one file a leaf
         <dir>/LATEST          — atomic pointer (write tmp + rename)

Leaves are numbered in ``jax.tree``'s order (``repro_torch._tree``): dict
keys sorted, dataclass fields in declaration order, ``None`` no leaf; a
bfloat16 leaf is stored as its uint16 bits under the dtype string
``"bfloat16"``.  So a checkpoint written by either package restores in
the other, leaf for leaf and bit for bit.

Guarantees:
* Atomic publication — a crash mid-save never corrupts LATEST; a resume
  sees the last fully-written step.
* Async save — leaves are snapshotted to host RAM synchronously (a
  device-to-host copy), written by a background thread; training continues
  immediately.  A failed write raises on the next ``wait()`` or ``save()``.
* Retention — keep the newest K checkpoints, and every step that is a
  multiple of ``keep_every`` if set.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from .._tree import leaves, unflatten

__all__ = ["save_pytree", "load_pytree", "CheckpointManager"]

_MANIFEST = "manifest.json"
_LATEST = "LATEST"


def _host(leaf: Any) -> tuple[np.ndarray, str]:
    """(numpy array to write, dtype string): a tensor is copied to the
    host; bfloat16, which numpy lacks, travels as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _snapshot(leaf: Any) -> Any:
    """A host copy of one leaf that later device work cannot change."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def save_pytree(path: str, tree: Any, *, meta: dict | None = None) -> None:
    """Synchronous atomic save of a tree of tensors or arrays."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    entries = []
    for i, leaf in enumerate(leaves(tree)):
        arr, dtype = _host(leaf)
        fname = f"arr_{i}.npy"
        np.save(os.path.join(tmp, fname), arr)
        entries.append({"file": fname, "shape": list(arr.shape), "dtype": dtype})
    # Tree structure is NOT serialised: restore always goes through a
    # `like` tree (the live TrainState), which is both simpler and safe
    # across code refactors that keep leaf order.
    manifest = {"entries": entries, "meta": meta or {}}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def load_pytree(path: str, like: Any) -> tuple[Any, dict]:
    """Load into the structure of ``like``; the leaves come back as CPU
    tensors in their stored types (the caller places them)."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    n_like = len(leaves(like))
    entries = manifest["entries"]
    if len(entries) != n_like:
        raise ValueError(f"checkpoint {path} has {len(entries)} leaves, expected {n_like}")
    out = []
    for e in entries:
        arr = np.load(os.path.join(path, e["file"]))
        if e["dtype"] == "bfloat16":
            out.append(torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16))
        else:
            out.append(torch.from_numpy(arr))
    return unflatten(like, out), manifest["meta"]


@dataclasses.dataclass
class CheckpointManager:
    """Directory-of-steps manager with async save + retention."""

    directory: str
    keep: int = 3
    keep_every: int = 0  # additionally keep step % keep_every == 0

    def __post_init__(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: list[BaseException] = []

    # ---- paths ----
    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        out = []
        for name in sorted(os.listdir(self.directory)):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        """Resolve LATEST; fall back to directory scan (torn pointer)."""
        p = os.path.join(self.directory, _LATEST)
        if os.path.exists(p):
            try:
                with open(p) as f:
                    step = int(f.read().strip())
                if os.path.exists(os.path.join(self.step_dir(step), _MANIFEST)):
                    return step
            except (ValueError, OSError):
                pass
        steps = [s for s in self.all_steps()
                 if os.path.exists(os.path.join(self.step_dir(s), _MANIFEST))]
        return steps[-1] if steps else None

    # ---- save ----
    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise self._error.pop()

    def save(self, step: int, tree: Any, *, meta: dict | None = None, sync: bool = False) -> None:
        self.wait()  # one in-flight save at a time
        # snapshot to host RAM now (leaf order is all a checkpoint keeps);
        # write in background
        host = [_snapshot(x) for x in leaves(tree)]
        meta = dict(meta or {}, step=step)

        def work():
            try:
                save_pytree(self.step_dir(step), host, meta=meta)
                tmp = os.path.join(self.directory, _LATEST + ".tmp")
                with open(tmp, "w") as f:
                    f.write(str(step))
                os.replace(tmp, os.path.join(self.directory, _LATEST))
                self._gc()
            except Exception as e:  # surfaced on the next wait() or save()
                self._error.append(e)

        if sync:
            work()
            if self._error:
                raise self._error.pop()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def _gc(self) -> None:
        steps = self.all_steps()
        keepers = set(steps[-self.keep :]) if self.keep > 0 else set(steps)
        if self.keep_every:
            keepers |= {s for s in steps if s % self.keep_every == 0}
        for s in steps:
            if s not in keepers:
                shutil.rmtree(self.step_dir(s), ignore_errors=True)

    # ---- restore ----
    def restore(self, like: Any, step: int | None = None) -> tuple[Any, dict] | None:
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return load_pytree(self.step_dir(step), like)
