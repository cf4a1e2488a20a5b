"""The weights a cell serves, drawn on the card from ``--seed``.

One ``torch.Generator`` on the device, one ``randn`` a leaf (a layer stack
at once), in the type the model is served in, then scaled in place: a few
large calls, nothing made on the host. The same tensors go to the program
(``Model(params=)``, which keeps them without a copy) and to the reference.
"""

from __future__ import annotations

import torch

from common import WEIGHTS, sub_seed


def draw(shapes: dict, seed: int, device, dtype: torch.dtype) -> dict:
    """A tree of tensors for ``shapes``' (shape, std) leaves, in sorted key
    order from one generator seeded by ``seed``'s weight stream."""
    gen = torch.Generator(device).manual_seed(sub_seed(seed, WEIGHTS))

    def leaf(shape: tuple, std: float) -> torch.Tensor:
        t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return t.mul_(std)

    def walk(node: dict) -> dict:
        return {k: walk(node[k]) if isinstance(node[k], dict) else leaf(*node[k])
                for k in sorted(node)}

    return walk(shapes)
