"""The one generator of serving traffic: it reads a mix's parameters
(``traffic/<name>.json``) and makes each call's batch from ``--seed``.

A mix is a closed loop of ``generate`` calls: each call serves ``batch``
requests of one prompt (an optional ``image_grid`` of h x w merged patch
embeddings, then ``text_tokens`` token ids) and ``new_tokens`` greedy
tokens. Call i's batch comes from its own stream of the seed, so the same
seed gives the same calls and a check can make a call's batch again.
Token ids are drawn on the host; patch embeddings on the card, in the
model's type, from a seed drawn beside the ids (they are large).

Positions follow Qwen2-VL's rule for an image before the text: patch
(r, c) at (t, h, w) = (0, r, c), text token i at max(h, w) + i in all three
streams. A text-only prompt takes 0..S-1 (the program's default).
"""

from __future__ import annotations

import numpy as np
import torch

from common import BATCH, WARM, sub_seed


class Traffic:
    def __init__(self, spec: dict, as_run: dict, seed: int, device, dtype: torch.dtype) -> None:
        self.batch_size = int(spec["batch"])
        self.text = int(spec["text_tokens"])
        self.new = int(spec["new_tokens"])
        grid = spec.get("image_grid")
        self.grid = tuple(grid) if grid else None
        self.images = self.grid[0] * self.grid[1] if self.grid else 0
        self.prompt = self.images + self.text
        self.max_len = self.prompt + self.new
        self.vocab, self.d_model = as_run["vocab"], as_run["d_model"]
        self.seed, self.device, self.dtype = seed, device, dtype
        self.positions = None
        if self.grid:
            self.positions = torch.from_numpy(self.prompt_positions()).to(device)

    def prompt_positions(self) -> np.ndarray:
        """(B, prompt, 3) int32 (t, h, w) ids of the image then the text."""
        h, w = self.grid
        r, c = np.divmod(np.arange(h * w), w)
        patches = np.stack([np.zeros_like(r), r, c], axis=-1)
        text = np.repeat((max(h, w) + np.arange(self.text))[:, None], 3, axis=1)
        one = np.concatenate([patches, text]).astype(np.int32)
        return np.ascontiguousarray(np.broadcast_to(one, (self.batch_size, *one.shape)))

    def batch(self, call: int, *, warm: bool = False) -> dict:
        """Call ``call``'s batch on the device (a warm-up's from its own
        stream)."""
        rng = np.random.default_rng(sub_seed(self.seed, WARM if warm else BATCH, call))
        ids = rng.integers(0, self.vocab, (self.batch_size, self.text), dtype=np.int64)
        out = {"tokens": torch.from_numpy(ids.astype(np.int32)).to(self.device)}
        if self.grid:
            gen = torch.Generator(self.device).manual_seed(int(rng.integers(1 << 63)))
            out["patch_embeds"] = torch.randn((self.batch_size, self.images, self.d_model),
                                              generator=gen, device=self.device, dtype=self.dtype)
            out["positions"] = self.positions
        return out

    def served_positions(self, rows: int) -> torch.Tensor:
        """The positions of ``rows`` sequences of prompt and served tokens, as
        the program gives them: the prompt's, then the cache index of each
        decoded token (in all three streams for M-RoPE)."""
        dec = torch.arange(self.prompt, self.prompt + self.new - 1, device=self.device)
        if not self.grid:
            return torch.arange(self.prompt + self.new - 1, device=self.device).expand(rows, -1)
        dec = dec[None, :, None].expand(rows, -1, 3)
        return torch.cat([self.positions[:1].long().expand(rows, -1, -1), dec], dim=1)
