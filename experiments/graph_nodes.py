"""The kernel nodes of the serving engine's untraced CUDA graphs, one a line,
for comparing two trees (say this one and an unpacked parent under
``build/``) on a card.

    python3 experiments/graph_nodes.py --src src --out build/nodes.txt
    python3 experiments/graph_nodes.py --src build/parent/src --out build/nodes_parent.txt
    diff build/nodes_parent.txt build/nodes.txt

qwen2-vl-2b at its published widths and depth in bf16, ``--rows`` rows (16;
the chat cell's 256) of an 8 x 8 patch grid and 120 text tokens, 3 new
tokens, ``max_len`` 256; ``--arch moonlight-16b-a3b`` (published widths and
depth) takes 120 text tokens a row.  Each line
``prefill`` or ``decode`` and the node's kernel as
``cudaGraphDebugDotPrint`` names it (mangled, with its launch shape), the
node IDs left out. Printed: the node counts and a hash of each list and of
the tokens.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import sys


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default="src")
    ap.add_argument("--out", default="build/nodes.txt")
    ap.add_argument("--arch", default="qwen2-vl-2b", choices=["qwen2-vl-2b", "moonlight-16b-a3b"])
    ap.add_argument("--rows", type=int, default=16)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_arch(args.arch)
    dev = torch.device("cuda")
    model = Model(cfg, generator=torch.Generator(dev).manual_seed(3), device=dev,
                  dtype=torch.bfloat16)
    B, G, T = args.rows, 8, 120
    g = torch.Generator(dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, T), generator=g, device=dev,
                                     dtype=torch.int32)}
    if cfg.rope == "mrope":
        r, c = torch.arange(G * G, device=dev) // G, torch.arange(G * G, device=dev) % G
        pos = torch.cat([torch.stack([torch.zeros_like(r), r, c], -1),
                         (G + torch.arange(T, device=dev))[:, None].expand(T, 3)])
        batch["patch_embeds"] = torch.randn(B, G * G, cfg.d_model, generator=g, device=dev,
                                            dtype=torch.bfloat16)
        batch["positions"] = pos[None].expand(B, -1, -1).to(torch.int32).contiguous()
    engine = ServeEngine(model, ServeConfig(max_len=256))
    tokens = engine.generate(batch, 3)
    engine.generate(batch, 3)  # replays
    lines, summary = [], {}
    for name, step in (("prefill", engine._prefill), ("decode", engine._decode)):
        (key,) = step.graphs
        nodes = [re.sub(r"^\| \{ID \| \d+ (\(topoId: \d+\) )?\| ", "", k)
                 for k in step.kernels(key)]
        lines += [f"{name} {n}" for n in nodes]
        summary[name] = {"kernel_nodes": len(nodes), "launches": step.launches(key),
                         "sha": hashlib.sha256("\n".join(nodes).encode()).hexdigest()[:16]}
    summary["tokens_sha"] = hashlib.sha256(tokens.cpu().numpy().tobytes()).hexdigest()[:16]
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(args.src, args.arch, B, json.dumps(summary))


if __name__ == "__main__":
    main()
