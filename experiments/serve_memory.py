"""Where a benchmark cell's peak of reserved card memory (its
``peak_mem_gib``) is reached: the cell's own set-up (``ServeRun.setup``:
weights, engine, the captures, the warm-up calls) and one window call,
with the caching allocator's history recorded, for comparing two trees
(say this one and an unpacked parent under ``build/``) on a card.

    python3 experiments/serve_memory.py --root . --workload qwen2vl-doc-prefill --seed 5
    python3 experiments/serve_memory.py --root build/parent --workload qwen2vl-doc-prefill --seed 5

Printed as one JSON line: the allocator's peaks (reserved and allocated,
GiB), its retries (allocations that freed the cache first), and at the
moment reserved memory peaked the bytes reserved and allocated, the
segments' sizes, and the program frames of the allocation whose new
segment reached the peak.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

GIB = 2**30


def _frames(event: dict) -> list[str]:
    return [f"{Path(f['filename']).name}:{f['line']} {f['name']}" for f in event.get("frames", [])
            if "repro_torch" in f["filename"] or "/bench/" in f["filename"]][:8]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root / "bench")]
    import torch

    from common import Cell

    cell = Cell(root, args.workload)
    runner = cell.module("runners", cell.traffic["runner"])
    run = runner.ServeRun(cell, args.seed, 1.0, "cuda", time.perf_counter())
    base = torch.cuda.memory_reserved()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000, stacks="python")
    run.setup()
    run.window(calls=1)
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    stats = torch.cuda.memory_stats()

    reserved = allocated = 0
    segments: dict[int, int] = {}
    peak = (0, 0, {}, None)
    for ev in snap["device_traces"][0]:
        act, size = ev["action"], ev["size"]
        if act == "segment_alloc":
            reserved += size
            segments[ev["addr"]] = size
            if reserved > peak[0]:
                peak = (reserved, allocated, dict(segments), ev)
        elif act == "segment_free":
            reserved -= size
            segments.pop(ev["addr"], None)
        elif act == "alloc":
            allocated += size
        elif act == "free_completed":
            allocated -= size
    res, alloc, segs, ev = peak
    print(json.dumps({
        "root": str(args.root), "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0),
        "reserved_peak_gib": stats["reserved_bytes.all.peak"] / GIB,
        "allocated_peak_gib": stats["allocated_bytes.all.peak"] / GIB,
        "alloc_retries": stats["num_alloc_retries"],
        "reserved_before_trace_gib": base / GIB,
        "at_peak": {"reserved_traced_gib": res / GIB, "allocated_traced_gib": alloc / GIB,
                    "segments_gib": sorted((round(s / GIB, 3) for s in segs.values()),
                                           reverse=True)[:24],
                    "n_segments": len(segs),
                    "last_segment_gib": None if ev is None else ev["size"] / GIB,
                    "last_segment_frames": [] if ev is None else _frames(ev)}}))


if __name__ == "__main__":
    main()
