"""Do timing events recorded under CUDA stream capture time each replay?

    python3 experiments/graph_event_probe.py [--out build/graph_event_probe.json]

On a card: three known kernels (a bf16 product, an elementwise add over a
large tensor, a second product), with a pair of
``torch.cuda.Event(enable_timing=True, external=True)`` around the middle
one and a pair around all three. The same work runs eagerly (events around
it) and captured as one CUDA graph, replayed many times; after each replay
the graph's own events are read. Printed: the median ms of each span, eager
against replayed, the replayed spans' spread, the graph's node kinds as
``cudaGraphDebugDotPrint`` names them, and the cost of event nodes: a graph
of many small kernels with and without a pair of event nodes around each.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import tempfile
import warnings

import torch


def node_kinds(graph: torch.cuda.CUDAGraph) -> dict[str, int]:
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        path = os.path.join(tmp, "g.dot")
        graph.debug_dump(path)
        text = open(path).read()
    kinds: dict[str, int] = {}
    # a kernel's label opens "{KERNEL", an event record's "<id> (topoId: n)" then "EVENT_RECORD"
    for m in re.finditer(r'label="(?:\{|[^"\n]*\n)([A-Z_]+)\n', text):
        kinds[m.group(1)] = kinds.get(m.group(1), 0) + 1
    return kinds


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/graph_event_probe.json")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    dev = torch.device("cuda")
    a = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
    x = torch.randn(64 * 2**20, device=dev)
    y = torch.empty_like(x)

    def work(ev):
        c = a @ a
        ev[0].record()
        torch.add(x, 1.0, out=y)
        ev[1].record()
        d = c @ a
        ev[2].record()
        return d

    def events():
        return [torch.cuda.Event(enable_timing=True, external=True) for _ in range(4)]

    # eager
    eager_mid, eager_all = [], []
    for _ in range(3):
        work(events())
    torch.cuda.synchronize()
    for _ in range(args.reps):
        ev = events()
        ev[3].record()
        work(ev)
        ev[2].synchronize()
        eager_mid.append(ev[0].elapsed_time(ev[1]))
        eager_all.append(ev[3].elapsed_time(ev[2]))

    # captured
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        work(events())
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    gev = events()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    g.enable_debug_mode()
    with torch.cuda.graph(g):
        gev[3].record()
        work(gev)
    g.instantiate()
    kinds = node_kinds(g)
    graph_mid, graph_all, wall = [], [], []
    for _ in range(args.reps):
        w0, w1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        w0.record()
        g.replay()
        w1.record()
        w1.synchronize()
        graph_mid.append(gev[0].elapsed_time(gev[1]))
        graph_all.append(gev[3].elapsed_time(gev[2]))
        wall.append(w0.elapsed_time(w1))

    # the cost of event nodes: 2000 small kernels, bare or each between a pair
    small = torch.zeros(1024, device=dev)
    n_small = 2000

    def smalls(pairs):
        for i in range(n_small):
            if pairs is not None:
                pairs[i][0].record()
            small.add_(1.0)
            if pairs is not None:
                pairs[i][1].record()

    costs = {}
    for mode in ("bare", "events"):
        pairs = ([(torch.cuda.Event(enable_timing=True, external=True),
                   torch.cuda.Event(enable_timing=True, external=True)) for _ in range(n_small)]
                 if mode == "events" else None)
        with torch.cuda.stream(s):
            smalls(pairs)
        torch.cuda.synchronize()
        gg = torch.cuda.CUDAGraph()
        with torch.cuda.graph(gg):
            smalls(pairs)
        times = []
        for _ in range(20):
            w0, w1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            w0.record()
            gg.replay()
            w1.record()
            w1.synchronize()
            times.append(w0.elapsed_time(w1))
        costs[mode] = statistics.median(times)
        if pairs is not None:
            costs["events_span_sum"] = sum(p[0].elapsed_time(p[1]) for p in pairs)

    out = {
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "card": torch.cuda.get_device_name(0),
        "eager_mid_ms": statistics.median(eager_mid), "graph_mid_ms": statistics.median(graph_mid),
        "graph_mid_min_max": [min(graph_mid), max(graph_mid)],
        "eager_all_ms": statistics.median(eager_all), "graph_all_ms": statistics.median(graph_all),
        "graph_wall_ms": statistics.median(wall),
        "graph_all_min_max": [min(graph_all), max(graph_all)],
        "graph_node_kinds": kinds,
        "small_kernels": n_small, "small_bare_ms": costs["bare"],
        "small_with_event_pairs_ms": costs["events"],
        "event_node_us_each": 1e3 * (costs["events"] - costs["bare"]) / (2 * n_small),
        "small_spans_sum_ms": costs["events_span_sum"],
    }
    print(json.dumps(out, indent=1))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
