"""Loop-aware cost extraction from optimized HLO text.

``compiled.cost_analysis()`` counts a ``while`` body ONCE — a 95-layer
``lax.scan`` model reports ~1/95th of its FLOPs.  This walker parses the
post-optimization HLO module, recovers the call graph (entry -> fusions
-> while bodies, nested), extracts each loop's trip count from its
condition computation, and accumulates

* ``dot_flops``   — exact matmul FLOPs (2 x result x contracted dims),
* ``ew_flops``    — 1 FLOP/element for arithmetic elementwise/reduce ops,
* ``bytes``       — HLO traffic: operand + result bytes of every
                    compute op (the same semantic XLA's cost model uses,
                    loop-scaled; an upper bound on HBM traffic since
                    VMEM-resident fusion internals on TPU don't hit HBM),
* ``collectives`` — operand bytes + counts per collective op,

all multiplied through nested loop trip counts.  Validated against
hand-computed costs and against ``cost_analysis()`` on loop-free
modules (tests/test_roofline.py).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterable

__all__ = ["HloCosts", "parse_hlo_costs"]

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "f16": 2, "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
    "f64": 8, "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "f8e5m2fnuz": 1, "f8e4m3fnuz": 1, "token": 0, "u1": 1,
}

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# ops costing ~1 flop per output element
_EW_OPS = {
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "abs",
    "negate", "exponential", "exponential-minus-one", "log", "log-plus-one",
    "tanh", "logistic", "sqrt", "rsqrt", "power", "cosine", "sine", "floor",
    "ceil", "round-nearest-afz", "round-nearest-even", "remainder", "atan2",
    "cbrt", "erf", "compare", "select", "clamp", "and", "or", "xor", "not",
    "shift-left", "shift-right-logical", "shift-right-arithmetic",
    "reduce", "reduce-window", "cumsum",
}

# ops whose operands/results do not represent real data movement
_FREE_OPS = {
    "parameter", "constant", "tuple", "get-tuple-element", "bitcast",
    "after-all", "add-dependency", "while", "conditional", "call",
    "fusion", "partition-id", "replica-id", "rng-get-and-update-state",
    "opt-barrier",
}

_TYPE_TOKEN = r"[a-z][a-z0-9]*\[[0-9,]*\](?:\{[^}]*\})?"
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?(?P<name>[\w.\-]+)\s*=\s*"
    r"(?P<type>\(.*?\)|" + _TYPE_TOKEN + r")\s*"
    r"(?P<op>[\w\-]+)\(",
)
_SHAPE_RE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")
_COMP_HEADER_RE = re.compile(
    r"^\s*(?:ENTRY\s+)?%?(?P<name>[\w.\-]+)\s+\((?P<params>.*)\)\s*->"
)
_ATTR_CALLS_RE = re.compile(r"calls=%?([\w.\-]+)")
_ATTR_BODY_RE = re.compile(r"body=%?([\w.\-]+)")
_ATTR_COND_RE = re.compile(r"condition=%?([\w.\-]+)")
_CONST_INT_RE = re.compile(r"constant\((\d+)\)")
_OPERAND_NAME_RE = re.compile(r"%([\w.\-]+)")
_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")


def _type_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES.get(dt, 4)
    return total


def _type_elems(type_str: str) -> int:
    total = 0
    for _dt, dims in _SHAPE_RE.findall(type_str):
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n
    return total


def _first_shape_dims(type_str: str) -> list[int]:
    m = _SHAPE_RE.search(type_str)
    if not m:
        return []
    dims = m.group(2)
    return [int(d) for d in dims.split(",")] if dims else []


@dataclasses.dataclass
class _Instr:
    name: str
    type_str: str
    op: str
    rest: str  # text after the opening paren of the op call


@dataclasses.dataclass
class _Computation:
    name: str
    instrs: list[_Instr]
    defs: dict[str, str]  # instr/param name -> type string


@dataclasses.dataclass
class HloCosts:
    dot_flops: float = 0.0
    ew_flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in _COLLECTIVES}
    )
    coll_counts: dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in _COLLECTIVES}
    )

    @property
    def flops(self) -> float:
        return self.dot_flops + self.ew_flops

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())

    def scaled(self, k: float) -> "HloCosts":
        return HloCosts(
            dot_flops=self.dot_flops * k,
            ew_flops=self.ew_flops * k,
            bytes=self.bytes * k,
            coll_bytes={o: b * k for o, b in self.coll_bytes.items()},
            coll_counts={o: c * k for o, c in self.coll_counts.items()},
        )

    def add(self, other: "HloCosts") -> None:
        self.dot_flops += other.dot_flops
        self.ew_flops += other.ew_flops
        self.bytes += other.bytes
        for o in _COLLECTIVES:
            self.coll_bytes[o] += other.coll_bytes[o]
            self.coll_counts[o] += other.coll_counts[o]


def _split_computations(text: str) -> dict[str, _Computation]:
    comps: dict[str, _Computation] = {}
    cur: _Computation | None = None
    for raw in text.splitlines():
        line = raw.rstrip()
        s = line.strip()
        if cur is None:
            m = _COMP_HEADER_RE.match(line)
            if m and line.rstrip().endswith("{"):
                cur = _Computation(m.group("name"), [], {})
                # parameter types from the header
                for pname, ptype in re.findall(
                    r"([\w.\-]+):\s*(\(.*?\)|" + _TYPE_TOKEN + r")", m.group("params")
                ):
                    cur.defs[pname] = ptype
            continue
        if s == "}":
            comps[cur.name] = cur
            cur = None
            continue
        m = _INSTR_RE.match(s)
        if m:
            name, type_str, op = m.group("name"), m.group("type"), m.group("op")
            rest = s[m.end() :]
            cur.defs[name] = type_str
            cur.instrs.append(_Instr(name, type_str, op, rest))
    return comps


def _operands_text(rest: str) -> str:
    """Text inside the op's parens (bracket-matched)."""
    depth = 1
    for i, ch in enumerate(rest):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                return rest[:i]
    return rest


def _trip_count(cond: _Computation) -> int:
    """Max integer constant in the loop condition (jax scan: iter < N)."""
    best = 1
    joined = "\n".join(
        f"{i.name} {i.type_str} {i.op}({i.rest}" for i in cond.instrs
    )
    for m in _CONST_INT_RE.finditer(joined):
        best = max(best, int(m.group(1)))
    return best


def _dot_flops(ins: _Instr, comp: _Computation) -> float:
    out_elems = _type_elems(ins.type_str)
    operands = _operands_text(ins.rest)
    names = _OPERAND_NAME_RE.findall(operands)
    m = _CONTRACT_RE.search(ins.rest)
    contracted = 1
    if m and names:
        lhs_type = comp.defs.get(names[0], "")
        dims = _first_shape_dims(lhs_type)
        idxs = [int(x) for x in m.group(1).split(",")] if m.group(1) else []
        for i in idxs:
            if i < len(dims):
                contracted *= dims[i]
    return 2.0 * out_elems * contracted


def parse_hlo_costs(text: str, entry: str | None = None) -> HloCosts:
    comps = _split_computations(text)
    if not comps:
        return HloCosts()
    if entry is None:
        # entry computation: the one marked ENTRY, else heuristic 'main'
        m = re.search(r"^ENTRY\s+%?([\w.\-]+)", text, re.MULTILINE)
        entry = m.group(1) if m else next(reversed(comps))

    memo: dict[str, HloCosts] = {}

    def cost_of(name: str, stack: tuple[str, ...] = ()) -> HloCosts:
        if name in memo:
            return memo[name]
        comp = comps.get(name)
        out = HloCosts()
        if comp is None or name in stack:
            return out
        for ins in comp.instrs:
            op = ins.op
            if op == "dot":
                out.dot_flops += _dot_flops(ins, comp)
                out.bytes += _type_bytes(ins.type_str)
                for on in _OPERAND_NAME_RE.findall(_operands_text(ins.rest)):
                    out.bytes += _type_bytes(comp.defs.get(on, ""))
            elif op in _COLLECTIVES:
                b = 0
                for on in _OPERAND_NAME_RE.findall(_operands_text(ins.rest)):
                    b += _type_bytes(comp.defs.get(on, ""))
                out.coll_bytes[op] += b
                out.coll_counts[op] += 1
                out.bytes += b + _type_bytes(ins.type_str)
            elif op == "fusion" or op == "call":
                m = _ATTR_CALLS_RE.search(ins.rest) if op == "fusion" else None
                callee = m.group(1) if m else None
                if op == "call":
                    mc = re.search(r"to_apply=%?([\w.\-]+)", ins.rest)
                    callee = mc.group(1) if mc else None
                if callee:
                    sub = cost_of(callee, stack + (name,))
                    if op == "fusion":
                        # fusion internals execute in registers/VMEM: keep
                        # their FLOPs and collectives, drop internal bytes —
                        # the fusion's traffic is its boundary (below).
                        sub = dataclasses.replace(
                            sub,
                            bytes=0.0,
                            coll_bytes=dict(sub.coll_bytes),
                            coll_counts=dict(sub.coll_counts),
                        )
                    out.add(sub)
                # boundary traffic: operands + result
                out.bytes += _type_bytes(ins.type_str)
                for on in _OPERAND_NAME_RE.findall(_operands_text(ins.rest)):
                    out.bytes += _type_bytes(comp.defs.get(on, ""))
            elif op == "while":
                mb = _ATTR_BODY_RE.search(ins.rest)
                mc = _ATTR_COND_RE.search(ins.rest)
                trips = 1
                if mc and mc.group(1) in comps:
                    trips = _trip_count(comps[mc.group(1)])
                if mb and mb.group(1) in comps:
                    body_cost = cost_of(mb.group(1), stack + (name,))
                    out.add(body_cost.scaled(trips))
                if mc and mc.group(1) in comps:
                    out.add(cost_of(mc.group(1), stack + (name,)).scaled(trips))
            elif op == "conditional":
                branches = re.findall(r"branch_computations=\{([^}]*)\}", ins.rest)
                names = []
                if branches:
                    names = _OPERAND_NAME_RE.findall(branches[0])
                else:
                    names = [
                        m.group(1)
                        for m in re.finditer(r"(?:true|false)_computation=%?([\w.\-]+)", ins.rest)
                    ]
                sub = [cost_of(n, stack + (name,)) for n in names if n in comps]
                if sub:
                    # worst-case branch
                    worst = max(sub, key=lambda c: c.flops + c.bytes)
                    out.add(worst)
            elif op in _FREE_OPS:
                continue
            elif op == "dynamic-slice" or op == "gather":
                # reads only the slice, not the (potentially stacked-layer)
                # full operand: traffic = 2 x result
                out.bytes += 2 * _type_bytes(ins.type_str)
            elif op == "dynamic-update-slice" or op == "scatter":
                # writes only the update (result aliases the buffer):
                # traffic = 2 x update operand (operand index 1)
                names = _OPERAND_NAME_RE.findall(_operands_text(ins.rest))
                upd = _type_bytes(comp.defs.get(names[1], "")) if len(names) > 1 else 0
                out.bytes += 2 * upd
            else:
                elems = _type_elems(ins.type_str)
                if op in _EW_OPS:
                    out.ew_flops += elems
                out.bytes += _type_bytes(ins.type_str)
                for on in _OPERAND_NAME_RE.findall(_operands_text(ins.rest)):
                    out.bytes += _type_bytes(comp.defs.get(on, ""))
        memo[name] = out
        return out

    # fusions called inside whiles are reached via the call graph; entry-only
    # traversal avoids double-counting shared computations.
    return cost_of(entry)
