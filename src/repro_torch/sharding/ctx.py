"""Activation sharding constraints (MaxText's with_logical_constraint), on
DTensors.

``shard(x, *logical_axes)`` pins an activation's placements at the JAX
package's block boundaries: on a DTensor inside an ``activation_sharding``
context it redistributes ``x`` to the placements the rules give its
logical axes (an all-gather, reduce-scatter, all-to-all or local chunk, as
DTensor picks).  Outside a context, and on a plain tensor, it is the
identity, so CPU runs and the card's serving and training paths are
untouched.

Activation dims use the same logical names as weights where the mapping
coincides (batch/heads/kv/mlp/state/vocab/seq) and ``None`` for the
embedding dim: 'embed' maps to the data axis for *weights* (FSDP), but
activations keep 'data' for the batch dimension.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch

from .rules import ShardingRules, mesh_sizes, placements, resolve_spec

__all__ = ["activation_sharding", "shard"]

_CTX: contextvars.ContextVar = contextvars.ContextVar("act_sharding", default=None)


@contextlib.contextmanager
def activation_sharding(mesh, rules: ShardingRules):
    """Enable shard() constraints on DTensors over ``mesh``.  Plain tensors
    that meet DTensors inside (masks, positions, zero accumulators) count
    as replicated, as constants do in the JAX package's traced program."""
    from torch.distributed.tensor.experimental import implicit_replication

    token = _CTX.set((mesh, rules))
    try:
        with implicit_replication():
            yield
    finally:
        _CTX.reset(token)


def current_ctx():
    """(mesh, rules) of the active activation_sharding context, or None."""
    return _CTX.get()


def bind_ctx(fn):
    """``fn``, run under the activation_sharding context current now, or
    ``fn`` itself outside one: a checkpoint's recompute runs in the
    backward, which on CUDA runs on the autograd engine's own thread,
    where the context is not set."""
    ctx = _CTX.get()
    if ctx is None:
        return fn

    def run(*args, **kwargs):
        token = _CTX.set(ctx)
        try:
            return fn(*args, **kwargs)
        finally:
            _CTX.reset(token)

    return run


def mesh_axis_size(name: str) -> int | None:
    """Size of a mesh axis in the active context (None if inactive/absent)."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    return mesh_sizes(ctx[0]).get(name)


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Constrain ``x``'s placements by logical axis names."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"shard(): {len(axes)} axes for rank-{x.ndim} value")
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    want = placements(resolve_spec(axes, tuple(x.shape), mesh, rules), mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def gather_for_use(w: torch.Tensor) -> torch.Tensor:
    """A weight as a layer uses it: on a DTensor inside a context, replicated
    over the mesh axes the batch takes (FSDP's shards all-gathered, the
    tensor-parallel ones kept), as XLA gathers FSDP weights on use.
    Otherwise the identity.  Without it DTensor may contract a batch-sharded
    activation with a data-sharded weight by splitting the output columns
    instead, which a head count that does not divide the 'model' axis
    cannot be viewed back from."""
    ctx = _CTX.get()
    if ctx is None:
        return w
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(w, DTensor):
        return w
    mesh, rules = ctx
    batch = set(rules.lookup("batch"))
    want = [Replicate() if name in batch else p
            for name, p in zip(mesh.mesh_dim_names, w.placements, strict=True)]
    return w if want == list(w.placements) else w.redistribute(mesh, want)


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(shape)``.  On a DTensor, first gathers any sharded dim
    that the reshape cannot carry its shards through: one split so that
    its leading part does not divide by the shard count (heads into
    (kv heads, group) with fewer kv heads than devices; Mamba's inner
    width into heads), or merged behind another dim (which torch 2.11's
    DTensor cannot do at all), as XLA would relayout it."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x.reshape(shape)
    mesh = x.device_mesh
    gather = set()
    for ins, outs in _dim_groups(tuple(x.shape), tuple(shape)):
        for pos, d in enumerate(ins):
            n = math.prod(mesh.shape[j] for j, p in enumerate(x.placements) if p.is_shard(d))
            if n == 1:
                continue
            if len(ins) > 1 and (pos > 0 or len(outs) > 1):
                gather.add(d)
            elif len(outs) > 1 and shape[outs[0]] % n:
                gather.add(d)
    if gather:
        x = x.redistribute(mesh, [Replicate() if p.is_shard() and p.dim in gather else p
                                  for p in x.placements])
    return _Reshape.apply(x, tuple(shape))


class _Reshape(torch.autograd.Function):
    """A DTensor reshape whose backward reshapes the gradient through
    ``reshape`` too (DTensor's own backward views the gradient back in
    whatever placements it arrives, which may not split)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return x.reshape(shape)

    @staticmethod
    def backward(ctx, grad):
        return reshape(grad, *ctx.shape), None


def _dim_groups(src: tuple, dst: tuple) -> list:
    """The reshape src -> dst as groups of (source dims, target dims) of
    equal element counts, in order."""
    groups: list = []
    i = j = 0
    while i < len(src) and j < len(dst):
        gi, gj, pi, pj = [i], [j], src[i], dst[j]
        i, j = i + 1, j + 1
        while pi != pj:
            if pi < pj:
                gi.append(i)
                pi *= src[i]
                i += 1
            else:
                gj.append(j)
                pj *= dst[j]
                j += 1
        groups.append((gi, gj))
    if groups:  # trailing size-1 dims join the last group
        groups[-1][0].extend(range(i, len(src)))
        groups[-1][1].extend(range(j, len(dst)))
    return groups


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  On a DTensor table sharded on its vocabulary, the
    vocab-parallel lookup: each device looks up the ids that fall in its
    own rows, zeros the rest, and the rows' shards add up (a partial sum),
    as XLA partitions a gather; DTensor's own masked lookup needs data
    (mask equality checks, an index_put backward torch 2.11 cannot place)
    that a traced program does not have."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    # ids whole wherever the table is split
    id_pl = [Replicate() if t.is_shard() else p
             for t, p in zip(table.placements, ids.placements, strict=True)]
    out_pl = [Partial() if t.is_shard(0) else Shard(ids.ndim) if t.is_shard(1) else p
              for t, p in zip(table.placements, id_pl, strict=True)]
    table_grad = [Partial() if t.is_replicate() and not o.is_replicate() else t
                  for t, o in zip(table.placements, out_pl, strict=True)]
    local_ids = ids.redistribute(mesh, id_pl).to_local()
    rows, offset = compute_local_shape_and_global_offset(table.shape, mesh, table.placements)
    inside = (local_ids >= offset[0]) & (local_ids < offset[0] + rows[0])
    rows_here = _to_local(table, table_grad)
    local = rows_here[torch.where(inside, local_ids - offset[0], 0)]
    local = local * inside[..., None].to(local.dtype)
    return _FromLocal.apply(local, mesh, out_pl,
                            [Replicate() if p.is_partial() else p for p in out_pl])


def channelwise(fn, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``fn(x, w)`` for an ``fn`` that mixes x (B, S, C) only along time,
    channel by channel, with w (K, C) (a depthwise causal conv).  On
    DTensors it runs on the local shards: x whole along time, w cut as x's
    channels are; the result has x's placements.  (Torch 2.11's DTensor
    cannot place the pad.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(x, DTensor):
        return fn(x, w)
    mesh = x.device_mesh
    x_pl = [Replicate() if p.is_shard(1) else p for p in x.placements]
    w_pl = [Shard(1) if p.is_shard(2) else Replicate() for p in x_pl]
    w_grad = [Partial() if p.is_replicate() and not q.is_replicate() else p
              for p, q in zip(w_pl, x_pl, strict=True)]
    if not isinstance(w, DTensor):
        w = DTensor.from_local(w, mesh, [Replicate()] * mesh.ndim, run_check=False)
    out = fn(x.redistribute(mesh, x_pl).to_local(),
             _to_local(w.redistribute(mesh, w_pl), w_grad))
    return _FromLocal.apply(out, mesh, x_pl, x_pl)


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum(x, dim)``; on a DTensor, on each device's shards with
    ``dim`` whole (torch 2.11's DTensor cannot place the backward's flip)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return torch.cumsum(x, dim=dim)
    d = dim % x.ndim
    pl = [Replicate() if p.is_shard(d) or p.is_partial() else p for p in x.placements]
    out = torch.cumsum(x.redistribute(x.device_mesh, pl).to_local(), dim=d)
    return _FromLocal.apply(out, x.device_mesh, pl, pl)


def rowwise(fn, rows: tuple, shared: tuple = (), *, like=None, **kwargs) -> tuple:
    """``fn(*rows, *shared, **kwargs)`` for a ``fn`` that treats each row
    (dim 0) of ``rows`` on its own and returns a tuple of tensors with those
    rows: MoE routing, whose data-dependent sorts and scatters DTensor has
    no sharding for.  On DTensors it runs on each device's local rows:
    ``rows`` are redistributed to the row placements of ``like`` (default
    ``rows[0]``; its Shard(0) mesh dims, replicated elsewhere), ``shared``
    to replicated, and the outputs come back as DTensors of those row
    placements; gradients come back to ``rows`` on their row shards and to
    ``shared`` as partial sums.  On plain tensors it is ``fn`` itself."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    lead = rows[0] if like is None else like
    if not isinstance(lead, DTensor):
        return fn(*rows, *shared, **kwargs)
    mesh = lead.device_mesh
    row_pl = [p if p.is_shard(0) else Replicate() for p in lead.placements]
    rep = [Replicate()] * mesh.ndim
    # a shared operand's gradient from one device's rows is a partial sum
    # over the devices that split the rows
    rep_grad = [Partial() if p.is_shard() else Replicate() for p in row_pl]

    def local(t, pl, grad):
        if not isinstance(t, DTensor):
            return t
        return _to_local(t.redistribute(mesh, pl), grad)

    outs = fn(*(local(t, row_pl, row_pl) for t in rows),
              *(local(t, rep, rep_grad) for t in shared), **kwargs)
    return tuple(_FromLocal.apply(o, mesh, row_pl, row_pl) for o in outs)


def expertwise(fn, rows: tuple, experts: tuple = (), *, weight: torch.Tensor, partial: bool,
               **kwargs) -> tuple:
    """``fn(*rows, *experts, lo=, hi=, n_experts=, **kwargs)`` for an ``fn``
    that treats each row (dim 0) on its own and touches only the experts
    ``lo`` to ``hi - 1`` of ``n_experts``: the MoE layer's batched layout,
    where each device fills and runs the slots of its own experts for its
    own rows.  ``weight`` is an expert weight (E, ...), whose Shard(0) mesh
    dims split the experts; ``experts`` hold (B, E, ...) tensors; ``fn``
    returns a tuple of tensors, each (B, hi - lo, ...) or, with
    ``partial``, each (B, ...) summed over its experts.  On plain tensors
    ``lo, hi = 0, n_experts``.  On DTensors each device runs its own rows
    (``rows[0]``'s Shard(0) mesh dims) and its own experts: ``rows`` are
    redistributed to whole rows on their row shards, ``experts`` to
    Shard(0) on the row dims and Shard(1) on the expert dims, and the
    outputs come back sharded so, or as partial sums over the expert dims.
    A row tensor's gradient is a partial sum over the expert dims (each
    device's experts add theirs).  No context is read: a recompute in the
    backward (on the card, on the autograd engine's own thread) places the
    same."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    n_experts = weight.shape[0]
    lead = rows[0]
    if not isinstance(lead, DTensor):
        return fn(*rows, *experts, lo=0, hi=n_experts, n_experts=n_experts, **kwargs)
    mesh = lead.device_mesh
    row_dims = {j for j, p in enumerate(lead.placements) if p.is_shard(0)}
    exp_dims = ({j for j, p in enumerate(weight.placements) if p.is_shard(0)} - row_dims
                if isinstance(weight, DTensor) else set())
    row_pl = [Shard(0) if j in row_dims else Replicate() for j in range(mesh.ndim)]
    exp_pl = [Shard(0) if j in row_dims else Shard(1) if j in exp_dims else Replicate()
              for j in range(mesh.ndim)]
    out_pl = [Partial() if partial and j in exp_dims else p for j, p in enumerate(exp_pl)]
    (n,), (lo,) = compute_local_shape_and_global_offset(
        (n_experts,), mesh, [Shard(0) if j in exp_dims else Replicate() for j in range(mesh.ndim)])

    def local(t, pl):
        if not isinstance(t, DTensor):
            return t
        grad = [Partial() if p.is_replicate() and not o.is_replicate() else p
                for p, o in zip(pl, out_pl, strict=True)]
        return _to_local(t.redistribute(mesh, pl), grad)

    outs = fn(*(local(t, row_pl) for t in rows), *(local(t, exp_pl) for t in experts),
              lo=lo, hi=lo + n, n_experts=n_experts, **kwargs)
    grad_pl = [Replicate() if p.is_partial() else p for p in out_pl]
    return tuple(_FromLocal.apply(o, mesh, out_pl, grad_pl) for o in outs)


def write_slice(dst: torch.Tensor, src: torch.Tensor, start: int | torch.Tensor,
                dim: int = 1) -> None:
    """``dst.narrow(dim, start, n).copy_(src)`` with ``n = src.shape[dim]``,
    in place: a decode step's write into its cache.  ``start`` is an int
    or, on a plain ``dst``, a 0-d integer tensor on its device (a captured
    decode step's position): the window is then written by ``index_copy_``
    at ``start + arange(n)``, with no read of ``start`` on the host.  On a
    DTensor ``dst`` (an int ``start``) each device writes the part of the
    window that falls in its own shard of ``dim`` (``src`` whole along
    ``dim`` there), as XLA's dynamic-update-slice does; DTensor's own
    slicing would gather a sharded ``dim`` and write into the gathered
    copy."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    n = src.shape[dim]
    if not isinstance(dst, DTensor):
        if isinstance(start, torch.Tensor):
            index = start.to(torch.long) + torch.arange(n, device=dst.device)
            dst.index_copy_(dim, index, src.to(dst.dtype))
        else:
            dst.narrow(dim, start, n).copy_(src)
        return
    if isinstance(start, torch.Tensor):
        raise TypeError("write_slice into a DTensor takes an int start (the window's shard "
                        "is found on the host); got a tensor")
    mesh = dst.device_mesh
    local_shape, offset = compute_local_shape_and_global_offset(dst.shape, mesh, dst.placements)
    want = [Replicate() if p.is_shard(dim) else p for p in dst.placements]
    src_local = src.redistribute(mesh, want).to_local() if isinstance(src, DTensor) else src
    lo, hi = max(start, offset[dim]), min(start + n, offset[dim] + local_shape[dim])
    if lo < hi:
        dst.to_local().narrow(dim, lo - offset[dim], hi - lo).copy_(
            src_local.narrow(dim, lo - start, hi - lo))


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, idx[..., None])``: each row's entry at ``idx``
    along the last dim, shape (..., 1).  On a DTensor whose last dim is
    sharded (vocab-parallel logits), a masked sum over that dim instead:
    each device sums its own shard and the shards add, where DTensor's
    gather would build its backward at the full size on every device."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) and any(p.is_shard(x.ndim - 1) for p in x.placements):
        hit = idx[..., None] == torch.arange(x.shape[-1], device=x.device)
        hit = hit.redistribute(x.device_mesh, x.placements)  # a local slice: no traffic
        return torch.where(hit, x, 0.0).sum(dim=-1, keepdim=True)
    return torch.gather(x, -1, idx[..., None])


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``; on DTensors, computed on each device's shards.

    DTensor lowers an einsum to a batched matrix product through views that
    merge dims, and (torch 2.11) refuses to merge a dim whose non-leading
    part is sharded, as every sequence- or head-sharded projection would.
    Here each mesh dim keeps one letter sharded across the operands (the
    one whose rivals are cheapest to gather on that mesh dim), operands
    holding that letter are cut
    on it, the rest replicated, and the local einsum's result is sharded
    on the letter, or a partial sum where the letter is contracted.
    Gradients come back with the matching placements (a partial sum where
    an operand was replicated but the result was not).  Plain operands
    meeting DTensors count as replicated."""
    from torch.distributed.tensor import DTensor

    if not any(isinstance(t, DTensor) for t in operands):
        return torch.einsum(eq, *operands)
    return _sharded_einsum(eq, operands)


def _sharded_einsum(eq: str, operands: tuple) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    lhs, out = eq.replace(" ", "").split("->")
    subs = lhs.split(",")
    mesh = next(t.device_mesh for t in operands if isinstance(t, DTensor))
    rep = [Replicate()] * mesh.ndim
    ops = []
    for t in operands:
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        if any(p.is_partial() for p in t.placements):
            t = t.redistribute(mesh, [Replicate() if p.is_partial() else p for p in t.placements])
        ops.append(t)
    want = [list(t.placements) for t in ops]
    sizes = {ltr: n for sub, t in zip(subs, ops, strict=True) for ltr, n in zip(sub, t.shape)}
    out_bytes = math.prod(sizes[ltr] for ltr in out) * ops[0].element_size()
    out_pl: list = []
    for j in range(mesh.ndim):
        cur = [sub[t.placements[j].dim] if t.placements[j].is_shard() else None
               for sub, t in zip(subs, ops, strict=True)]
        letters = sorted({c for c in cur if c is not None})
        if not letters:
            out_pl.append(Replicate())
            continue
        # keep the letter whose rivals are cheapest to gather on this mesh dim
        keep = min(letters, key=lambda ltr: sum(
            t.numel() * t.element_size() for t, c in zip(ops, cur, strict=True)
            if c is not None and c != ltr))
        if keep not in out and sum(t.numel() * t.element_size() for t, c in
                                   zip(ops, cur, strict=True) if c == keep) < out_bytes:
            # gathering the contracted letter's shards costs less than
            # reducing a partial result (a small weight's contraction)
            for i in range(len(subs)):
                want[i][j] = Replicate()
            out_pl.append(Replicate())
            continue
        for i, sub in enumerate(subs):
            want[i][j] = Shard(sub.index(keep)) if keep in sub else Replicate()
        out_pl.append(Shard(out.index(keep)) if keep in out else Partial())
    local = []
    for t, w in zip(ops, want, strict=True):
        if list(t.placements) != w:
            t = _Redistribute.apply(t, tuple(w))
        grad = [Partial() if p.is_replicate() and not o.is_replicate() else p
                for p, o in zip(w, out_pl, strict=True)]
        local.append(_to_local(t, grad))
    return _FromLocal.apply(torch.einsum(eq, *local), mesh, out_pl,
                            [Replicate() if p.is_partial() else p for p in out_pl])


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``log(sum(exp(x), -1))`` about the (constant) row max, as
    jax.nn.logsumexp takes it.  On a DTensor whose last dim is sharded
    (vocab-parallel logits), each device sums its own shard about the
    rows' global max and the shards' sums add up: two all-reduces of one
    value a row.  (DTensor's own plan of these ops moves whole logits in
    the backward, and another way on each torch version.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(x, DTensor):
        m = torch.amax(x.detach(), dim=-1, keepdim=True)
        return torch.log(torch.sum(torch.exp(x - m), dim=-1)) + m[..., 0]
    mesh, d = x.device_mesh, x.ndim - 1
    x_pl = [Replicate() if p.is_partial() else p for p in x.placements]
    row_pl = [Replicate() if p.is_shard(d) else p for p in x_pl]  # whole rows, dim d gone
    local = _to_local(x.redistribute(mesh, x_pl), x_pl)
    m = DTensor.from_local(torch.amax(local.detach(), dim=-1, keepdim=True), mesh,
                           [Partial("max") if p.is_shard(d) else p for p in x_pl],
                           run_check=False).redistribute(mesh, row_pl).to_local()
    s = _FromLocal.apply(torch.sum(torch.exp(local - m), dim=-1), mesh,
                         [Partial() if p.is_shard(d) else p for p in x_pl], row_pl)
    lse = torch.log(s.redistribute(mesh, row_pl).to_local()) + m[..., 0]
    return _FromLocal.apply(lse, mesh, row_pl, row_pl)


def mean(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dim, keepdim)``.  On a DTensor sharded along ``dim``, each
    device sums its own shard and the sums add up (an all-reduce of the
    result); DTensor's own mean hands its gradient back as a partial
    average, which each torch version then moves another way."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    d = dim % x.ndim
    if not (isinstance(x, DTensor) and any(p.is_shard(d) for p in x.placements)):
        return x.mean(dim=dim, keepdim=keepdim)
    mesh = x.device_mesh
    x_pl = [Replicate() if p.is_partial() else p for p in x.placements]
    out_pl = [Replicate() if p.is_shard(d) else
              Shard(p.dim - 1) if p.is_shard() and p.dim > d and not keepdim else p
              for p in x_pl]
    local = _to_local(x.redistribute(mesh, x_pl), x_pl)
    total = _FromLocal.apply(local.sum(dim=d, keepdim=keepdim), mesh,
                             [Partial() if p.is_shard(d) else o
                              for p, o in zip(x_pl, out_pl, strict=True)],
                             out_pl)
    return total.redistribute(mesh, out_pl) / x.shape[d]


def _to_local(t: torch.Tensor, grad_placements: list) -> torch.Tensor:
    """``t.to_local(grad_placements=)``: the gradient comes back as a
    DTensor of exactly those placements (torch 2.11's own reduces a
    partial-sum gradient there)."""
    return _ToLocal.apply(t, tuple(grad_placements))


class _ToLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grad_placements):
        ctx.mesh, ctx.placements, ctx.shape = x.device_mesh, x.placements, x.shape
        ctx.grad_placements = grad_placements
        local = x.to_local()
        return local.view_as(local)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._utils import compute_global_tensor_info

        _, stride = compute_global_tensor_info(grad, ctx.mesh, ctx.placements)
        return DTensor.from_local(grad, ctx.mesh, ctx.grad_placements, run_check=False,
                                  shape=ctx.shape, stride=tuple(stride)), None


class _Redistribute(torch.autograd.Function):
    """``x.redistribute`` whose gradient stays a partial sum on the mesh
    dims where ``x`` was replicated (DTensor's own backward reduces it
    there, in another way on each torch version), as a replicated
    operand's gradient in XLA stays partial until it is used."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = x.placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        want = [g if p.is_replicate() and g.is_partial() else p
                for p, g in zip(ctx.placements, grad.placements, strict=True)]
        if list(grad.placements) != want:
            grad = grad.redistribute(grad.device_mesh, want)
        return grad, None


class _FromLocal(torch.autograd.Function):
    """``DTensor.from_local`` whose gradient comes back in the placements
    given (a partial sum's as replicated: each device's summand has the
    whole gradient), which torch 2.11's ``from_local`` cannot be told."""

    @staticmethod
    def forward(ctx, local, mesh, placements, grad_placements):
        from torch.distributed.tensor import DTensor

        ctx.mesh, ctx.grad_placements = mesh, grad_placements
        return DTensor.from_local(local, mesh, placements, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        if list(grad.placements) != list(ctx.grad_placements):
            grad = grad.redistribute(ctx.mesh, ctx.grad_placements)
        return grad.to_local(), None, None, None
