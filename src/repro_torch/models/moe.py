"""Mixture-of-Experts FFN of the port: shared experts + routed top-k.

Counterpart of ``repro/models/moe.py``, with its names and its
sort-based, group-wise capacity dispatch: tokens are split into groups
of at most ``GROUP``; inside a group the (token, k) expert copies are
sorted by expert id (a stable sort), ranked within their expert's
segment, and copied into a dense (E, C, D) buffer of capacity
``C = ceil(top_k * group * capacity_factor / n_routed)``. A copy ranked
``C`` or later is dropped: it goes to the dump row ``E * C``, which is
cut off. The expert FFNs then run as three batched products over
(G, E, C, D) x (E, D, F), plain large products that the reference too
computes outside any Pallas kernel.

Where the reference ``vmap``s over groups, the port carries a leading
group axis. Every shape, ``C`` included, follows from the input's
shape, so the block makes no host sync and no data-dependent shape. The
combine gathers each token's k outputs and adds them one by one in
ascending expert order, the order of the reference's scatter-add, so it
uses no atomics and a run on the card is bit-reproducible.

The gradient needs no atomics either. Both moves of rows, tokens into
the buffer and expert outputs back to the tokens' copies, are
:class:`_Gather`: a gather whose backward is again a gather, through the
transposed map, and never a scatter-add over repeated indices (an
``index_select``'s backward, an ``index_add_`` on the card, adds in an
order that changes from run to run). A token's gradient gathers its k
slots' rows and adds them in ascending expert order; a slot's gathers
the one copy that fills it; a dropped copy reads and receives nothing
(the reference's dropped copies land on a dump row that is cut off).
Each map is a partial permutation, so each is the other's transpose.
The router, the top-k weights and the aux losses keep autograd's
gradients.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.sharding import ctx
from repro_torch.sharding.local import (is_dtensor, keep, local_op, partial_where_sharded,
                                        replicated)

GROUP = 4096  # max tokens per dispatch group


def n_experts_padded(e) -> int:
    return max(e.pad_experts_to, e.n_routed) if e.pad_experts_to else e.n_routed


def init_moe(gen: torch.Generator, cfg, lead=()) -> dict:
    """One MoE FFN's weights (``lead`` stacks layers): the router in
    float32 whatever ``cfg.param_dtype`` (the reference's), the routed
    experts (padded to ``n_experts_padded``) and the shared experts'
    SwiGLU in ``cfg.param_dtype``."""
    e = cfg.moe
    et, d, f = n_experts_padded(e), cfg.d_model, e.d_expert
    dt = getattr(torch, cfg.param_dtype)
    sh = e.n_shared * f
    p = {
        "router": L.dense_init(gen, d, e.n_routed, torch.float32, lead=lead),
        "w_gate": L.truncated_normal(gen, (*lead, et, d, f), 1 / math.sqrt(d), dt),
        "w_up": L.truncated_normal(gen, (*lead, et, d, f), 1 / math.sqrt(d), dt),
        "w_down": L.truncated_normal(gen, (*lead, et, f, d), 1 / math.sqrt(f), dt),
    }
    if e.n_shared:
        p["shared"] = {"w_gate": L.dense_init(gen, d, sh, dt, lead=lead),
                       "w_up": L.dense_init(gen, d, sh, dt, lead=lead),
                       "w_down": L.dense_init(gen, sh, d, dt, lead=lead)}
    return p


def _group_shape(n_tokens: int):
    g = min(n_tokens, GROUP)
    while n_tokens % g:
        g //= 2
    return n_tokens // g, g


def capacity(e, group: int) -> int:
    """Slots an expert has in a group: from ``n_routed``, not the padded
    count."""
    return max(1, math.ceil(e.top_k * group * e.capacity_factor / e.n_routed))


def _gather_sum(x, idx, keep):
    """x (G, N, D), idx and keep (G, M, J) -> (G, M, D): row m the sum of
    x's rows ``idx[m, j]`` where ``keep[m, j]``, added in j order (0 where
    no j is kept)."""
    g, n, d = x.shape
    m, j = idx.shape[1:]
    base = torch.arange(g, device=x.device)[:, None, None] * n
    rows = x.reshape(g * n, d).index_select(0, (base + idx).reshape(-1)).view(g, m, j, d)
    rows = torch.where(keep[..., None], rows, 0)
    out = rows[:, :, 0]
    for i in range(1, j):
        out = out + rows[:, :, i]
    return out


class _Gather(torch.autograd.Function):
    """:func:`_gather_sum` of ``x`` through (``idx``, ``keep``), whose
    gradient is :func:`_gather_sum` of the output's gradient through
    (``back_idx``, ``back_keep``), the transposed map: row n of x reaches
    row m of the output through some kept j exactly when row m of the
    output's gradient reaches row n of x's through some kept j of the
    backward map, and never twice."""

    @staticmethod
    def forward(ctx, x, idx, keep, back_idx, back_keep):
        ctx.save_for_backward(idx, keep, back_idx, back_keep)
        return _gather_sum(x, idx, keep)

    @staticmethod
    def backward(ctx, grad):
        idx, keep, back_idx, back_keep = ctx.saved_tensors
        return _Gather.apply(grad, back_idx, back_keep, idx, keep), None, None, None, None


def _dispatch(xg, probs, k, n_exp, cap):
    """xg (G, S, D), probs (G, S, E) -> (buf (G, E*C, D), meta). ``meta``
    is the reference's ``(order, slot, valid, topw, tok)``, each (G, S*k)
    but ``topw`` (G, S, k), then the routes of each token's copies in
    ascending expert order, ``(tslot, tkeep, tpick, fill, filled)``: a
    copy's slot and whether it is kept (G, S, k; ``tslot`` 0 where it is
    dropped), its index into the (S, k) top-k picks (G, S*k), and each
    slot's copy, t * k + j for token t's j-th in that order, and whether
    one fills it (G, E*C; ``fill`` 0 where none does)."""
    g, s, d = xg.shape
    topw, topi = torch.topk(probs, k, dim=-1)
    topw = topw / (torch.sum(topw, -1, keepdim=True) + 1e-9)
    flat_e = topi.reshape(g, s * k)
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    seg_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(s * k, device=xg.device) - seg_start
    valid = rank < cap
    n = n_exp * cap
    slot = torch.where(valid, sorted_e * cap + rank, n)
    tok = order // k
    # each token's copies by their position in the sorted list, which
    # orders them by expert (a token's k experts are distinct)
    pos = torch.sort(torch.argsort(order, dim=-1).view(g, s, k), dim=-1).values
    pos = pos.reshape(g, s * k)
    tkeep = valid.gather(1, pos)
    tslot = torch.where(tkeep, slot.gather(1, pos), 0)
    # each kept copy's index in that order, put at its slot (every kept
    # copy has a slot of its own; the dropped ones all land on the dump
    # column n, which is cut off)
    fill = torch.zeros((g, n + 1), dtype=torch.long, device=xg.device).scatter_(
        1, slot, torch.argsort(pos, dim=-1))[:, :n]
    filled = torch.zeros((g, n + 1), dtype=torch.bool, device=xg.device).scatter_(
        1, slot, valid)[:, :n]
    tslot, tkeep = tslot.view(g, s, k), tkeep.view(g, s, k)
    buf = _Gather.apply(xg, (fill // k)[..., None], filled[..., None], tslot, tkeep)
    routes = (tslot, tkeep, order.gather(1, pos), fill, filled)
    return buf, (order, slot, valid, topw, tok, routes)


def _combine(y_flat, meta, s, k):
    """y_flat (G, E*C, D) expert outputs -> (G, S, D): each token's kept
    outputs times its weights (cast to the activation dtype), summed in
    ascending expert order."""
    topw, (tslot, tkeep, tpick, fill, filled) = meta[3], meta[5]
    g, n, d = y_flat.shape
    y = _Gather.apply(y_flat, tslot.view(g, s * k, 1), tkeep.view(g, s * k, 1),
                      fill[..., None], filled[..., None]).view(g, s, k, d)
    w = topw.reshape(g, s * k).gather(1, tpick).to(y.dtype).view(g, s, k, 1)
    y = y * w
    out = y[:, :, 0]
    for j in range(1, k):
        out = out + y[:, :, j]
    return out


def _dispatch_on_mesh(xg, probs, k, n_exp, cap):
    """:func:`_dispatch` of DTensors: a group routes its own tokens, so
    it runs on each rank's groups (the groups' sharding kept, any other
    gathered); buf and meta come back sharded as the groups."""
    pl = keep(xg, (0,))
    out = local_op(lambda a, b: _flat(_dispatch(a, b, k, n_exp, cap)), (xg, probs),
                   xg.device_mesh, (pl, pl), (pl,) * 11)
    buf, order, slot, valid, topw, tok, *routes = out
    return buf, (order, slot, valid, topw, tok, tuple(routes))


def _flat(dispatched):
    buf, (order, slot, valid, topw, tok, routes) = dispatched
    return (buf, order, slot, valid, topw, tok, *routes)


def _combine_on_mesh(y_flat, meta, s, k):
    """:func:`_combine` of DTensors, on each rank's groups (all the
    experts' outputs of a group gathered to it)."""
    pl = keep(meta[0], (0,))
    flat = (meta[0], meta[1], meta[2], meta[3], meta[4], *meta[5])

    def run(y, *m):
        return _combine(y, (m[0], m[1], m[2], m[3], m[4], tuple(m[5:])), s, k)
    return local_op(run, (y_flat, *flat), y_flat.device_mesh, (pl,) * (1 + len(flat)), pl)


def _experts_on_mesh(p, bufs):
    """:func:`_experts` of a DTensor ``bufs`` laid out (groups, experts):
    each rank runs its experts' shard of the weights on its groups'
    shard of the buffers, the reference's expert parallelism. The
    weights follow the buffers' expert sharding (gathered where they
    are sharded and the buffers are not); their gradients are partial
    sums over the mesh dims that split the groups."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    pl = keep(bufs, (0, 1))
    w_pl = tuple(Shard(0) if x == Shard(1) else Replicate() for x in pl)
    w_grad = tuple(Shard(0) if x == Shard(1) else Partial() if x == Shard(0) else Replicate()
                   for x in pl)
    names = ("w_gate", "w_up", "w_down")
    return local_op(lambda b, *w: _experts(dict(zip(names, w)), b),
                    (bufs, *(p[n] for n in names)), bufs.device_mesh, (pl,) + (w_pl,) * 3, pl,
                    grad_pl=(pl,) + (w_grad,) * 3)


def _experts(p, bufs):
    """bufs (G, E, C, D) -> (G, E, C, D): each expert's SwiGLU, as three
    batched products over E (the groups side by side)."""
    g, et, cap, d = bufs.shape
    xe = bufs.transpose(0, 1).reshape(et, g * cap, d)
    h = L.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    y = torch.bmm(h, p["w_down"])
    return y.view(et, g, cap, d).transpose(0, 1)


def moe_block(p, cfg, x):
    """x (B, S, D) -> (out (B, S, D), aux loss scalar float32): the
    load-balance loss plus 1e-3 times the router z-loss."""
    e = cfg.moe
    b, s, d = x.shape
    n_groups, group = _group_shape(b * s)
    # on a mesh, the groups over the data axes (a reshape of batch-sharded
    # rows may leave a strided layout that the router's product cannot take)
    xf = ctx.constrain(x.reshape(n_groups, group, d), ("pod", "data"), None, None)

    et = n_experts_padded(e)
    if is_dtensor(xf):   # on each rank's groups (the router whole)
        pl = keep(xf, (0,))
        logits = local_op(lambda a, w: a.float() @ w, (xf, p["router"]), xf.device_mesh,
                          (pl, replicated(xf.device_mesh)), pl,
                          grad_pl=(pl, partial_where_sharded(pl)))
    else:
        logits = xf.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    if et > e.n_routed:  # padded experts: unroutable
        probs = torch.nn.functional.pad(probs, (0, et - e.n_routed))

    cap = capacity(e, group)
    if is_dtensor(xf):
        # on a mesh: the reference's expert parallelism, experts over
        # "model", groups over ("pod", "data"), each step on its shards
        bufs, meta = _dispatch_on_mesh(xf, probs, e.top_k, et, cap)
        bufs = ctx.constrain(bufs.view(n_groups, et, cap, d), ("pod", "data"), "model", None, None)
        y = ctx.constrain(_experts_on_mesh(p, bufs), ("pod", "data"), "model", None, None)
        out = _combine_on_mesh(y.reshape(n_groups, et * cap, d), meta, group, e.top_k)
    else:
        bufs, meta = _dispatch(xf, probs, e.top_k, et, cap)
        y = _experts(p, bufs.view(n_groups, et, cap, d))
        out = _combine(y.reshape(n_groups, et * cap, d), meta, group, e.top_k)
    out = out.reshape(b, s, d)

    if e.n_shared:
        sp = p["shared"]
        out = out + L.swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])

    # load-balance + router-z aux losses
    routed = probs[..., : e.n_routed]
    top1 = torch.argmax(routed, dim=-1)
    f = torch.nn.functional.one_hot(top1, e.n_routed).float().mean(dim=(0, 1))
    pbar = routed.mean(dim=(0, 1))
    aux = e.n_routed * torch.sum(f * pbar)
    zloss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return out, aux + 1e-3 * zloss
