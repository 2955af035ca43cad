"""Mixture-of-Experts FFN; the port of ``repro.models.lm.moe``.

* ``_moe_local``: top-k routing -> flatten the (T·k) assignments -> stable
  sort by expert -> the grouped product (``jax.lax.ragged_dot``'s groups)
  -> unsort by a permutation write -> weighted combine. No (T, E, C)
  one-hot dispatch tensor is materialized. The grouped product writes
  each expert's rows into a bucket of the fullest expert's length and
  takes one batched product over the buckets: three launches a layer,
  not three an expert, and one host sync a layer for the bucket length.
  Without a mesh (and under pure FSDP) ``moe_block`` takes it.

* ``_moe_sharded`` (allgather expert parallelism) and ``_moe_sharded_a2a``
  (all-to-all dispatch): the reference's ``shard_map`` bodies, run on
  each rank's shards (``sharding.rules.local_call``) with autograd-aware
  functional collectives (``sharding.collectives``); the expert dim is
  sharded over "model", padded with never-routed dummy experts up to a
  multiple of it (granite's 40); the axes' sizes are the active mesh's.
  Each keeps at most ``cap`` assignments an expert at fixed slots
  (capacity ``int(cf * T * k / E) + 1``, the stable slot order and the
  dropped overflow of the reference, expression for expression, so the
  same assignments drop) and runs the experts as one batched product
  over the slots.

Each token row is gathered once for each of its k experts (or slots)
(:func:`~repro_torch.kernels.keyed_rows`): on the card the gradient of
that gather is K2 over the token ids in a fixed order, not float atomics.

Aux load-balance loss follows Switch/GShard: E · Σ_e f_e · p_e.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...kernels import keyed_rows
from ...sharding import collectives as C
from ...sharding.rules import (_active_mesh, current_rules, local_call,
                               spec)


def _route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """xt: (T, d) -> (top_p (T,k) f32-normalized, top_i (T,k), probs).
    Ties go to the lower expert index, as ``jax.lax.top_k`` breaks them."""
    logits = (xt.to(router.dtype) @ router).float()
    probs = torch.softmax(logits, dim=-1)
    top_i = torch.argsort(probs, dim=-1, descending=True, stable=True)[:, :k]
    top_p = probs.gather(-1, top_i)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_i, probs


def _aux_loss(probs: torch.Tensor, top_i: torch.Tensor, e: int):
    frac_tokens = F.one_hot(top_i, e).float().mean(dim=(0, 1))
    mean_prob = probs.mean(dim=0)
    return e * torch.sum(frac_tokens * mean_prob)


def _buckets(sorted_expert: torch.Tensor, e: int) -> tuple:
    """Rows sorted by expert -> (their expert, their slot in its bucket,
    the bucket length: the most rows any expert has)."""
    counts = torch.bincount(sorted_expert, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    slot = (torch.arange(sorted_expert.numel(), device=counts.device)
            - starts[sorted_expert])
    return sorted_expert, slot, int(counts.max())


def _grouped(xs: torch.Tensor, w: torch.Tensor, buckets: tuple
             ) -> torch.Tensor:
    """``ragged_dot``: each row of ``xs`` (sorted by expert) times its
    expert's ``w[e]``, as one batched product over zero-padded buckets."""
    expert, slot, cap = buckets
    buf = xs.new_zeros((w.shape[0], cap, xs.shape[-1]))
    buf = buf.index_put((expert, slot), xs)
    return torch.bmm(buf, w)[expert, slot]


def _moe_local(p: dict, x: torch.Tensor, cfg):
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    xt = x.reshape(b * s, d)
    t = xt.shape[0]
    top_p, top_i, probs = _route(xt, p["router"], k)
    top_p = top_p.to(x.dtype)

    flat_expert = top_i.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    xs = keyed_rows(xt, order // k)
    buckets = _buckets(flat_expert[order], e)

    h = F.silu(_grouped(xs, p["experts_gate"], buckets))
    h = h * _grouped(xs, p["experts_up"], buckets)
    y = _grouped(h, p["experts_down"], buckets)

    y_unsorted = torch.empty_like(y).index_copy_(0, order, y)
    out = torch.einsum("tkd,tk->td", y_unsorted.reshape(t, k, d), top_p)
    return out.reshape(b, s, d), _aux_loss(probs, top_i, e)


def _ba_size(ba, mesh) -> int:
    """The number of ranks the batch axes ``ba`` span on ``mesh``."""
    return C.axis_size(mesh, ba)


def _local_experts(w: torch.Tensor, e_pad: int, e_loc: int, r: int
                   ) -> torch.Tensor:
    """This rank's ``e_loc`` experts of ``w``: its local block where the
    expert dim is sharded over "model" (``w`` holds ``e_loc`` experts),
    else its slice of ``w`` padded with zero (never-routed) experts up to
    ``e_pad``."""
    if w.shape[0] == e_loc:
        return w
    w = F.pad(w, (0, 0, 0, 0, 0, e_pad - w.shape[0]))
    return w[r * e_loc:(r + 1) * e_loc]


def _experts_ffn(xs, gate, up, down):
    """(E_loc, cap, d) slots through each local expert's SwiGLU."""
    h = F.silu(torch.einsum("ecd,edf->ecf", xs, gate))
    h = h * torch.einsum("ecd,edf->ecf", xs, up)
    return torch.einsum("ecf,efd->ecd", h, down)


def _expert_weights(p: dict, e: int, msize: int):
    """(w_spec, the three expert weights): sharded over "model" on the
    expert dim where it divides, else whole on each rank (padded and
    sliced in the body): the reference pads to ``e_pad`` and shards."""
    m = current_rules().model_axis
    w_spec = spec(m, None, None) if e % msize == 0 else spec(None, None,
                                                             None)
    return w_spec, (p["experts_gate"], p["experts_up"], p["experts_down"])


def _moe_sharded(p: dict, x: torch.Tensor, cfg, mesh):
    """The allgather expert-parallel dispatch, on local shards: gather the
    data shard's tokens over "model", route them all, keep the (token,
    slot) assignments of this rank's experts at fixed capacity slots
    (overflow dropped), run the experts as one batched product, weight
    and scatter back, and reduce-scatter over "model"."""
    rules = current_rules()
    ba = rules.batch_axes
    m = rules.model_axis
    msize = C.axis_size(mesh, m)
    e, k = cfg.num_experts, cfg.experts_per_tok
    e_pad = -(-e // msize) * msize
    e_loc = e_pad // msize
    b, s, d = x.shape
    seq_sharded = s % msize == 0
    ba_size = _ba_size(ba, mesh)
    batch_sharded = b % ba_size == 0
    b_loc = b // ba_size if batch_sharded else b
    t = b_loc * s                       # tokens per data shard (post-gather)
    # capacity per expert is relative to the REAL expert count: padded dummy
    # experts are never routed to, so the live experts carry T·k/e each
    cap = int(cfg.moe_capacity_factor * t * k / e) + 1
    l_static = cap * e_loc
    x_spec = spec(ba if batch_sharded else None,
                  m if seq_sharded else None, None)
    w_spec, ws = _expert_weights(p, e, msize)

    def body(xb, router, gate_l, up_l, down_l):
        r = C.axis_index(mesh, m)
        gate_l, up_l, down_l = (_local_experts(w, e_pad, e_loc, r)
                                for w in (gate_l, up_l, down_l))
        xg = C.all_gather(xb, mesh, m, 1) if seq_sharded else xb
        bl, sl, _ = xg.shape
        xt = xg.reshape(bl * sl, d)
        tl = xt.shape[0]
        top_p, top_i, probs = _route(xt, router, k)
        top_p = top_p.to(xb.dtype)

        lo = r * e_loc
        flat_expert = top_i.reshape(-1)                       # (T*k,)
        local_id = flat_expert - lo
        is_local = (local_id >= 0) & (local_id < e_loc)
        key = torch.where(is_local, local_id, e_loc)
        slot, order, slot_token, slot_w = _slot_pack(
            key, e_loc, cap, tl, k, top_p)
        xs = _slot_rows(xt, slot_token, tl).reshape(e_loc, cap, d)
        y = _experts_ffn(xs, gate_l, up_l, down_l).reshape(l_static, d)
        out = _combine(y, slot_token, slot_w, tl).reshape(bl, sl, d)
        if seq_sharded:
            out = C.psum_scatter(out, mesh, m, 1)
        else:
            out = C.psum(out, mesh, m)
        aux = _aux_loss(probs, top_i, e)
        if batch_sharded:
            aux = C.psum(aux, mesh, ba) / C.axis_size(mesh, ba)
        return out, aux

    return local_call(body, (x_spec, spec(None, None), w_spec, w_spec,
                             w_spec), [x_spec, ()],
                      x, p["router"], *ws)


def _slot_pack(assign_key, n_groups, cap, tl, k, top_p):
    """Shared slot-packing: sort rows by ``assign_key`` (stably; values
    >= n_groups are dropped), keep <= cap per group at fixed slots
    group*cap + rank.

    Returns (slot (rows,), order, slot_token (n_groups*cap,), slot_w):
    slot_token is the source token (sentinel tl for empty slots), slot_w
    the router weight of the row in each slot."""
    l_static = n_groups * cap
    order = torch.argsort(assign_key, stable=True)
    sorted_key = assign_key[order]
    gsz = _counts(sorted_key, n_groups)
    starts = torch.cumsum(gsz, 0) - gsz
    pos = (torch.arange(sorted_key.shape[0], device=assign_key.device)
           - starts[sorted_key.clamp(0, n_groups - 1)])
    keep = (sorted_key < n_groups) & (pos < cap)
    slot = torch.where(keep, sorted_key * cap + pos, l_static)
    token_of_row = torch.div(order, k, rounding_mode="floor").to(torch.int32)
    slot_token = _scatter_slots(
        torch.full((l_static + 1,), tl, dtype=torch.int32,
                   device=slot.device), slot, token_of_row)
    w_rows = top_p.reshape(-1)[order]
    slot_w = _scatter_slots(w_rows.new_zeros((l_static + 1,)), slot, w_rows)
    return slot, order, slot_token, slot_w


def _counts(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(keys)[:n]`` for keys in [0, n]: a static shape, as a
    dry-run's fake tensors need."""
    ones = torch.ones_like(keys, dtype=torch.int64)
    return keys.new_zeros((n + 1,), dtype=torch.int64).scatter_add_(
        0, keys.long(), ones)[:n]


def _scatter_slots(buf: torch.Tensor, slot: torch.Tensor,
                   rows: torch.Tensor) -> torch.Tensor:
    """``buf.at[slot].set(rows)[:-1]``: every kept row to its slot; the
    dropped rows all go to the last entry, which is cut off."""
    return buf.index_put((slot,), rows)[:-1]


def _slot_rows(xt: torch.Tensor, slot_token: torch.Tensor, tl: int
               ) -> torch.Tensor:
    """The token row of every slot, 0 in empty ones: one row gathered per
    slot (:func:`keyed_rows`; on the card its gradient is K2)."""
    valid = slot_token < tl
    rows = keyed_rows(xt, torch.clamp(slot_token, max=tl - 1))
    return torch.where(valid[:, None], rows, 0)


def _combine(y: torch.Tensor, slot_token: torch.Tensor,
             slot_w: torch.Tensor, tl: int) -> torch.Tensor:
    """Each slot's expert output times its router weight, added into its
    token's row of a (tl, d) output; empty slots add nowhere."""
    idx = torch.where(slot_token < tl, slot_token, tl).long()
    out = y.new_zeros((tl + 1, y.shape[1]))
    return out.index_add(0, idx, y * slot_w[:, None])[:tl]


def _moe_sharded_a2a(p: dict, x: torch.Tensor, cfg, mesh):
    """All-to-all expert dispatch: each rank routes only its OWN tokens
    and ships exactly the rows bound for each expert owner: two
    all-to-alls of (msize, C2, d) with C2 ≈ cf·T·k/msize². Tokens keep
    their expert id through the wire so the receiver re-packs per local
    expert; both capacity stages drop overflow."""
    rules = current_rules()
    ba = rules.batch_axes
    m = rules.model_axis
    msize = C.axis_size(mesh, m)
    e, k = cfg.num_experts, cfg.experts_per_tok
    cf = cfg.moe_capacity_factor
    e_pad = -(-e // msize) * msize
    e_loc = e_pad // msize
    b, s, d = x.shape
    ba_size = _ba_size(ba, mesh)
    b_loc = b // ba_size
    s_loc = s // msize
    t_loc = b_loc * s_loc                       # tokens per DEVICE
    # per-(src,dst-rank) wire capacity and per-expert compute capacity,
    # both relative to the REAL expert count e
    c2 = int(cf * t_loc * k * e_loc / e) + 1
    cap = int(cf * t_loc * k * msize / e) + 1   # rows/expert at receiver
    x_spec = spec(ba, m, None)
    w_spec, ws = _expert_weights(p, e, msize)

    def body(xb, router, gate_l, up_l, down_l):
        r = C.axis_index(mesh, m)
        gate_l, up_l, down_l = (_local_experts(w, e_pad, e_loc, r)
                                for w in (gate_l, up_l, down_l))
        bl, sl, _ = xb.shape
        xt = xb.reshape(bl * sl, d)
        tl = xt.shape[0]
        top_p, top_i, probs = _route(xt, router, k)
        top_p = top_p.to(xb.dtype)

        flat_expert = top_i.reshape(-1)                     # (tl*k,)
        dest = torch.div(flat_expert, e_loc, rounding_mode="floor")
        slot, order, slot_token, slot_w = _slot_pack(
            dest, msize, c2, tl, k, top_p)
        l1 = msize * c2
        valid1 = slot_token < tl
        send_x = _slot_rows(xt, slot_token, tl)
        send_eid = _scatter_slots(
            torch.full((l1 + 1,), e_pad, dtype=torch.int32,
                       device=xt.device), slot,
            flat_expert[order].to(torch.int32))

        # ship rows + expert ids to the owners
        recv_x = C.all_to_all(send_x.reshape(msize, c2, d), mesh, m)
        recv_eid = C.all_to_all(send_eid.reshape(msize, c2), mesh, m)
        recv_x = recv_x.reshape(msize * c2, d)
        recv_eid = recv_eid.reshape(msize * c2)

        # receiver-side per-expert packing (local expert ids)
        local_id = recv_eid - r * e_loc
        is_local = ((local_id >= 0) & (local_id < e_loc)
                    & (recv_eid < e_pad))
        key2 = torch.where(is_local, local_id, e_loc)
        order2 = torch.argsort(key2, stable=True)
        sorted2 = key2[order2]
        gsz2 = _counts(sorted2, e_loc)
        starts2 = torch.cumsum(gsz2, 0) - gsz2
        pos2 = (torch.arange(sorted2.shape[0], device=xt.device)
                - starts2[sorted2.clamp(0, e_loc - 1)])
        keep2 = (sorted2 < e_loc) & (pos2 < cap)
        slot2 = torch.where(keep2, sorted2 * cap + pos2, e_loc * cap)
        slot2_row = _scatter_slots(
            torch.full((e_loc * cap + 1,), msize * c2, dtype=torch.int32,
                       device=xt.device), slot2, order2.to(torch.int32))
        xs = _slot_rows(recv_x, slot2_row, msize * c2).reshape(
            e_loc, cap, d)
        y = _experts_ffn(xs, gate_l, up_l, down_l).reshape(e_loc * cap, d)

        # scatter back to wire layout, return all_to_all, combine at sender
        y_wire = _combine(y, slot2_row, y.new_ones((e_loc * cap,)),
                          msize * c2)
        back = C.all_to_all(y_wire.reshape(msize, c2, d), mesh, m)
        back = back.reshape(msize * c2, d)
        out = _combine(back, torch.where(valid1, slot_token, tl), slot_w,
                       tl).reshape(bl, sl, d)
        aux = _aux_loss(probs, top_i, e)
        aux = C.psum(aux, mesh, ba) / C.axis_size(mesh, ba)
        aux = C.psum(aux, mesh, m) / C.axis_size(mesh, m)
        return out, aux

    return local_call(body, (x_spec, spec(None, None), w_spec, w_spec,
                             w_spec), [x_spec, ()],
                      x, p["router"], *ws)


def moe_block(p: dict, x: torch.Tensor, cfg) -> tuple:
    """x: (B, S, d) -> (out, aux_loss). params: router (d, E) float32,
    experts_gate/experts_up (E, d, ff), experts_down (E, ff, d). Under an
    active mesh (and not pure FSDP), the reference's sharded dispatch:
    all-to-all where ``cfg.moe_dispatch == "a2a"`` and the sequence and
    batch divide, else allgather."""
    mesh = _active_mesh()
    if mesh is None or current_rules().pure_fsdp:
        # ZeRO-3 mode has no model axis for experts: the local formulation
        return _moe_local(p, x, cfg)
    r = current_rules()
    if (cfg.moe_dispatch == "a2a"
            and x.shape[1] % C.axis_size(mesh, r.model_axis) == 0
            and x.shape[0] % _ba_size(r.batch_axes, mesh) == 0):
        return _moe_sharded_a2a(p, x, cfg, mesh)
    return _moe_sharded(p, x, cfg, mesh)
