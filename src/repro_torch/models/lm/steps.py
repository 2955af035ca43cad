"""Train and serve step functions for the LM zoo; the port of
``repro.models.lm.steps``.

``make_train_step`` returns
    step(params, opt_state, batch) -> (params, opt_state, metrics)
with next-token cross-entropy (+ MoE aux loss), global-norm clipping and
AdamW. ``batch`` carries "tokens" (B, S) plus per-family extras
("image_embeds" for vlm, "encoder_embeds" for audio) and an optional
"loss_mask". ``make_prefill_step`` / ``make_decode_step`` wrap
:func:`~.decode.prefill` / :func:`~.decode.decode_step`.

The reference's step is a pure function that holds the old and the new
parameters and moments and the float32 clipped gradients at once, about
26 bytes a parameter. The port's step computes the same values but writes
them into the parameter and moment tensors it was given, a slice of a leaf
at a time, so that it needs the parameters, their gradients and the two
float32 moments (12 bytes a parameter in bfloat16) and one slice's
temporaries: what lets a 3.3 B-parameter model train on one 80 GB card.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ...optim.optimizers import (AdamWState, adamw_init, adamw_update,
                                 clip_scale, global_norm, tree_leaves,
                                 tree_map)
from ...sharding import collectives as C
from ...sharding.rules import (_active_mesh, current_rules, fit,
                               local_call, spec)
from .config import LMConfig
from .decode import decode_step, prefill
from .model import forward, init_params, lm_head

CE_CHUNK = 512
# elements of a leaf that the optimizer updates at a time (its float32
# temporaries are a few times 128 MiB)
UPDATE_SLICE = 1 << 25


def _ce_chunk(hc, head, tc, mc):
    logits = (hc @ head).float()
    lse = torch.logsumexp(logits, dim=-1)
    tl = logits.gather(-1, tc[..., None].long())[..., 0]
    return ((lse - tl) * mc).sum()


def _ce_chunk_sharded(hc, head, tc, mc, mesh, vocab_axis):
    """:func:`_ce_chunk` on one rank's shards: ``head`` holds this rank's
    slice of the vocabulary on ``vocab_axis`` (all of it where that is
    ``None``: then it is :func:`_ce_chunk` itself); the logsumexp and the
    target logit sum over the vocabulary's ranks."""
    if vocab_axis is None:
        return _ce_chunk(hc, head, tc, mc)
    logits = (hc @ head).float()                    # (b, c, V / ranks)
    v = logits.shape[-1]
    mx = C.pmax(logits.detach().amax(-1), mesh, vocab_axis)
    lse = torch.log(C.psum(torch.exp(logits - mx[..., None]).sum(-1), mesh,
                           vocab_axis)) + mx
    local = tc.long() - C.axis_index(mesh, vocab_axis) * v
    inside = (local >= 0) & (local < v)
    tl = logits.gather(-1, local.clamp(0, v - 1)[..., None])[..., 0]
    tl = C.psum(torch.where(inside, tl, 0.0), mesh, vocab_axis)
    return ((lse - tl) * mc).sum()


def _chunked_ce(hidden: torch.Tensor, head: torch.Tensor, tgt: torch.Tensor,
                mask: torch.Tensor, chunk: int = CE_CHUNK,
                ce=_ce_chunk) -> torch.Tensor:
    """Softmax cross-entropy fused with the head projection, a chunk of
    ``chunk`` positions at a time: the (B, S, vocab) logits never exist,
    only one (B, chunk, vocab) float32 slice, and each chunk runs under
    ``torch.utils.checkpoint`` so that its logits are recomputed in the
    backward, not stored. Positions padded up to a whole chunk have mask
    0; the chunks' sums are added in chunk order.

    On DTensors (a mesh active), the reference's (batch, None, vocab over
    "model") logits: the whole loop runs on each rank's shards, each rank
    projecting its rows onto its slice of the vocabulary, and the total
    is summed over the batch's ranks."""
    mesh = _active_mesh()
    if mesh is not None and isinstance(hidden, DTensor):
        r = current_rules()
        m = None if r.pure_fsdp else r.model_axis
        if m is not None and (mesh[m].size() == 1
                              or head.shape[1] % mesh[m].size()):
            m = None
        bspec = fit(spec(r.batch_axes, None), hidden.shape)

        def body(h, hd, t, mk):
            part = functools.partial(_ce_chunk_sharded, mesh=mesh,
                                     vocab_axis=m)
            return C.psum(_chunked_ce(h, hd, t, mk, chunk, part), mesh,
                          bspec[0] or ())
        return local_call(body, (bspec + (None,), spec(None, m), bspec,
                                 bspec), (), hidden, head, tgt, mask)
    s = hidden.shape[1]
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        tgt = F.pad(tgt, (0, pad))
        mask = F.pad(mask, (0, pad))
    total = None
    for start in range(0, s + pad, chunk):
        sl = slice(start, start + chunk)
        part = checkpoint(ce, hidden[:, sl], head, tgt[:, sl],
                          mask[:, sl], use_reentrant=False,
                          preserve_rng_state=False)
        total = part if total is None else total + part
    return total


def lm_loss(cfg: LMConfig, params: dict, batch: dict) -> tuple:
    """-> (loss, {"ce", "aux", "ppl_proxy"}): next-token cross-entropy on
    the text positions (a vlm's image prefix is not predicted), over
    ``loss_mask[:, 1:]`` when the batch has one, plus the MoE aux loss
    times ``router_aux_coef``."""
    tokens = batch["tokens"]
    hidden, aux = forward(cfg, params, tokens,
                          image_embeds=batch.get("image_embeds"),
                          encoder_embeds=batch.get("encoder_embeds"),
                          return_hidden=True)
    n_img = cfg.num_image_tokens if cfg.arch_type == "vlm" else 0
    pred_h = hidden[:, n_img:-1]
    tgt = tokens[:, 1:]
    mask = batch.get("loss_mask")
    mask = (torch.ones(tgt.shape, dtype=torch.float32, device=tgt.device)
            if mask is None else mask[:, 1:].to(torch.float32))
    total = _chunked_ce(pred_h, lm_head(cfg, params), tgt, mask)
    ce = total / torch.clamp(mask.sum(), min=1.0)
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"ce": ce, "aux": aux,
                  "ppl_proxy": torch.exp(torch.clamp(ce, max=20.0))}


def loss_and_grads(cfg: LMConfig, params: dict, batch: dict) -> tuple:
    """-> ((loss, metrics), grads): ``lm_loss`` and its gradients with
    respect to every leaf of ``params``, in the parameters' types. The
    gradients are taken through detached aliases of the leaves, so any
    tensors will do (after an optimizer step none requires a gradient)."""
    alias = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = lm_loss(cfg, alias, batch)
        leaves = tree_leaves(alias)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    it = iter(grads)
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_map(lambda _: next(it), alias))


def _microbatch(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    rows = x.shape[0] // n
    return x[i * rows:(i + 1) * rows]


@torch.no_grad()
def adamw_update_(params, grad_leaves: list, opt_state: AdamWState,
                  scale: torch.Tensor, *, lr: float, weight_decay: float
                  ) -> AdamWState:
    """One AdamW step on the gradients ``grad_leaves`` (``params``' leaves'
    order) times the clipping factor ``scale``, written into ``params``
    and ``opt_state``'s moments -> the new state. Each leaf goes
    ``UPDATE_SLICE`` elements at a time through the reference's arithmetic
    (``clip_by_global_norm``'s float32 product, then
    :func:`adamw_update`), so the values are the functional update's; each
    gradient is dropped from ``grad_leaves`` once its leaf is done.

    On DTensors each rank updates its own shards: a gradient is first
    placed as its parameter is (a reduce-scatter of a partial sum), and
    the scale, a replicated scalar, is read whole."""
    if isinstance(scale, DTensor):
        scale = scale.full_tensor()
    grad_leaves.reverse()
    for p, m, v in zip(tree_leaves(params), tree_leaves(opt_state.mu),
                       tree_leaves(opt_state.nu)):
        g = grad_leaves.pop()
        if isinstance(p, DTensor):
            g = g.redistribute(p.device_mesh, p.placements).to_local()
            p, m, v = p.to_local(), m.to_local(), v.to_local()
        g = g.reshape(-1)
        flat = [t.view(-1) for t in (p, m, v)]      # views: written back
        for start in range(0, g.numel(), UPDATE_SLICE):
            ps, ms, vs = (t[start:start + UPDATE_SLICE] for t in flat)
            new_p, st = adamw_update(
                ps, g[start:start + UPDATE_SLICE].to(torch.float32) * scale,
                AdamWState(opt_state.step, ms, vs), lr=lr,
                weight_decay=weight_decay)
            ps.copy_(new_p)
            ms.copy_(st.mu)
            vs.copy_(st.nu)
        del g
    return AdamWState(opt_state.step + 1, opt_state.mu, opt_state.nu)


def make_train_step(cfg: LMConfig, lr: float = 3e-4, clip: float = 1.0,
                    weight_decay: float = 0.1, microbatches: int = 1):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the reference's step, which updates ``params`` and the moments in
    place and returns them (see the module's docstring).

    ``microbatches > 1`` splits every batch entry into that many
    contiguous row slices and sums their gradients in float32 in slice
    order, then divides and casts them to the parameters' types; the loss
    and metrics are the slices' means. Activation memory scales with the
    tokens of one slice."""
    def step(params, opt_state, batch):
        if microbatches == 1:
            (loss, metrics), grads = loss_and_grads(cfg, params, batch)
        else:
            gsum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            mets = []
            for i in range(microbatches):
                part = {k: _microbatch(v, i, microbatches)
                        for k, v in batch.items()}
                (l, met), g = loss_and_grads(cfg, params, part)
                gsum = tree_map(lambda a, gg: a + gg.to(torch.float32),
                                gsum, g)
                lsum = lsum + l
                mets.append(met)
                del g
            grads = tree_map(lambda g, p: (g / microbatches).to(p.dtype),
                             gsum, params)
            del gsum
            loss = lsum / microbatches
            metrics = {k: torch.stack([m[k] for m in mets]).mean(dim=0)
                       for k in mets[0]}
        gn = global_norm(grads)
        leaves = tree_leaves(grads)
        del grads
        opt_state = adamw_update_(params, leaves, opt_state,
                                  clip_scale(gn, clip), lr=lr,
                                  weight_decay=weight_decay)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gn)
    return step


def init_train_state(cfg: LMConfig, seed: int = 0, device="cuda") -> tuple:
    """(params, AdamW state) on ``device``, the parameters drawn from a
    generator seeded ``seed`` there (not the reference's values: JAX's
    random bits are not reproduced)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen)
    return params, adamw_init(params)


def make_prefill_step(cfg: LMConfig, cache_len: int):
    def prefill_step(params, batch):
        return prefill(cfg, params, batch["tokens"], cache_len,
                       image_embeds=batch.get("image_embeds"),
                       encoder_embeds=batch.get("encoder_embeds"))
    return prefill_step


def make_decode_step(cfg: LMConfig):
    def serve_step(params, cache, tokens):
        return decode_step(cfg, params, cache, tokens)
    return serve_step
