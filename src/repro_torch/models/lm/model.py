"""Model zoo: parameter init and the forward pass for every assigned
architecture family; the port of ``repro.models.lm.model``.

Parameters keep the reference's tree: each layer stack is one tensor per
weight with a leading layer axis (hybrid: super-block, then layer), and
the forward walks that axis in a Python loop where the reference scans.
It takes the layers with one ``unbind(0)`` a stacked leaf, so that the
backward stacks each leaf's gradient once (indexing a layer at a time
would add a zero tensor of the whole stack for every layer). With
``cfg.remat`` each block runs under ``torch.utils.checkpoint`` where the
reference wraps it in ``jax.checkpoint``: its activations are recomputed
in the backward, with the same bits, since the forward draws no random
numbers. The token embedding is a :func:`~repro_torch.kernels.keyed_rows`
gather: on the card its gradient is K2 over the token ids in a fixed
order, not float atomics.

Hybrid (Zamba2-style) models run super-blocks of ``hybrid_attn_every``
Mamba2 layers, each followed by one *shared-weight* attention+MLP block,
then the ``tail_blocks`` left over when the depth is not a multiple.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ...kernels import keyed_rows
from ...optim.optimizers import tree_leaves, tree_map
from ...sharding import collectives as C
from ...sharding.rules import (_active_mesh, batch_spec, current_rules,
                               fit, local_call, maybe_constrain, spec)
from .config import LMConfig, torch_dtype
from .layers import attn_block, mlp_block, rmsnorm
from .moe import moe_block
from .ssm import mamba2_block

# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------


def layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree: every leaf indexed on its leading
    axis (views, no copy)."""
    return tree_map(lambda t: t[i], tree)


def unstack(tree: Any) -> list:
    """The layers of a stacked tree, every leaf split with one
    ``unbind(0)`` (views, no copy; the backward stacks once)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [unstack(v) for v in tree]
        return [[v[i] for v in parts] for i in range(len(parts[0]))]
    return list(tree.unbind(0))


def num_stacked(tree: Any) -> int:
    """The length of a stacked tree's leading axis."""
    return tree_leaves(tree)[0].shape[0]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class _Init:
    """Draws the parameters from one generator, in float32 scaled by
    1/sqrt(fan_in) (or ``scale``) and then cast, as the reference's
    ``_dense_init``; on the generator's device, or on ``device`` (fake
    tensors, drawn from nothing)."""

    def __init__(self, gen: torch.Generator, dtype: torch.dtype,
                 device=None):
        self.gen, self.dtype = gen, dtype
        self.device = torch.device(device or gen.device)

    def dense(self, shape, dtype=None, scale=None) -> torch.Tensor:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = scale or 1.0 / math.sqrt(fan_in)
        if self.device == self.gen.device:
            x = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                            device=self.device)
        else:   # abstract_params: a fake tensor whose values none reads
            x = torch.empty(shape, dtype=torch.float32, device=self.device)
        return (x * scale).to(dtype or self.dtype)

    def zeros(self, shape, dtype=None) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype or self.dtype,
                           device=self.device)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, dtype=self.dtype, device=self.device)


def _stack(fn: Callable[[], Any], n: int) -> Any:
    """``n`` trees from ``fn`` stacked on a new leading axis, written one
    layer at a time into the stacked tensors (a full-width model never
    holds more than one layer's float32 draws)."""
    out = None
    for i in range(n):
        tree = fn()
        if out is None:
            out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)),
                           tree)
        tree_map(lambda o, t: o[i].copy_(t), out, tree)
    return out


def _attn_params(cfg: LMConfig, init: _Init) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = {"wq": init.dense((d, h * hd)), "wk": init.dense((d, kv * hd)),
         "wv": init.dense((d, kv * hd)), "wo": init.dense((h * hd, d))}
    if cfg.qkv_bias:
        p["bq"] = init.zeros((h * hd,))
        p["bk"] = init.zeros((kv * hd,))
        p["bv"] = init.zeros((kv * hd,))
    if cfg.qk_norm:
        p["q_norm"] = init.ones((hd,))
        p["k_norm"] = init.ones((hd,))
    return p


def _mlp_params(cfg: LMConfig, init: _Init, kind="swiglu") -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if kind == "swiglu":
        # gate|up fused on a size-2 middle axis: one product from the
        # shared input
        return {"w_gateup": init.dense((d, 2, f)),
                "w_down": init.dense((f, d))}
    return {"w_up": init.dense((d, f)), "b_up": init.zeros((f,)),
            "w_down": init.dense((f, d)), "b_down": init.zeros((d,))}


def _moe_params(cfg: LMConfig, init: _Init) -> dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    return {"router": init.dense((d, e), dtype=torch.float32),
            "experts_gate": init.dense((e, d, f)),
            "experts_up": init.dense((e, d, f)),
            "experts_down": init.dense((e, f, d))}


def _mamba_params(cfg: LMConfig, init: _Init) -> dict:
    d, di, n, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    cs = 1.0 / math.sqrt(cfg.ssm_conv)
    return {
        "in_proj": init.dense((d, 2 * di)),           # z | x
        "bc_proj": init.dense((d, 2 * n + h)),        # B | C | dt
        "conv_w": init.dense((cfg.ssm_conv, di), scale=cs),
        "conv_b": init.zeros((di,)),
        "conv_bc_w": init.dense((cfg.ssm_conv, 2 * n), scale=cs),
        "conv_bc_b": init.zeros((2 * n,)),
        "dt_bias": init.zeros((h,)),
        "a_log": init.zeros((h,), dtype=torch.float32),   # A = -exp(0) = -1
        "D": init.ones((h,)),
        "out_proj": init.dense((di, d)),
    }


def init_params(cfg: LMConfig, gen: torch.Generator, device=None) -> dict:
    """Random parameters in the reference's tree and shapes, drawn from
    ``gen`` on its device (the values are not the reference's: its key
    drives another generator) and placed on ``device`` (default: the
    generator's)."""
    init = _Init(gen, torch_dtype(cfg.dtype), device)
    d, v = cfg.d_model, cfg.padded_vocab
    params = {"embed": init.dense((v, d), scale=0.02 * math.sqrt(d)),
              "final_norm": init.ones((d,))}
    if not cfg.tie_embeddings:
        params["lm_head"] = init.dense((d, v))

    at = cfg.arch_type
    if at in ("dense", "vlm", "moe"):
        def one():
            blk = {"ln1": init.ones((d,)), "ln2": init.ones((d,)),
                   "attn": _attn_params(cfg, init)}
            if at == "moe":
                blk["moe"] = _moe_params(cfg, init)
            else:
                blk["mlp"] = _mlp_params(cfg, init)
            return blk
        params["blocks"] = _stack(one, cfg.num_layers)

    elif at == "ssm":
        params["blocks"] = _stack(
            lambda: {"ln1": init.ones((d,)),
                     "mamba": _mamba_params(cfg, init)}, cfg.num_layers)

    elif at == "hybrid":
        k_every = cfg.hybrid_attn_every
        n_super = cfg.num_layers // k_every
        n_tail = cfg.num_layers - n_super * k_every

        def one():
            return {"ln1": init.ones((d,)),
                    "mamba": _mamba_params(cfg, init)}
        params["blocks"] = _stack(lambda: _stack(one, k_every), n_super)
        if n_tail:
            params["tail_blocks"] = _stack(one, n_tail)
        params["shared"] = {
            "ln_a": init.ones((d,)), "ln_m": init.ones((d,)),
            "attn": _attn_params(cfg, init), "mlp": _mlp_params(cfg, init)}

    elif at == "audio":   # whisper backbone: encoder + causal decoder
        params["enc_blocks"] = _stack(
            lambda: {"ln1": init.ones((d,)), "ln2": init.ones((d,)),
                     "attn": _attn_params(cfg, init),
                     "mlp": _mlp_params(cfg, init, kind="gelu")},
            cfg.num_encoder_layers)
        params["enc_norm"] = init.ones((d,))
        params["blocks"] = _stack(
            lambda: {"ln1": init.ones((d,)), "ln_x": init.ones((d,)),
                     "ln2": init.ones((d,)),
                     "attn": _attn_params(cfg, init),
                     "xattn": _attn_params(cfg, init),
                     "mlp": _mlp_params(cfg, init, kind="gelu")},
            cfg.num_layers)
    else:
        raise ValueError(at)
    return params


def abstract_params(cfg: LMConfig, device="cpu") -> dict:
    """The parameter tree as fake tensors on ``device``: shapes and dtypes
    without memory (the dry-run's). Drawn from a CPU generator, so no
    card is needed for ``device="cuda"``; under the caller's
    ``FakeTensorMode`` if one is active, else a new one."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    gen = torch.Generator().manual_seed(0)
    if isinstance(_get_current_dispatch_mode(), FakeTensorMode):
        return init_params(cfg, gen, device)
    with FakeTensorMode():
        return init_params(cfg, gen, device)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The token embedding's rows, (B, S) -> (B, S, d):
    :func:`~repro_torch.kernels.keyed_rows`. On a DTensor table (a mesh
    active), each rank looks its tokens up in its slice of the vocabulary
    (sharded over "model", the batch over the batch axes), zeroes the
    rows it does not hold and sums over "model", as GSPMD gathers a
    vocabulary-sharded table; where the vocabulary is not sharded over
    an axis the batch is not, the table is gathered whole."""
    r = current_rules()
    m = r.model_axis
    mesh = _active_mesh()
    if mesh is None or not isinstance(table, DTensor):
        return keyed_rows(table, tokens)
    vocab = None
    if (not r.pure_fsdp and m not in r.batch_axes
            and table.shape[0] % mesh[m].size() == 0):
        vocab = m

    def body(tab, tok):
        lo = C.axis_index(mesh, vocab) * tab.shape[0] if vocab else 0
        local = tok.long() - lo
        inside = (local >= 0) & (local < tab.shape[0])
        rows = keyed_rows(tab, local.clamp(0, tab.shape[0] - 1))
        rows = torch.where(inside[..., None], rows, 0)
        return C.psum(rows, mesh, vocab) if vocab else rows
    tspec = fit(batch_spec(None), tokens.shape)
    return local_call(body, (spec(vocab, None), tspec), tspec + (None,),
                      table, tokens)


# ---------------------------------------------------------------------------
# forward (scoring)
# ---------------------------------------------------------------------------

def _constrain_act(x):
    """Block-boundary activation sharding (the identity without a mesh).

    Megatron sequence parallelism: the (B, S, D) residual stream is sharded
    over "model" on the *sequence* dim between blocks (norm/residual are
    elementwise), so per-layer remat residuals shrink by the model-axis
    size; each block's first product gathers it (:func:`mm`) and its last
    one's partial sums are scattered back here. Falls back to the batch
    spec when S doesn't divide (whisper's 1500-frame encoder, one-token
    decode)."""
    r = current_rules()
    if (r.seq_shard_activations and x.ndim >= 3
            and x.shape[1] % r.model_axis_size == 0):
        return maybe_constrain(x, spec(r.batch_axes, r.model_axis, None))
    return maybe_constrain(x, batch_spec(None, None))


def _dense_block(cfg: LMConfig, bp: dict, x, positions, window):
    # norm outputs and sub-block outputs are pinned to the
    # sequence-parallel spec, as the reference pins them
    o = attn_block(bp["attn"],
                   _constrain_act(rmsnorm(x, bp["ln1"], cfg.norm_eps)), cfg,
                   positions=positions, window=window)
    h = x + _constrain_act(o)
    hn = _constrain_act(rmsnorm(h, bp["ln2"], cfg.norm_eps))
    if "moe" in bp:
        ff, aux = moe_block(bp["moe"], hn, cfg)
    else:
        ff = mlp_block(bp["mlp"], hn, kind="swiglu")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _constrain_act(h + _constrain_act(ff)), aux


def _mamba_layer(cfg: LMConfig, bp: dict, x):
    out, _, _ = mamba2_block(bp["mamba"],
                             rmsnorm(x, bp["ln1"], cfg.norm_eps), cfg)
    # sub-block outputs (partial sums on a mesh) are placed before the
    # residual add, as in _dense_block, so that their gradients arrive
    # gathered
    return _constrain_act(x + _constrain_act(out))


def _shared_attn_block(cfg: LMConfig, sp: dict, x, positions, window):
    h = x + _constrain_act(attn_block(
        sp["attn"], rmsnorm(x, sp["ln_a"], cfg.norm_eps), cfg,
        positions=positions, window=window))
    return _constrain_act(h + _constrain_act(
        mlp_block(sp["mlp"], rmsnorm(h, sp["ln_m"], cfg.norm_eps))))


def _remat(cfg: LMConfig, fn: Callable, *args):
    """``fn(*args)``, recomputed in the backward when ``cfg.remat`` (the
    block's parameters are among ``args``, so their gradients flow)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _audio_decoder_block(cfg: LMConfig, bp: dict, x, positions, window, enc,
                         enc_pos):
    x = x + _constrain_act(attn_block(
        bp["attn"], rmsnorm(x, bp["ln1"], cfg.norm_eps), cfg,
        positions=positions, window=window))
    x = x + _constrain_act(attn_block(
        bp["xattn"], rmsnorm(x, bp["ln_x"], cfg.norm_eps), cfg,
        positions=positions, context=enc, context_positions=enc_pos))
    return _constrain_act(x + _constrain_act(mlp_block(
        bp["mlp"], rmsnorm(x, bp["ln2"], cfg.norm_eps), kind="gelu")))


def lm_head(cfg: LMConfig, params: dict) -> torch.Tensor:
    """(d, padded_vocab): the tied embedding's transpose or ``lm_head``."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(cfg: LMConfig, params: dict, tokens: torch.Tensor, *,
            image_embeds: Optional[torch.Tensor] = None,
            encoder_embeds: Optional[torch.Tensor] = None,
            window: Optional[int] = None,
            return_hidden: bool = False) -> tuple:
    """tokens: (B, S) int -> (logits (B, S_total, padded_vocab),
    aux_loss).

    ``return_hidden=True`` skips the head and returns the final-normed
    hidden state (B, S_total, d) instead of the logits: the training loss
    projects it a chunk at a time.

    vlm: image_embeds (B, n_img, d) are prepended. audio: encoder_embeds
    (B, S_enc, d) go through the encoder stack, and the decoder
    cross-attends to them.

    ``window`` overrides the config's sliding window for this call (the
    self-attention of every block; the audio encoder and the
    cross-attention stay unwindowed). Each rematerialised block takes it
    as an argument, so its recompute masks as its forward did."""
    window = window if window is not None else cfg.sliding_window
    x = embed_tokens(params["embed"], tokens)
    if cfg.arch_type == "vlm":
        if image_embeds is None:
            raise ValueError("a vlm forward needs image_embeds")
        x = torch.cat([image_embeds.to(x.dtype), x], dim=1)
    x = _constrain_act(x)
    positions = torch.arange(x.shape[1], device=x.device)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    at = cfg.arch_type
    blocks = params["blocks"]

    def mamba(bp, h):
        return _mamba_layer(cfg, bp, h)

    if at in ("dense", "vlm", "moe"):
        def dense(bp, h, window):
            return _dense_block(cfg, bp, h, positions, window)
        for bp in unstack(blocks):
            x, a = _remat(cfg, dense, bp, x, window)
            aux_total = aux_total + a

    elif at == "ssm":
        for bp in unstack(blocks):
            x = _remat(cfg, mamba, bp, x)

    elif at == "hybrid":
        def shared(sp, h, window):
            return _shared_attn_block(cfg, sp, h, positions, window)
        for sbp in unstack(blocks):
            for bp in unstack(sbp):
                x = _remat(cfg, mamba, bp, x)
            x = _remat(cfg, shared, params["shared"], x, window)
        tail = params.get("tail_blocks")
        for bp in (unstack(tail) if tail is not None else []):
            x = _mamba_layer(cfg, bp, x)        # not rematerialised

    elif at == "audio":
        if encoder_embeds is None:
            raise ValueError("an audio forward needs encoder_embeds")
        enc = _constrain_act(encoder_embeds.to(x.dtype))
        enc_pos = torch.arange(enc.shape[1], device=x.device)
        for bp in unstack(params["enc_blocks"]):  # not rematerialised
            enc = enc + _constrain_act(attn_block(
                bp["attn"], rmsnorm(enc, bp["ln1"], cfg.norm_eps), cfg,
                positions=enc_pos, causal=False))
            enc = _constrain_act(enc + _constrain_act(mlp_block(
                bp["mlp"], rmsnorm(enc, bp["ln2"], cfg.norm_eps),
                kind="gelu")))
        enc = rmsnorm(enc, params["enc_norm"], cfg.norm_eps)

        def decoder(bp, h, enc, window):
            return _audio_decoder_block(cfg, bp, h, positions, window, enc,
                                        enc_pos)
        for bp in unstack(blocks):
            x = _remat(cfg, decoder, bp, x, enc, window)
    else:
        raise ValueError(at)

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    aux = aux_total / max(cfg.num_layers, 1)
    if return_hidden:
        return x, aux
    return x @ lm_head(cfg, params), aux
