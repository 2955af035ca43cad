"""Fake-tensor stand-ins for every (architecture × input shape) pair;
the port of ``repro.launch.input_specs``: the shapes and dtypes of the
reference's ``ShapeDtypeStruct``s, with no memory behind them.

Input shapes (assigned):
    train_4k     seq=4096    global_batch=256   -> train_step
    prefill_32k  seq=32768   global_batch=32    -> prefill_step
    decode_32k   seq=32768   global_batch=128   -> serve_step (1 token,
                                                  KV/SSM cache of seq)
    long_500k    seq=524288  global_batch=1     -> serve_step; sub-quadratic
                                                  attention required (dense
                                                  archs switch to a sliding
                                                  window; SSM/hybrid native)

For vlm the image patch stub occupies ``num_image_tokens`` of the sequence
budget; for audio the encoder consumes the stubbed frame embeddings and the
decoder consumes ``seq`` tokens.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import _get_current_dispatch_mode

from ..models.lm.config import LMConfig, torch_dtype

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# sliding window used by quadratic-attention archs on long_500k
LONG_CONTEXT_WINDOW = 8192


def needs_window(cfg: LMConfig, shape_name: str) -> bool:
    """Dense/MoE/VLM/audio attention is quadratic — long_500k runs their
    sliding-window variant. SSM is attention-free; hybrid's shared
    attention also gets the window."""
    return shape_name == "long_500k" and cfg.arch_type != "ssm"


def effective_window(cfg: LMConfig, shape_name: str) -> Optional[int]:
    if needs_window(cfg, shape_name):
        return LONG_CONTEXT_WINDOW
    return cfg.sliding_window


def cache_len_for(cfg: LMConfig, shape_name: str) -> int:
    seq = SHAPES[shape_name]["seq"]
    w = effective_window(cfg, shape_name)
    return min(seq, w) if w else seq


def fake_mode():
    """The active ``FakeTensorMode``'s context (a no-op), or a new one."""
    if isinstance(_get_current_dispatch_mode(), FakeTensorMode):
        return contextlib.nullcontext()
    return FakeTensorMode()


def input_specs(cfg: LMConfig, shape_name: str, device="cpu") -> dict:
    """{"kind", and "batch" (train, prefill) or "cache" and "tokens"
    (decode), "cache_len" (serving)}: fake tensors on ``device``."""
    info = SHAPES[shape_name]
    b, s = info["batch"], info["seq"]
    kind = info["kind"]
    dt = torch_dtype(cfg.dtype)

    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    def batch_for(seq_len):
        batch = {"tokens": sds((b, seq_len), torch.int32)}
        if cfg.arch_type == "vlm":
            batch["tokens"] = sds((b, seq_len - cfg.num_image_tokens),
                                  torch.int32)
            batch["image_embeds"] = sds(
                (b, cfg.num_image_tokens, cfg.d_model), dt)
        if cfg.arch_type == "audio":
            batch["encoder_embeds"] = sds(
                (b, cfg.encoder_seq, cfg.d_model), dt)
        return batch

    with fake_mode():
        if kind == "train":
            return {"kind": kind, "batch": batch_for(s)}
        if kind == "prefill":
            return {"kind": kind, "batch": batch_for(s),
                    "cache_len": cache_len_for(cfg, shape_name)}
        if kind == "decode":
            from ..models.lm.decode import init_cache
            w = cache_len_for(cfg, shape_name)
            return {"kind": kind, "cache": init_cache(cfg, b, w,
                                                      device=device),
                    "tokens": sds((b, 1), torch.int32), "cache_len": w}
    raise ValueError(kind)
