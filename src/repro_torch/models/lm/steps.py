"""Serve step functions for the LM zoo; the port of the serving half of
``repro.models.lm.steps``. ``make_prefill_step`` / ``make_decode_step``
wrap :func:`~.decode.prefill` / :func:`~.decode.decode_step`. LM training
(``lm_loss``, ``make_train_step``, ``init_train_state``) is not ported
yet: ROADMAP queue A item 10."""
from __future__ import annotations

from .config import LMConfig
from .decode import decode_step, prefill


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
