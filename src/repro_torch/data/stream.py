"""Token data pipeline for the LM architectures; the port of
``repro.data.stream``.

DistDGLv2's pipelining carried over to sequence models: host-side batch
assembly runs through the same :class:`AsyncPipeline` (schedule ->
assemble -> host prefetch -> device prefetch, per-stage bounded queues,
non-stop across epochs), so the card never waits on the input pipeline.
The owner-compute split maps to per-host sharding of the sample stream.

Sources: a synthetic structured-token generator (the default: token
streams with learnable n-gram structure, so that loss curves mean
something) or a memory-mapped int32 token file. The tokens, and the vlm /
audio stub embeddings, are the reference's bytes for the same seed,
``host_index`` and ``host_count`` (its bytes with ``sync=True``).

One generator draws a batch's tokens and then its stub embeddings. The
reference draws the embeddings in its host-prefetch stage, on another
thread than the tokens, so that with the async pipeline the bytes of a
vlm / audio stream depend on the threads' timing; the port draws both in
the assemble stage, in the order of the reference's synchronous run, and
its host-prefetch stage packs the batch into one pinned host arena.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from ..core.pipeline import AsyncPipeline, Stage
from ..kernels.pack import host_stage


def _synthetic_tokens(rng: np.random.Generator, vocab: int, n: int,
                      order: int = 2, alpha: float = 0.9) -> np.ndarray:
    """Markov-ish stream: next token depends on the previous one (a learnable
    structure; uniform random tokens would give a flat loss)."""
    # deterministic per-token successor table
    table_rng = np.random.default_rng(12345)
    succ = table_rng.integers(0, vocab, size=(vocab, 4))
    out = np.empty(n, dtype=np.int32)
    out[0] = rng.integers(0, vocab)
    picks = rng.integers(0, 4, size=n)
    noise = rng.random(n)
    rand = rng.integers(0, vocab, size=n)
    for i in range(1, n):
        out[i] = succ[out[i - 1], picks[i]] if noise[i] < alpha else rand[i]
    return out


class TokenStream:
    """Iterator of LM batches on ``device`` through the async pipeline:
    dicts of "tokens" (B, S) int32 and, for a vlm / audio ``cfg``, its
    float32 "image_embeds" / "encoder_embeds"."""

    def __init__(self, vocab: int, batch: int, seq: int, *, cfg=None,
                 seed: int = 0, host_index: int = 0, host_count: int = 1,
                 sync: bool = False, file: Optional[str] = None,
                 depths: Optional[dict] = None, packed: bool = True,
                 device="cuda"):
        self.vocab = vocab
        self.batch = batch
        self.seq = seq
        self.cfg = cfg
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed + 7919 * host_index)
        self.host_index = host_index
        self.host_count = host_count
        self.file = None
        if file is not None:
            self.file = np.memmap(file, dtype=np.int32, mode="r")
        # packed=True: one copy a batch (kernels.pack); False: one an array
        self.packed = packed
        d = {"assemble": 8, "host_prefetch": 4, "device_prefetch": 1}
        d.update(depths or {})
        stages = [
            Stage("assemble", self._assemble, depth=d["assemble"]),
            Stage("host_prefetch", self._host_prefetch,
                  depth=d["host_prefetch"]),
            Stage("device_prefetch", self._device_prefetch,
                  depth=d["device_prefetch"]),
        ]
        self._pipe = AsyncPipeline(self._schedule(), stages, sync=sync,
                                   name="tokenstream")
        self._it = iter(self._pipe)

    # ---- stages -------------------------------------------------------
    def _schedule(self) -> Iterator[int]:
        i = self.host_index          # owner-compute split over hosts
        while True:
            yield i
            i += self.host_count

    def _assemble(self, index: int) -> dict:
        n = self.batch * self.seq
        if self.file is not None:
            total = len(self.file) - n - 1
            off = int(self.rng.integers(0, max(total, 1)))
            toks = np.asarray(self.file[off:off + n], dtype=np.int32)
        else:
            toks = _synthetic_tokens(self.rng, self.vocab, n)
        batch = {"tokens": toks.reshape(self.batch, self.seq)}
        cfg = self.cfg
        if cfg is not None and cfg.arch_type == "vlm":
            batch["image_embeds"] = self.rng.standard_normal(
                (self.batch, cfg.num_image_tokens, cfg.d_model)
            ).astype(np.float32)
        if cfg is not None and cfg.arch_type == "audio":
            batch["encoder_embeds"] = self.rng.standard_normal(
                (self.batch, cfg.encoder_seq, cfg.d_model)
            ).astype(np.float32)
        return batch

    def _host_prefetch(self, batch: dict):
        if self.packed:
            return host_stage(batch, pin=self.device.type == "cuda")
        return batch

    def _device_prefetch(self, batch) -> dict:
        if self.packed:
            # LM steps index the dict directly: a flat mapping of views
            # into the one staged arena
            return batch.to(self.device).unpack()
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    # ---- iteration ----------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)

    def stop(self):
        self._pipe.stop()
