"""Batched serving on PyTorch: prefill + streaming decode with the
ring-buffer KV cache, across three architecture families (dense / SSM /
hybrid) to show the serve path is family-generic. The loop is
``examples/serve_batched.py``'s (each id at its reduced same-family
width), on the card unless ``--device cpu`` is given. Each line ends with
the mean negative log-likelihood the model gives its own greedy tokens.

Run:  PYTHONPATH=src python examples/serve_batched_torch.py [--smoke]
          [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.api.inference import resolve_device
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models.lm import (init_params, make_decode_step,
                                   make_prefill_step, torch_dtype)

ARCHS = ("qwen2-0.5b", "mamba2-2.7b", "zamba2-7b")


def serve(arch, batch=4, prompt_len=32, gen=16, device="cuda"):
    cfg = smoke_variant(get_config(arch))
    rng = np.random.default_rng(0)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    cache_len = prompt_len + gen + 8
    b = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len)), device=device)}
    if cfg.arch_type == "vlm":
        b["image_embeds"] = torch.as_tensor(rng.standard_normal(
            (batch, cfg.num_image_tokens, cfg.d_model)),
            device=device).to(torch_dtype(cfg.dtype))
        cache_len += cfg.num_image_tokens
    if cfg.arch_type == "audio":
        b["encoder_embeds"] = torch.as_tensor(rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)),
            device=device).to(torch_dtype(cfg.dtype))

    prefill = make_prefill_step(cfg, cache_len)
    decode = make_decode_step(cfg)
    nll = []

    def greedy(logits):
        logits = logits[:, :cfg.vocab_size].float()
        tok = logits.argmax(-1)[:, None]
        nll.append(-torch.log_softmax(logits, -1).gather(-1, tok))
        return tok

    with torch.no_grad():
        logits, cache = prefill(params, b)
        tok = greedy(logits)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.time()
        toks = [tok]
        for _ in range(gen - 1):
            logits, cache = decode(params, cache, tok)
            tok = greedy(logits)
            toks.append(tok)
        seq = torch.cat(toks, dim=1).cpu().numpy()
    dt = time.time() - t0
    mean_nll = float(torch.cat(nll).mean())
    print(f"{arch:22s} [{cfg.arch_type:6s}] {batch}x{gen} tokens "
          f"in {dt:.2f}s -> {seq[0][:10].tolist()} nll={mean_nll:.4f}")
    assert np.isfinite(mean_nll), f"{arch}: non-finite logits"
    return mean_nll


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configuration for CI smoke runs")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs; cuda raises without a card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    shape = (dict(batch=2, prompt_len=16, gen=8) if args.smoke
             else dict(batch=4, prompt_len=32, gen=16))
    return {arch: serve(arch, device=device, **shape) for arch in ARCHS}


if __name__ == "__main__":
    main()
