"""LM serving launcher: batched prefill + decode with the ring-buffer
cache, on the card unless ``--device cpu`` is given. The port of
``repro/launch/serve.py``. This entry point serves TOKEN models only; GNN
serving lives in ``repro_torch.launch.gnn_serve`` (``--task gnn`` here
forwards there).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --smoke --batch 4 --prompt-len 64 --gen 32

The parameters are random, drawn from a generator seeded 0 on the
device; the prompt (and the vlm / audio stub embeddings) come from
``np.random.default_rng(0)`` as in the reference. Greedy decoding takes the
argmax; ``--temperature`` samples from a generator seeded 1 (deterministic
for the seed, not the reference's bits).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="LM/VLM/audio token serving (prefill + decode). "
                    "GNN serving: repro_torch.launch.gnn_serve or --task "
                    "gnn.")
    ap.add_argument("--task", choices=["lm", "gnn"], default="lm",
                    help="lm serves token models here; gnn forwards to "
                         "repro_torch.launch.gnn_serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs; cuda raises without a card")
    return ap


def make_batch(cfg, batch: int, prompt_len: int, device) -> dict:
    """The reference's serve batch: prompt tokens (int64 here), and the
    vlm patch / audio frame embeddings its stubbed frontends would give,
    all from ``np.random.default_rng(0)``."""
    from ..models.lm import torch_dtype

    rng = np.random.default_rng(0)
    dtype = torch_dtype(cfg.dtype)
    out = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
        dtype=torch.int64, device=device)}
    if cfg.arch_type == "vlm":
        out["image_embeds"] = torch.as_tensor(rng.standard_normal(
            (batch, cfg.num_image_tokens, cfg.d_model)), device=device
        ).to(dtype)
    if cfg.arch_type == "audio":
        out["encoder_embeds"] = torch.as_tensor(rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)), device=device).to(dtype)
    return out


def serve_cache_len(cfg, prompt_len: int, gen: int,
                    cache_len: int = 0) -> int:
    """``cache_len`` slots, by default the prompt, the generated tokens
    and 8 spare; a vlm's image prefix on top, as the reference counts."""
    n = cache_len or prompt_len + gen + 8
    return n + (cfg.num_image_tokens if cfg.arch_type == "vlm" else 0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params: dict, batch: dict, gen: int, cache_len: int,
             temperature: float = 0.0) -> dict:
    """Prefill ``batch`` and decode until ``gen`` tokens a row.

    Returns ``tokens`` (B, gen) int64, ``logits`` (the ``gen`` steps'
    (B, padded_vocab) logits, prefill's first), and ``prefill_s`` /
    ``decode_s``, wall times that end after the device has finished."""
    from ..models.lm import make_decode_step, make_prefill_step

    device = batch["tokens"].device
    prefill = make_prefill_step(cfg, cache_len)
    decode = make_decode_step(cfg)
    # seeded 1, as the reference seeds its sampling key
    gen_rng = torch.Generator(device=device).manual_seed(1)

    def sample(logits):
        logits = logits[:, :cfg.vocab_size]
        if temperature <= 0:
            return logits.argmax(-1)[:, None]
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen_rng)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    tok = sample(logits)
    out, steps = [tok], [logits]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = decode(params, cache, tok)
        tok = sample(logits)
        out.append(tok)
        steps.append(logits)
    _sync(device)
    return {"tokens": torch.cat(out, dim=1), "logits": steps,
            "prefill_s": t_prefill, "decode_s": time.perf_counter() - t0}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # GNN serving is a different launcher: forward before the LM flags
    # below reject the command line
    for i, a in enumerate(argv):
        if a == "--task=gnn" or (a == "--task" and
                                 argv[i + 1:i + 2] == ["gnn"]):
            from . import gnn_serve
            skip = 1 if a == "--task=gnn" else 2
            return gnn_serve.main(argv[:i] + argv[i + skip:])
    args = build_parser().parse_args(argv)

    from ..api.inference import resolve_device
    from ..configs import ARCH_IDS, get_config, smoke_variant
    from ..models.lm import init_params

    if args.arch not in ARCH_IDS:
        raise SystemExit(f"--arch {args.arch!r} is not an LM id "
                         f"({ARCH_IDS}); GNN serving: --task gnn")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    cache_len = serve_cache_len(cfg, args.prompt_len, args.gen,
                                args.cache_len)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    batch = make_batch(cfg, args.batch, args.prompt_len, device)
    res = generate(cfg, params, batch, args.gen, cache_len,
                   temperature=args.temperature)
    t_dec = res["decode_s"]
    gen = res["tokens"].cpu().numpy()
    print(f"[prefill] {args.batch}x{args.prompt_len} in "
          f"{res['prefill_s']:.2f}s")
    print(f"[decode]  {args.gen - 1} steps in {t_dec:.2f}s "
          f"({args.batch * (args.gen - 1) / max(t_dec, 1e-9):.1f} tok/s)")
    print("[sample generations]")
    for row in gen[:2]:
        print("  ", row[:24].tolist())
    return res


if __name__ == "__main__":
    main()
