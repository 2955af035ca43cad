"""End-to-end driver on PyTorch: train a ~100M-parameter qwen2-family
model for a few hundred steps through the async token pipeline
(DistDGLv2's pipeline transferred to the LM data path), with a checkpoint
round trip. The loop is ``examples/train_100m_lm.py``'s, on the card
unless ``--device cpu`` is given; ``--smoke`` trains the reduced
same-family width for a few dozen steps.

Run:  PYTHONPATH=src python examples/train_100m_lm_torch.py [--steps 300]
          [--smoke] [--device cuda|cpu] [--ckpt DIR]
(without ``--ckpt`` the checkpoint goes to a temporary directory)
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.api.inference import resolve_device
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import get_config, smoke_variant
from repro_torch.data import TokenStream
from repro_torch.models.lm import init_train_state, make_train_step
from repro_torch.optim.optimizers import tree_leaves


def lm_config(smoke: bool):
    if smoke:
        return smoke_variant(get_config("qwen2-0.5b"))
    # ~100M-param member of the qwen2 family (same block structure as the
    # qwen2-0.5b config, scaled down: 8L, d=512, vocab 32k)
    return dataclasses.replace(
        get_config("qwen2-0.5b"), name="qwen2-100m",
        num_layers=8, d_model=512, num_heads=8, num_kv_heads=2, head_dim=64,
        d_ff=2048, vocab_size=32000, remat=False, dtype="float32",
        attn_chunk=128, fsdp=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=None,
                    help="training steps (300; 40 with --smoke)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (256; 64 with --smoke)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configuration for CI smoke runs")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs; cuda raises without a card")
    args = ap.parse_args(argv)
    steps = args.steps or (40 if args.smoke else 300)
    seq = args.seq or (64 if args.smoke else 256)
    every = 10 if args.smoke else 25
    device = resolve_device(args.device)

    cfg = lm_config(args.smoke)
    print(f"model: {cfg.name}  ~{cfg.param_count() / 1e6:.0f}M params "
          f"on {device}")
    step = make_train_step(cfg, lr=1e-3)
    params, opt = init_train_state(cfg, seed=0, device=device)
    stream = TokenStream(vocab=cfg.vocab_size, batch=args.batch, seq=seq,
                         cfg=cfg, seed=0, device=device)

    losses, t0 = [], time.time()
    try:
        for i, batch in enumerate(stream):
            if i >= steps:
                break
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            if (i + 1) % every == 0:
                tput = (i + 1) * args.batch * seq / (time.time() - t0)
                print(f"step {i + 1:4d}  loss={np.mean(losses[-every:]):.4f}"
                      f"  {tput:.0f} tok/s")
    finally:
        stream.stop()
    assert np.all(np.isfinite(losses)), "training diverged"
    assert losses[-1] < losses[0] * 0.8, "did not learn"

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = args.ckpt or tmp
        save_pytree(params, ckpt)
        params2 = load_pytree(params, ckpt)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                     tree_leaves(params2)))
        print(f"checkpoint round-trip OK -> {ckpt}")
    n = max(len(losses) // 10, 1)
    print(f"final loss {np.mean(losses[-n:]):.4f} "
          f"(start {np.mean(losses[:n]):.4f})")
    return {"losses": losses}


if __name__ == "__main__":
    main()
