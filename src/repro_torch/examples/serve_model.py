"""Serve a (QAFeL-trained) model with batched prefill + greedy decode.

The port of ``examples/serve_model.py``: a reduced config with random
weights, the prompts from the reference's numpy stream, prefill and then
token by token through the caches: KV rings (``--window`` gives the
global layers a ring buffer too, the long-context serving mode) and
Mamba2's constant-size recurrent state. The default architecture is the
reference's, mamba2-1.3b; every architecture of the pool serves
(internvl2-1b's prompt counts its 16 reduced patch embeddings,
musicgen-large decodes its four codebooks a step, zamba2-7b's shared
attention block keeps a KV cache per use, qwen3-moe-235b-a22b and
deepseek-v3-671b route through their experts, deepseek's MLA layers cache
latents, its dense prefix layers included).

    PYTHONPATH=src python -m repro_torch.examples.serve_model \\
        [--arch mamba2-1.3b] [--window 32] [--device cpu]

Without ``--device`` it runs on the card and raises without CUDA.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs as config_registry
from repro_torch.common.device import resolve_device, to_device
from repro_torch.data.synthetic import synthetic_batch_for_config
from repro_torch.launch.serve import serve
from repro_torch.models import transformer as T


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--decode-steps", type=int, default=24)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    cfg = config_registry.get_reduced(args.arch)
    dev = resolve_device(args.device)
    params = T.init_params(cfg, 0, dev)
    rng = np.random.default_rng(0)
    batch = synthetic_batch_for_config(cfg, rng, args.batch, args.prompt_len)
    inputs = {k: to_device(torch.from_numpy(v), dev)
              for k, v in batch.items() if k != "labels"}
    out = serve(cfg, params, inputs, decode_steps=args.decode_steps,
                window=args.window)
    print(f"{cfg.arch_id}: prefill {args.batch}x{args.prompt_len} -> "
          f"logits {tuple(out['logits'].shape)}  ({out['prefill_s']:.2f}s)")
    dt = out["decode_s"]
    print(f"decoded {args.decode_steps} steps in {dt:.2f}s "
          f"({args.decode_steps * args.batch / dt:.1f} tok/s on "
          f"{dev.type.upper()})")
    print("sample stream:", out["tokens"][0].cpu().tolist()[:16])
    return out


if __name__ == "__main__":
    main()
