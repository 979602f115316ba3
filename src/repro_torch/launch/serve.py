"""Serving launcher: batched prefill + greedy decode of a (QAFeL-trained)
model.

The port of ``repro/launch/serve.py``: prefill a batch of prompts, then
decode greedily through the per-layer caches (KV ring buffers for the
windowed layers; Mamba2's f32 SSM state and conv tail, whose size does
not grow with the prompt; MLA's latents). The tokens stay on the device
until the loop ends: no decode step waits on the host. Every
architecture of the pool: a VLM's prompt is its patch embeddings and then its text tokens
(``--prompt-len`` counts both, as in the reference, so it must exceed the
prefix), audio decodes (B, CB) codebook tokens a step, mamba2-1.3b and
zamba2-7b (whose one shared attention block keeps a KV cache per use)
carry their recurrent caches, qwen3-moe-235b-a22b and deepseek-v3-671b
decode through their experts at ``decode_capacity_factor`` (2.0 in the
published configs: one slot an expert at a batch of 4, so copies drop
where tokens share an expert, as in the reference), deepseek's prefix
layers and MLA layers holding their latents.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
        --reduced --batch 4 --prompt-len 64 --decode-steps 32 [--device cpu]

Without ``--device`` it runs on the card and raises without CUDA.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import configs as config_registry
from repro_torch.common.device import resolve_device, to_device
from repro_torch.data.synthetic import check_seq, synthetic_batch_for_config
from repro_torch.distributed.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as T


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, params, inputs: dict, *, decode_steps: int,
          window: Optional[int] = None, q_block: int = 512,
          kv_block: int = 512) -> dict:
    """Prefill the prompt ``inputs`` (on the parameters' device:
    ``tokens`` (B, S) int32, or (B, S, CB) for audio, and a VLM's
    ``patch_embeddings`` (B, P, D)), then decode ``decode_steps`` tokens
    greedily from position S' = P + S (the embedded length), the caches
    sized for S' + ``decode_steps`` positions. Returns ``logits`` (the
    prefill's, (B, 1, V) or (B, 1, CB, V)), ``cache``, ``tokens`` ((B, 1 +
    decode_steps) int32 on the device, or (B, 1 + decode_steps, CB): the
    prefill's argmax, then each step's), ``last_logits`` (the
    last step's), ``prefill_s`` and ``decode_s`` (host clock around
    synchronized work) and, on the card, ``step_ms`` (each decode step by
    CUDA events). The two phases run under
    ``torch.profiler.record_function`` ranges ``"prefill"`` and
    ``"decode"``, so a profiled call reads its device time by phase."""
    tokens = inputs["tokens"]
    dev = tokens.device
    s = tokens.shape[1]
    if "patch_embeddings" in inputs:
        s += inputs["patch_embeddings"].shape[1]
    prefill = make_prefill_step(cfg, max_len=s + decode_steps,
                                window_override=window, q_block=q_block,
                                kv_block=kv_block)
    decode = make_decode_step(cfg, window_override=window)
    _sync(dev)
    t0 = time.perf_counter()
    with record_function("prefill"):
        logits, cache = prefill(params, inputs)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out = [tok]
    events = []
    last = logits
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    with record_function("decode"):
        for t in range(decode_steps):
            if on_card:
                events.append((torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)))
                events[-1][0].record()
            last, cache = decode(params, cache, {"tokens": tok[:, None]},
                                 s + t)  # (B, 1) or audio's (B, 1, CB)
            tok = torch.argmax(last[:, -1], dim=-1).to(torch.int32)
            if on_card:
                events[-1][1].record()
            out.append(tok)
        _sync(dev)
    result = {"logits": logits, "cache": cache,
              "tokens": torch.stack(out, dim=1), "last_logits": last,
              "prefill_s": prefill_s,
              "decode_s": time.perf_counter() - t0}
    if on_card:
        result["step_ms"] = [a.elapsed_time(e) for a, e in events]
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    cfg = (config_registry.get_reduced(args.arch) if args.reduced
           else config_registry.get_config(args.arch))
    check_seq(cfg, args.prompt_len)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    params = T.init_params(cfg, args.seed, dev)
    batch = synthetic_batch_for_config(cfg, rng, args.batch, args.prompt_len)
    inputs = {k: to_device(torch.from_numpy(v), dev)
              for k, v in batch.items() if k != "labels"}

    out = serve(cfg, params, inputs, decode_steps=args.decode_steps,
                window=args.window)
    print(f"prefill[{args.batch}x{args.prompt_len}] "
          f"logits={tuple(out['logits'].shape)} t={out['prefill_s']:.2f}s")
    dt = out["decode_s"]
    print(f"decode {args.decode_steps} steps: {dt:.2f}s "
          f"({args.decode_steps * args.batch / dt:.1f} tok/s)")
    print("sample tokens:", out["tokens"][0].cpu().tolist()[:16])
    return out


if __name__ == "__main__":
    main()
