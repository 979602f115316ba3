"""QAFeL rounds on a decoder architecture (reduced config).

The port of ``examples/federated_llm.py``: the same Algorithm 1-3 round
math drives a decoder from the pool (gemma2-2b by default; any of it:
internvl2-1b's batches carry patch embeddings, musicgen-large's codebook
tokens, mamba2-1.3b and zamba2-7b run Mamba2, qwen3-moe-235b-a22b and
deepseek-v3-671b their experts, deepseek MLA, a dense prefix and the MTP
loss), K clients
in turn, per-client qsgd4 uploads (K1 encode, K3 decode), the server
update and the qsgd4 hidden-state broadcast. The tokens come from the
same numpy stream as the reference's, the keys from the port's threefry,
the random weights from a torch generator (not the reference's numbers).

    PYTHONPATH=src python -m repro_torch.examples.federated_llm \\
        --arch gemma2-2b --rounds 8 [--device cpu]

Without ``--device`` it runs on the card and raises without CUDA.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs as config_registry
from repro_torch.common import prng
from repro_torch.common.device import resolve_device
from repro_torch.common.tree import tree_leaves
from repro_torch.core.qafel import QAFeLConfig
from repro_torch.distributed.steps import init_round_state, make_qafel_round
from repro_torch.launch.train import round_batch

LOCAL_BATCH = 2


def qafel_config(buffer_k: int) -> QAFeLConfig:
    """The example's QAFeL settings (the reference's)."""
    return QAFeLConfig(client_lr=3e-2, server_lr=1.0, server_momentum=0.3,
                       buffer_size=buffer_k, local_steps=2,
                       client_quantizer="qsgd4", server_quantizer="qsgd4")


def model_drift(x, hidden) -> torch.Tensor:
    """|x - x_hat|_1 over the whole tree, reduced on the device to one
    scalar."""
    return sum((a.to(torch.float32) - b.to(torch.float32)).abs().sum()
               for a, b in zip(tree_leaves(x), tree_leaves(hidden)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--buffer-k", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = config_registry.get_reduced(args.arch)
    qcfg = qafel_config(args.buffer_k)
    state = init_round_state(cfg, 0, dev)
    print(f"arch={cfg.arch_id} family={cfg.family} params="
          f"{sum(x.numel() for x in tree_leaves(state.x)):,}")
    round_fn = make_qafel_round(cfg, qcfg, remat=False)
    weights = torch.ones(qcfg.buffer_size)  # staleness 0: 1/sqrt(1 + 0)
    rng = np.random.default_rng(0)
    out = []
    for step in range(args.rounds):
        batch = round_batch(cfg, qcfg, rng, LOCAL_BATCH, args.seq, dev)
        state, metrics = round_fn(state, batch, weights, prng.PRNGKey(step))
        # one host sync per round: loss and the device-reduced drift
        loss, drift = torch.stack([metrics["loss"],
                                   model_drift(state.x, state.hidden)]).tolist()
        out.append((loss, drift))
        print(f"round {step}: loss={loss:.4f} |x - x_hat|_1={drift:.2f}")
    return out


if __name__ == "__main__":
    main()
