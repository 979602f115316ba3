"""Quickstart: QAFeL on a convex toy problem (d = 2048), end to end.

Clients train from the shared hidden state, quantized uploads fill the
server buffer (K = 4), the server steps and broadcasts a quantized
hidden-state increment, and a client replica stays bit-identical to the
server's hidden state. The port of ``examples/quickstart.py``; the target
noise comes from numpy (``default_rng(seed)``) rather than
``jax.random.normal``, the keys from the port's threefry.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.common import prng
from repro_torch.common.device import resolve_device
from repro_torch.core import QAFeL, QAFeLConfig
from repro_torch.core.protocol import decode_message_flat

D = 2048
TARGET = 3.0
CONFIG = QAFeLConfig(client_lr=0.2, server_lr=1.0, server_momentum=0.3,
                     buffer_size=4, local_steps=2,
                     client_quantizer="qsgd4",  # 4-bit stochastic uploads
                     server_quantizer="qsgd4")  # 4-bit broadcasts


def loss_fn(params, batch, key):
    del key
    return torch.mean((params["w"] - batch["target"]) ** 2)


def run(device=None, uploads: int = 40, seed: int = 0, verbose: bool = True):
    """Run ``uploads`` client uploads; returns (algo, replica_in_sync)."""
    dev = resolve_device(device)
    algo = QAFeL(CONFIG, loss_fn, {"w": torch.zeros(D)}, device=dev)
    replica = algo.state.hidden_flat.clone()  # one client's x-hat replica
    key = prng.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    p = CONFIG.local_steps
    for _ in range(uploads):
        key, _, k2, k3 = prng.split(key, 4)
        noise = torch.from_numpy(
            rng.standard_normal((p, D), dtype=np.float32)).to(dev)
        batches = {"target": torch.full((p, D), TARGET, device=dev)
                   + 0.1 * noise}
        msg, _version = algo.run_client(batches, k2)
        bmsg = algo.receive(msg, k3)
        if bmsg is not None:  # buffer flushed -> server stepped -> broadcast
            replica = replica + decode_message_flat(algo.sq, bmsg)
            if verbose:
                err = float(torch.linalg.norm(algo.state.x["w"] - TARGET))
                print(f"server step {algo.state.t:2d}  |x - target| = "
                      f"{err:8.3f}  msg = {msg.wire_bytes / 1e3:.2f} kB (vs "
                      f"{4 * D / 1e3:.2f} kB full precision)")
    return algo, torch.equal(replica, algo.state.hidden_flat)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--uploads", type=int, default=40)
    args = ap.parse_args(argv)
    algo, same = run(args.device, args.uploads)
    print("\nmetrics:", {k: round(v, 3) if isinstance(v, float) else v
                         for k, v in algo.metrics(drift=True).items()})
    print("client x-hat replica bit-identical to server:", same)
    if not same:
        raise SystemExit("replica diverged from the server's hidden state")


if __name__ == "__main__":
    main()
