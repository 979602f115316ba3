"""Training launcher: QAFeL rounds for an architecture on one device.

The port of ``repro/launch/train.py``, with its flags and ``--device``
(None: the card). Under an initialised ``torch.distributed`` process
group it takes the reference's mesh (``launch.mesh.make_host_mesh()``
below 256 ranks, ``make_production_mesh()`` at 256) and runs the round
on it (``make_qafel_round(mesh=)``, the state on the mesh's flat
segments; a rank outside the mesh returns at once); without a group it
builds none. Each round is one call of
``distributed.steps.make_qafel_round(cfg, qcfg, remat=False)`` on
``global_batch // (K * local_steps)`` sequences per client and local
step, the tokens from the reference's numpy stream
(``synthetic_batch_for_config`` with ``np.random.default_rng(seed)``),
the staleness weights ``staleness_weight(zeros(K))`` and the round key
jax's ``PRNGKey(seed * 100003 + step)``, whose seed jax keeps modulo 2^32
(``round_key``). The progress line prints about ten times a run and is
the loop's only wait on the device. At the end, with
``--checkpoint-dir``, x is saved as the reference saves it
(``checkpoint.save_checkpoint(dir, steps, {"x": x}, {"arch": arch})``).
The round encodes its messages ``CHUNK_ROWS`` wire rows at a time, which
changes no bit (tests/test_torch_llm_round.py) and keeps the full-size
round's peak under one f32 copy of the model.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --reduced --steps 50 --seq 128 --global-batch 32 [--device cpu] \\
        [--checkpoint-dir build/ckpt]

Every architecture of the pool runs: a VLM's ``--seq`` counts its patch
embeddings and must exceed them (internvl2-1b: 256, its reduced config
16), audio's batches carry (..., seq, CB) codebook tokens; mamba2-1.3b
and zamba2-7b keep their f32 ``A_log``, ``D`` and ``dt_bias`` in a bf16
state (``distributed.steps``), saved as f32 leaves; the MoE configs add
their routers' aux loss and deepseek-v3-671b its MTP term to the loss.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs as config_registry
from repro_torch.checkpoint import save_checkpoint
from repro_torch.common import prng
from repro_torch.common.device import resolve_device, to_device
from repro_torch.core.qafel import QAFeLConfig
from repro_torch.core.staleness import staleness_weight
from repro_torch.data.synthetic import check_seq, synthetic_batch_for_config
from repro_torch.distributed.steps import (RoundState, gather_tree,
                                           init_round_state,
                                           make_qafel_round)

CHUNK_ROWS = 1 << 20  # wire rows per encode chunk (bit-invisible)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--buffer-k", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--client-lr", type=float, default=3e-2)
    ap.add_argument("--server-lr", type=float, default=1.0)
    ap.add_argument("--client-quantizer", default="qsgd4")
    ap.add_argument("--server-quantizer", default="qsgd4")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    return ap.parse_args(argv)


def round_key(seed: int, step: int) -> torch.Tensor:
    """jax's ``PRNGKey(seed * 100003 + step)`` with 64-bit values off:
    the seed modulo 2^32 as the key's second word."""
    return prng.PRNGKey((int(seed) * 100_003 + int(step)) % (1 << 32))


def qafel_config(args: argparse.Namespace) -> QAFeLConfig:
    """The launcher's QAFeL settings (the reference's)."""
    return QAFeLConfig(
        client_lr=args.client_lr, server_lr=args.server_lr,
        server_momentum=0.3, buffer_size=args.buffer_k,
        local_steps=args.local_steps,
        client_quantizer=args.client_quantizer,
        server_quantizer=args.server_quantizer)


def round_batch(cfg, qcfg: QAFeLConfig, rng: np.random.Generator,
                local: int, seq: int, device) -> dict:
    """One round's batch on ``device``, each leaf (K, P, local, ...): the
    (..., seq) tokens and labels ((..., seq, CB) for audio; a VLM's text
    span seq - n_prefix and its (..., n_prefix, D) patch embeddings), from
    the reference's numpy stream (the launcher's and the federated
    example's, which passes its ``LOCAL_BATCH``)."""
    k, p = qcfg.buffer_size, qcfg.local_steps
    b = synthetic_batch_for_config(cfg, rng, k * p * local, seq)
    return {name: to_device(torch.from_numpy(v).reshape(
        (k, p, local) + v.shape[1:]), device) for name, v in b.items()}


def launcher_mesh():
    """The reference's choice of mesh under an initialised process group
    (``make_host_mesh()`` below 256 ranks, ``make_production_mesh()`` at
    256), else None."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    if not (dist.is_available() and dist.is_initialized()):
        return None
    return (make_host_mesh() if dist.get_world_size() < 256
            else make_production_mesh())


def run(args: argparse.Namespace,
        state: Optional[RoundState] = None) -> dict:
    """The launcher's loop. ``state`` (e.g. the reference's, carried
    across with ``convert.round_state_from_jax``) replaces the random
    initial state. Returns ``state``, ``losses`` (the rounds' losses, an f32 tensor on
    the device), the last round's ``metrics``, the ``checkpoint`` path
    (or None) and ``seconds`` (the loop's host clock, the checkpoint
    excluded)."""
    dev = resolve_device(args.device)
    cfg = (config_registry.get_reduced(args.arch) if args.reduced
           else config_registry.get_config(args.arch))
    check_seq(cfg, args.seq)
    qcfg = qafel_config(args)
    local = args.global_batch // (qcfg.buffer_size * qcfg.local_steps)
    if local < 1:
        raise ValueError(f"--global-batch {args.global_batch} is below K * "
                         f"local steps = "
                         f"{qcfg.buffer_size * qcfg.local_steps}")
    mesh = launcher_mesh()
    if mesh is not None and mesh.get_coordinate() is None:
        return {"state": None, "losses": torch.zeros(0), "metrics": {},
                "checkpoint": None, "seconds": 0.0, "mesh": mesh}
    round_fn = make_qafel_round(cfg, qcfg, remat=False,
                                chunk_rows=CHUNK_ROWS, mesh=mesh)
    rng = np.random.default_rng(args.seed)
    if state is None:
        state = init_round_state(cfg, args.seed, dev, mesh=mesh)
    weights = to_device(staleness_weight(torch.zeros(qcfg.buffer_size)), dev)
    losses, metrics = [], {}
    t0 = time.time()
    for step in range(args.steps):
        batch = round_batch(cfg, qcfg, rng, local, args.seq, dev)
        state, metrics = round_fn(state, batch, weights,
                                  round_key(args.seed, step))
        losses.append(metrics["loss"])
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            # gated progress sync: about ten per run, deliberate
            print(f"round {step:4d} loss={float(metrics['loss']):.4f} "
                  f"t={time.time() - t0:.1f}s", flush=True)
    seconds = time.time() - t0
    path = None
    if args.checkpoint_dir:
        x = state.x
        if x is None:  # segments over several ranks: x leaf by leaf
            x = gather_tree(state, "x", round_fn.plan)
        if mesh is None or round_fn.plan.seg == 0:
            path = save_checkpoint(args.checkpoint_dir, args.steps,
                                   {"x": x}, {"arch": args.arch})
            print("checkpoint:", path)
    return {"state": state, "losses": torch.stack(losses) if losses else
            torch.zeros(0), "metrics": metrics, "checkpoint": path,
            "seconds": seconds, "mesh": mesh}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
