"""The paper's experiment, end to end: asynchronous federated training of
the 4-layer CNN on (synthetic) CelebA with bidirectional 4-bit
quantization, then full-precision FedBuff on the same timeline.

The port of ``examples/federated_celeba.py``: constant client arrivals,
half-normal training durations, buffer K = 10, staleness down-weighting,
P = 2 local steps of batch 8 at client lr 0.05, server momentum 0.3, real
packed wire messages with exact byte metering. ``--engine cohort`` trains
the clients in cohorts of ``--cohort-size`` (``sim.cohort``) under a named
``--scenario`` (``sim.scenarios``).

    PYTHONPATH=src python -m repro_torch.examples.federated_celeba \
        [--uploads 400] [--concurrency 16] [--device cpu] \
        [--engine cohort --scenario tiered_bits --cohort-size 8]
"""
from __future__ import annotations

import argparse
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device, to_device
from repro_torch.core import QAFeL, QAFeLConfig
from repro_torch.data import FederatedPartition, SyntheticCelebA
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn
from repro_torch.sim import (AsyncFLSimulator, CohortAsyncFLSimulator,
                             SimConfig, SimResult)

RUNS = (("QAFeL 4-bit/4-bit", "qsgd4", "qsgd4"),
        ("FedBuff (full precision)", "identity", "identity"))
BATCH, LOCAL_STEPS, EVAL_SIZE = 8, 2, 512


def qafel_config(cq: str = "qsgd4", sq: str = "qsgd4") -> QAFeLConfig:
    return QAFeLConfig(client_lr=0.05, server_lr=1.0, server_momentum=0.3,
                       buffer_size=10, local_steps=LOCAL_STEPS,
                       client_quantizer=cq, server_quantizer=sq)


class CelebATask(NamedTuple):
    loss_fn: Callable
    client_batches: Callable  # (client_id, key) -> dict of (P, ...) tensors
    eval_fn: Callable  # params tree -> accuracy


def celeba_task(device, *, n_samples: int = 3000,
                n_clients: int = 300) -> CelebATask:
    """Data, client sampling and evaluation of the example, on ``device``.
    Client batches are drawn from ``numpy.random.default_rng(0)`` in
    client order, as the reference example draws them."""
    ds = SyntheticCelebA(n_samples=n_samples)
    part = FederatedPartition(labels=ds.labels, n_clients=n_clients)
    rng = np.random.default_rng(0)

    def loss_fn(params, batch, key):
        return cnn_loss(params, batch, train=True, key=key)[0]

    def client_batches(cid, key):
        del key
        b = [part.client_batch(ds, cid, BATCH, rng)
             for _ in range(LOCAL_STEPS)]
        return {k: to_device(torch.from_numpy(np.stack([bi[k] for bi in b])),
                             device) for k in b[0]}

    test_idx = part.split_indices(part.val_clients)[:EVAL_SIZE]
    test = {k: torch.from_numpy(v).to(device)
            for k, v in ds.batch(test_idx).items()}

    def eval_fn(params):
        return float(cnn_accuracy(params, test))

    return CelebATask(loss_fn, client_batches, eval_fn)


def run_one(task: CelebATask, params0, qcfg: QAFeLConfig, scfg: SimConfig,
            device, *, engine: str = "sequential",
            scenario: str = "identity", cohort_size: int = 8) -> SimResult:
    algo = QAFeL(qcfg, task.loss_fn, params0, device=device)
    if engine == "cohort":
        return CohortAsyncFLSimulator(algo, scfg, task.client_batches,
                                      task.eval_fn, scenario=scenario,
                                      cohort_size=cohort_size).run()
    return AsyncFLSimulator(algo, scfg, task.client_batches,
                            task.eval_fn).run()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--uploads", type=int, default=400)
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--target", type=float, default=0.90)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--engine", choices=["sequential", "cohort"],
                    default="sequential")
    ap.add_argument("--scenario", default="identity",
                    help="scenario name (cohort engine only); see "
                         "repro_torch.sim.scenarios.SCENARIOS")
    ap.add_argument("--cohort-size", type=int, default=8)
    args = ap.parse_args(argv)
    if args.scenario != "identity" and args.engine != "cohort":
        ap.error("--scenario requires --engine cohort")
    dev = resolve_device(args.device)
    params0 = init_cnn(0, device=dev)
    n_params = sum(v.numel() for sub in params0.values() for v in sub.values())
    print(f"CNN: {n_params} params -> full-precision message "
          f"{4 * n_params / 1e3:.1f} kB")
    for name, cq, sq in RUNS:
        # each run gets its own data stream, as each reference run re-draws
        task = celeba_task(dev)
        scfg = SimConfig(concurrency=args.concurrency,
                         max_uploads=args.uploads, eval_every_steps=3,
                         target_accuracy=args.target)
        res = run_one(task, params0, qafel_config(cq, sq), scfg, dev,
                      engine=args.engine, scenario=args.scenario,
                      cohort_size=args.cohort_size)
        m = res.metrics
        print(f"\n== {name} ==")
        print(f"  reached {args.target:.0%}: {res.reached_target}  "
              f"(final acc {res.final_accuracy:.3f})")
        print(f"  uploads: {res.uploads}   server steps: {res.server_steps}"
              f"   tau_max: {m['tau_max']}")
        print(f"  kB/upload: {m['kB_per_upload']:.2f}   total upload MB: "
              f"{m['upload_MB']:.2f}   broadcast MB: {m['broadcast_MB']:.2f}")
        print(f"  hidden drift: {m['hidden_drift']:.4f}   replicas in sync: "
              f"{m['replicas_in_sync']}")


if __name__ == "__main__":
    main()
