"""Run the cohort or population engine under a named scenario.

The port of ``examples/cohort_scenarios.py``. The cohort engine
(``sim.cohort``) trains each admitted cohort's clients under one vmap and
encodes all their uploads in one batched kernel launch; the scenario
(``sim.scenarios``) sets latencies, arrivals, dropouts, stragglers and
per-client quantizer bit-width tiers. ``--engine population`` runs the
timeline in the device-resident population engine (``sim.population``):
admission, draws, the deadline wheel and staleness in one step per macro
step, so large ``--concurrency`` values stay cheap; its eval events carry
the per-state population counts.

    PYTHONPATH=src python -m repro_torch.examples.cohort_scenarios --list
    PYTHONPATH=src python -m repro_torch.examples.cohort_scenarios \\
        --scenario tiered_bits --concurrency 8 --cohort-size 4 \\
        --uploads 120 [--model quad] [--device cpu] [--trace PATH] \\
        [--engine population]

``--model quad`` swaps the CNN for a d = 2048 convex quadratic whose
"accuracy" is the fraction of the distance to the optimum recovered; its
optimum comes from a numpy seed (the reference draws it with
``jax.random``). ``--min-acc`` asserts convergence. ``--trace PATH`` turns
the telemetry taps on, writes the run's events to PATH as JSONL, validates
them against the schema (``repro_torch.obs.schema``) and prints the
summary table. Without ``--device`` the run asks for CUDA and raises where
there is none.
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
from repro_torch.obs import (RunTracer, summary_table, validate_jsonl,
                             write_jsonl)
from repro_torch.sim import (SCENARIOS, CohortAsyncFLSimulator,
                             PopulationAsyncFLSimulator, SimConfig)

QUAD_D = 2048


class Task(NamedTuple):
    loss_fn: Callable
    params0: dict
    client_batches: Callable
    eval_fn: Callable


def quad_optimum(d: int = QUAD_D) -> np.ndarray:
    """The quadratic's optimum: a numpy-seeded direction of norm 10."""
    w = np.random.default_rng(1).standard_normal(d).astype(np.float32)
    return (w / np.linalg.norm(w) * 10.0).astype(np.float32)


def quad_targets(wstar: np.ndarray, cids) -> np.ndarray:
    """(b, 2, d) local targets: the optimum plus client-seeded noise, as
    the reference example draws them."""
    return np.stack([wstar[None] + np.random.default_rng(int(c)).normal(
        0.0, 0.05, (2, wstar.size)).astype(np.float32) for c in cids])


def quad_loss(params, batch, key):
    del key
    return torch.sum((params["w"] - batch["target"]) ** 2)


def quad_task(device, d: int = QUAD_D) -> Task:
    """The convex task on ``device``, with a batched batches provider."""
    wstar = quad_optimum(d)

    def client_batches(cids, keys):
        del keys
        targets = torch.from_numpy(quad_targets(wstar, cids))
        return {"target": to_device(targets, device)}
    client_batches.batched = True

    def eval_fn(p):
        # in numpy on the host: the same accuracy on every device
        w = p["w"].detach().cpu().numpy()
        return float(1.0 - np.linalg.norm(w - wstar) / np.linalg.norm(wstar))

    return Task(quad_loss, {"w": torch.zeros(d, device=device)},
                client_batches, eval_fn)


def cnn_task(device, samples: int = 1200, seed: int = 0) -> Task:
    """The paper's CNN on ``SyntheticCelebA(samples)``, ``samples // 10``
    clients, batches of 8 from ``default_rng(seed)`` in admission order."""
    ds = SyntheticCelebA(n_samples=samples)
    part = FederatedPartition(labels=ds.labels, n_clients=samples // 10)
    rng = np.random.default_rng(seed)

    def loss_fn(params, batch, key):
        return cnn_loss(params, batch, train=True, key=key)[0]

    def client_batches(cid, key):
        del key
        b = [part.client_batch(ds, cid, 8, rng) for _ in range(2)]
        return {k: to_device(torch.from_numpy(np.stack([bi[k] for bi in b])),
                             device) for k in b[0]}

    test_idx = part.split_indices(part.val_clients)[:256]
    test = {k: torch.from_numpy(v).to(device)
            for k, v in ds.batch(test_idx).items()}

    def eval_fn(params):
        return float(cnn_accuracy(params, test))

    return Task(loss_fn, init_cnn(0, device=device), client_batches, eval_fn)


def qafel_config(buffer: int = 4) -> QAFeLConfig:
    return QAFeLConfig(client_lr=0.05, server_lr=1.0, server_momentum=0.3,
                       buffer_size=buffer, local_steps=2,
                       client_quantizer="qsgd4", server_quantizer="qsgd4")


def run(task: Task, device, *, scenario: str = "identity",
        concurrency: int = 8, cohort_size: int = 4, uploads: int = 120,
        buffer: int = 4, seed: int = 0, telemetry=None,
        engine: str = "cohort"):
    """One run of the cohort or population engine; returns (algo,
    result). ``telemetry`` is an ``obs.RunTracer`` or None."""
    algo = QAFeL(qafel_config(buffer), task.loss_fn, task.params0,
                 device=device, telemetry=telemetry)
    engine_cls = (PopulationAsyncFLSimulator if engine == "population"
                  else CohortAsyncFLSimulator)
    sim = engine_cls(
        algo, SimConfig(concurrency=concurrency, max_uploads=uploads,
                        eval_every_steps=3, seed=seed),
        task.client_batches, task.eval_fn, scenario=scenario,
        cohort_size=cohort_size)
    return algo, sim.run()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="identity",
                    help="name from repro_torch.sim.scenarios.SCENARIOS")
    ap.add_argument("--list", action="store_true", help="list scenarios")
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--cohort-size", type=int, default=4)
    ap.add_argument("--uploads", type=int, default=120)
    ap.add_argument("--buffer", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--samples", type=int, default=1200)
    ap.add_argument("--min-acc", type=float, default=None,
                    help="assert final accuracy >= this")
    ap.add_argument("--model", choices=("cnn", "quad"), default="cnn")
    ap.add_argument("--engine", choices=("cohort", "population"),
                    default="cohort",
                    help="the event-loop cohort engine or the "
                         "device-resident population engine")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="turn the telemetry taps on and write the run's "
                         "events to PATH as JSONL (schema-validated)")
    args = ap.parse_args(argv)
    if args.list:
        for name, cfg in SCENARIOS.items():
            print(f"{name:20s} {cfg}")
        return
    dev = resolve_device(args.device)
    task = (quad_task(dev) if args.model == "quad"
            else cnn_task(dev, args.samples, args.seed))
    tracer = RunTracer(taps=True) if args.trace is not None else None
    _algo, res = run(task, dev, scenario=args.scenario,
                     concurrency=args.concurrency,
                     cohort_size=args.cohort_size, uploads=args.uploads,
                     buffer=args.buffer, seed=args.seed, telemetry=tracer,
                    engine=args.engine)
    m = res.metrics
    print(f"engine={args.engine}  model={args.model}  scenario={args.scenario}  "
          f"cohort_size={args.cohort_size}  concurrency={args.concurrency}  "
          f"device={dev}")
    print(f"  uploads: {res.uploads}  dropped: {m['dropped_uploads']}  "
          f"server steps: {res.server_steps}  tau_max: {m['tau_max']}")
    print(f"  kB/upload: {m['kB_per_upload']:.2f}  upload MB: "
          f"{m['upload_MB']:.2f}  broadcast MB: {m['broadcast_MB']:.2f}")
    print(f"  final accuracy: {res.final_accuracy:.3f}  replicas in sync: "
          f"{m['replicas_in_sync']}")
    if "population_states" in m:
        states = "  ".join(f"{k}={v}" for k, v in
                           m["population_states"].items())
        print(f"  population: {states}")
    if not m["replicas_in_sync"]:
        raise SystemExit("a replica diverged from the server's hidden state")
    if args.min_acc is not None and res.final_accuracy < args.min_acc:
        raise SystemExit(f"accuracy {res.final_accuracy:.3f} < required "
                         f"{args.min_acc}")
    if tracer is not None:
        write_jsonl(tracer, args.trace)
        errors = validate_jsonl(args.trace)
        if errors:
            raise SystemExit(f"trace schema errors: {errors[:5]}")
        print(summary_table(tracer, title=f"telemetry ({args.trace})"))
        print(f"  trace: {len(tracer.events())} events -> {args.trace} "
              f"(schema OK)")


if __name__ == "__main__":
    main()
