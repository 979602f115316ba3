#!/usr/bin/env python3
"""Two checkouts of the PyTorch/CUDA port on one GPU, measured in turns.

    python3 chip_compare.py BEFORE_DIR AFTER_DIR [--pairs 2]

Each measurement runs ``python3 chip_compare.py --measure DIR`` in a fresh
process that imports only ``DIR/src/repro_torch`` (its kernels build into
``DIR/build``), in the order before, after, after, before for each pair,
and prints one JSON line:

* the b=1 upload (``kernels.ops.qsgd_quantize``), the buffer aggregate
  (``kernels.ops.buffer_aggregate``, K = 10), the broadcast encode as the
  flush calls it (``kernels.ops.qsgd_quantize_batch``, B = 1, the key on
  the CPU) and the broadcast decode (``kernels.ops.qsgd_dequantize``) at
  the CNN's size (79,842 parameters, qsgd4) and at d = 1e8: median device
  ms per call (CUDA events, ``chip_smoke.device_ms``);
* int32 SASS instructions of the built kernels (``cuobjdump``): the
  aggregate's kernels summed over their instantiations, and the threefry
  dither per element of the fused b=1 upload;
* device launches of one upload at the CNN's size and of one client step
  (``torch.profiler``);
* the CNN main path of ``chip_smoke.py`` (``AsyncFLSimulator`` driving
  ``QAFeL``, 100 uploads, concurrency 16): wall time, uploads/s and the
  client-step and flush medians (host clock around synchronized calls);
* ``PopulationEngine("lognormal_dropout")`` at 100,000 clients to horizon
  1.0 and 1,000,000 to 0.05, as ``chip_smoke.py`` runs it: events
  (admissions plus deliveries) per second of ``advance_to`` (host clock,
  ending in a device sync).

With ``--only taps`` each measurement is the metric-tap kernels alone
(``kernels.taps``): ``flush_taps`` and ``upload_taps`` at
``chip_smoke.tap_kernel_cases``' timed shapes and ``round_taps`` over
gemma2-2b's window sums (d = 2,614,341,888): median device ms, the byte
bound's share and the achieved GB/s of each; the launch floor
(``chip_smoke.launch_floor_ms``); and each tap kernel's registers, shared
bytes and blocks an SM (``chip_smoke.tap_resources``).

The last lines are the card's name and power limit and one JSON object
with each metric's median per checkout. Uses only entry points that both
checkouts have; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CNN_N, K, BITS, BIG_N = 79_842, 10, 4, 100_000_000
UPLOADS, CONCURRENCY = 100, 16


def measure(tree: Path) -> dict:
    """Every metric of one checkout, on the card."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    from chip_smoke import (device_launches, device_ms, per_element,
                            sass_int32_ops)
    from repro_torch.common import prng
    from repro_torch.common.device import resolve_device
    from repro_torch.core import QAFeL
    from repro_torch.examples import federated_celeba as fc
    from repro_torch.kernels import _build, ops
    from repro_torch.models.cnn import init_cnn
    from repro_torch.sim import AsyncFLSimulator, SimConfig

    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    key = prng.split(prng.PRNGKey(1))[1]
    key2d = key.reshape(1, -1)
    out = {"tree": str(tree)}
    build = _build.build_all()
    out["aggregate_int32_sass"] = sum(sass_int32_ops(
        build / "libbuffer_aggregate.so", "buffer_aggregate_kernel").values())
    out["upload_dither_int32_per_element"] = per_element(
        sass_int32_ops(build / "libquantize_pack_threefry.so",
                       "quantize_pack_threefry_kernel"),
        sass_int32_ops(build / "libquantize_pack.so", "quantize_pack_kernel"),
        4)["total"]
    for label, n, reps in (("cnn", CNN_N, 50), ("d1e8", BIG_N, 5)):
        flat = torch.randn(n, generator=gen, device=dev) * 0.01
        rows = ops.rows_for(n)
        stack = torch.randint(0, 256, (K, rows, 16 * BITS), generator=gen,
                              device=dev, dtype=torch.uint8)
        norms = torch.rand((K, rows), generator=gen, device=dev)
        w = torch.rand(K, generator=gen, device=dev) / K
        out[f"upload_ms_{label}"] = device_ms(
            lambda: ops.qsgd_quantize(flat, key, BITS), reps)
        out[f"aggregate_ms_{label}"] = device_ms(
            lambda: ops.buffer_aggregate(stack, norms, w, BITS, n), reps)
        out[f"broadcast_encode_ms_{label}"] = device_ms(
            lambda: ops.qsgd_quantize_batch(flat[None], key2d, BITS), reps)
        out[f"broadcast_decode_ms_{label}"] = device_ms(
            lambda: ops.qsgd_dequantize(stack[0], norms[0], BITS, n), reps)
        del flat, stack, norms
        torch.cuda.empty_cache()

    task = fc.celeba_task(dev)
    algo = QAFeL(fc.qafel_config(), task.loss_fn, init_cnn(0, device=dev),
                 device=dev)
    delta = torch.randn(algo.state.n, generator=gen, device=dev) * 1e-3
    ops.qsgd_quantize(delta, key, BITS)
    out["upload_launches"] = sum(c for _, c in device_launches(
        lambda: ops.qsgd_quantize(delta, key, BITS)))
    keys = prng.split(prng.PRNGKey(6), 12)
    batches = [task.client_batches(i, keys[2 * i]) for i in range(6)]
    algo.run_client(batches[0], keys[1])
    out["client_step_launches"] = sum(c for _, c in device_launches(
        lambda: [algo.run_client(batches[i], keys[2 * i + 1])
                 for i in range(1, 6)])) / 5

    algo = QAFeL(fc.qafel_config(), task.loss_fn, init_cnn(0, device=dev),
                 device=dev)
    spans = {"client": [], "flush": []}

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*args, **kw)
            torch.cuda.synchronize()
            spans[name].append(time.perf_counter() - t0)
            return result
        return call

    algo.run_client = timed("client", algo.run_client)
    algo._flush = timed("flush", algo._flush)
    sim = AsyncFLSimulator(algo, SimConfig(concurrency=CONCURRENCY,
                                           max_uploads=UPLOADS,
                                           eval_every_steps=3),
                           task.client_batches, task.eval_fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out.update(main_wall_s=wall, uploads_per_s=res.uploads / wall,
               client_ms_median=1e3 * statistics.median(spans["client"]),
               flush_ms_median=1e3 * statistics.median(spans["flush"]),
               replicas_in_sync=bool(res.metrics["replicas_in_sync"]))

    from repro_torch.sim import PopulationEngine
    for clients, horizon in ((100_000, 1.0), (1_000_000, 0.05)):
        eng = PopulationEngine("lognormal_dropout", clients, horizon=horizon,
                               seed=0, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eng.advance_to(horizon)
        torch.cuda.synchronize()
        out[f"population_{clients}_events_per_s"] = (
            m["admitted"] + m["delivered"]) / (time.perf_counter() - t0)
    return out


LLM_D = 2_614_341_888  # gemma2-2b's d: round_taps over its window sums


def measure_taps(tree: Path) -> dict:
    """The metric-tap kernels of one checkout, on the card."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    from chip_smoke import (HBM_BYTES_PER_S, device_ms, launch_floor_ms,
                            tap_kernel_cases, tap_resources)
    from repro_torch.common.device import resolve_device
    from repro_torch.kernels import _build, taps

    dev = resolve_device("cuda")
    out = {"tree": str(tree)}
    for name, res in tap_resources(_build.build_all()).items():
        out.update({f"{name}_{k}": v for k, v in res.items()})
    out["launch_floor_ms"] = launch_floor_ms(dev)

    def record(name, fn, nbytes, reps):
        ms = device_ms(fn, reps)
        out[f"{name}_ms"] = ms
        out[f"{name}_bound_share"] = 1e3 * nbytes / HBM_BYTES_PER_S / ms
        out[f"{name}_GB_per_s"] = nbytes / ms / 1e6

    for name, case in tap_kernel_cases(dev).items():
        if case["timed"]:
            record(name, lambda: case["fn"](*case["args"]), case["bytes"],
                   10 if "d1e8" in name else 50)
        case.clear()
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(20)
    windows = -(-LLM_D // 32)
    parts = torch.rand((5, windows), generator=gen, device=dev)
    w = torch.rand(4, generator=gen, device=dev)
    record("round_taps_llm", lambda: taps.round_taps(parts, w),
           5 * 4 * windows + 4 * 4 + 7 * 4, 10)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--measure", type=Path)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--only", choices=("taps",))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 2
    if args.measure is not None:
        fn = measure_taps if args.only == "taps" else measure
        print(json.dumps(fn(args.measure.resolve())), flush=True)
        return 0
    before, after = (t.resolve() for t in args.trees)
    runs = {"before": [], "after": []}
    for _ in range(args.pairs):
        for name, tree in (("before", before), ("after", after),
                           ("after", after), ("before", before)):
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--measure",
                 str(tree), *(["--only", args.only] if args.only else [])],
                cwd=ROOT, capture_output=True, text=True, check=True)
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"run": name, **line}), flush=True)
            runs[name].append(line)
    metrics = [k for k, v in runs["after"][0].items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)]
    summary = {name: {m: statistics.median(r[m] for r in rs)
                      for m in metrics} for name, rs in runs.items()}
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(json.dumps({"summary": summary,
                      "in_sync": all(r.get("replicas_in_sync", True)
                                     for rs in runs.values() for r in rs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
