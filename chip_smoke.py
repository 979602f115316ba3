#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. the card's name and power limit (``nvidia-smi``);
2. build of the four CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once), timed;
3. each kernel against its plain PyTorch version on the card, bit for bit
   (``torch.equal`` on the bit patterns), at the main path's shapes (the
   CNN: 624 rows, K = 10, qsgd4) and at d = 1e8 (781,250 rows): median
   device time per launch, the plain version's time and the bound;
4. the main path through its entry points: ``AsyncFLSimulator`` driving
   ``QAFeL`` on the paper's CNN at full width (79,842 parameters), the
   federated example's configuration, concurrency 16, 100 uploads, with the
   launch counters set to 0 just before and read just after;
5. a short second run of the main path under ``torch.profiler``: the
   device's idle share and its busiest kernels;
6. the server path on the card against the CPU's plain versions on
   identical uploads, and the quickstart on both devices, bit for bit;
7. one line listing every kernel with its launches, times and bound;
8. last, ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero; without a CUDA device it
exits non-zero before printing any result. Times come from CUDA events
(kernels) or the host clock around synchronized work (the main path syncs
around every client step, flush and eval to time them); the bounds
use the H100 SXM's published 3.35 TB/s and 67 TFLOP/s (float32, no tensor
cores).
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
CNN_ROWS, CNN_K, BITS = 624, 10, 4
BIG_ROWS = 781_250  # d = 1e8
MAIN_UPLOADS, CONCURRENCY = 100, 16


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_ms(fn, reps: int) -> float:
    """Median device time of one call of ``fn``: the calls are queued
    behind a device-side sleep so the events time the device, not the
    host's launch rate."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bits_equal(a, b) -> bool:
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def kernel_cases(rows: int, k: int, dev):
    """Inputs of the four kernels at ``rows`` wire rows (K messages for the
    aggregate), their byte and operation counts, and the TPU kernel each
    replaces."""
    import torch

    from repro_torch.common import prng
    from repro_torch.kernels import buffer_agg, qsgd

    gen = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn((rows, 128), generator=gen, device=dev) * 0.01
    x[rows // 2] = 0.0  # an all-zero bucket
    u = prng.uniform(prng.PRNGKey(1), (rows, 128), device=dev)
    keys = prng.split(prng.PRNGKey(2), k)
    stack, norms = qsgd.qsgd_quantize_pack_batch(
        x[None].expand(k, rows, 128).contiguous(), keys, BITS)
    w = torch.rand(k, generator=gen, device=dev) / k
    code_b = 128 * BITS // 8
    n = rows * 128
    return {
        "qsgd_quantize_pack": dict(
            source="src/repro_torch/kernels/csrc/quantize_pack.cu",
            replaces="src/repro/kernels/qsgd.py:70",
            fn=qsgd.qsgd_quantize_pack, args=(x, u, BITS),
            bytes=n * 8 + rows * (code_b + 4),
            bytes_formula="rows*128*(4 x + 4 u) + rows*(128*bits/8 + 4)",
            ops=n * 8 + rows * 4),
        "qsgd_quantize_pack_batch": dict(
            source="src/repro_torch/kernels/csrc/quantize_pack_batch.cu",
            replaces="src/repro/kernels/qsgd.py:160",
            fn=qsgd.qsgd_quantize_pack_batch, args=(x[None], keys[:1], BITS),
            bytes=n * 4 + 8 + rows * (code_b + 4),
            bytes_formula="B*rows*128*4 x + B*8 seeds + B*rows*(128*bits/8 + 4)",
            ops=n * 20 + rows * 4),
        "qsgd_unpack_dequantize": dict(
            source="src/repro_torch/kernels/csrc/unpack_dequantize.cu",
            replaces="src/repro/kernels/qsgd.py:356",
            fn=qsgd.qsgd_unpack_dequantize,
            args=(stack[0], norms[0], BITS),
            bytes=rows * (code_b + 4) + n * 4,
            bytes_formula="rows*(128*bits/8 + 4) + rows*128*4 out",
            ops=n * 4),
        "buffer_aggregate": dict(
            source="src/repro_torch/kernels/csrc/buffer_aggregate.cu",
            replaces="src/repro/kernels/buffer_agg.py:61",
            fn=buffer_agg.buffer_aggregate, args=(stack, norms, w, BITS),
            bytes=k * rows * (code_b + 4) + k * 4 + n * 4,
            bytes_formula="K*rows*(128*bits/8 + 4) + K*4 + rows*128*4 out",
            ops=k * n * 6),
    }


def plain_of(name):
    from repro_torch.kernels import ref

    return {"qsgd_quantize_pack": ref.quantize_pack,
            "qsgd_quantize_pack_batch": ref.quantize_pack_batch,
            "qsgd_unpack_dequantize": ref.unpack_dequantize,
            "buffer_aggregate": ref.buffer_aggregate}[name]


def check_kernels(rows: int, k: int, dev, reps: int, plain_reps: int):
    """Each kernel against its plain version at one shape; returns the
    per-kernel measurements."""
    import torch

    out = {}
    for name, case in kernel_cases(rows, k, dev).items():
        got = case["fn"](*case["args"])
        want = plain_of(name)(*case["args"])
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        equal = all(bits_equal(g, w) for g, w in zip(got, want))
        err = max(float((g.double() - w.double()).abs().max())
                  for g, w in zip(got, want))
        if not equal:
            raise AssertionError(f"{name} at rows={rows}: kernel and plain "
                                 f"version differ (max abs err {err})")
        bound_ms = 1e3 * max(case["bytes"] / HBM_BYTES_PER_S,
                             case["ops"] / F32_OPS_PER_S)
        out[name] = dict(
            source=case["source"], replaces=case["replaces"],
            equal=equal, max_abs_err=err,
            ms=device_ms(lambda: case["fn"](*case["args"]), reps),
            plain_ms=device_ms(lambda: plain_of(name)(*case["args"]),
                               plain_reps),
            bound_ms=bound_ms,
            bound_by=("bytes" if case["bytes"] / HBM_BYTES_PER_S
                      >= case["ops"] / F32_OPS_PER_S else "operations"),
            bytes=case["bytes"], bytes_formula=case["bytes_formula"])
        emit({"phase": "kernel", "name": name, "rows": rows, "k": k,
              **{key: v for key, v in out[name].items()
                 if key not in ("source", "replaces")}})
    return out


def run_main_path(dev):
    """The sequential simulator on the full-width CNN; returns its record
    and the launch counts of exactly this run."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import QAFeL
    from repro_torch.examples import federated_celeba as fc
    from repro_torch.models.cnn import init_cnn
    from repro_torch.sim import AsyncFLSimulator, SimConfig

    task = fc.celeba_task(dev)
    algo = QAFeL(fc.qafel_config(), task.loss_fn, init_cnn(0, device=dev),
                 device=dev)
    spans = {"client": [], "flush": [], "eval": []}

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spans[name].append(time.perf_counter() - t0)
            return out
        return call

    algo.run_client = timed("client", algo.run_client)
    algo._flush = timed("flush", algo._flush)
    payload_bytes = []
    inner_receive = algo.receive

    def metered_receive(msg, key, n_receivers=1):
        p = msg.payload
        payload_bytes.append(p["packed"].numel() + 4 * p["norms"].numel())
        return inner_receive(msg, key, n_receivers)

    algo.receive = metered_receive
    scfg = SimConfig(concurrency=CONCURRENCY, max_uploads=MAIN_UPLOADS,
                     eval_every_steps=3)
    sim = AsyncFLSimulator(algo, scfg, task.client_batches,
                           timed("eval", task.eval_fn))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    m = res.metrics
    wire = algo.cq.wire_bytes_packed(algo.state.layout)
    flushes = res.server_steps
    checks = {
        "replicas_in_sync": bool(m["replicas_in_sync"]),
        "uploads": res.uploads == MAIN_UPLOADS,
        # metered as the reference meters: 4 bits per coordinate plus one
        # f32 norm per 128-coordinate bucket
        "bytes_per_upload": wire == (4 * 79_842) // 8 + 4 * 624 == 42_417,
        "upload_bytes": algo.meter.upload_bytes == res.uploads * 42_417,
        # the payload itself: whole 64-byte code rows plus the norms
        "payload_bytes": set(payload_bytes) == {624 * 64 + 624 * 4},
        "n_params": algo.state.n == 79_842,
        "accuracy_finite": math.isfinite(res.final_accuracy),
        "state_finite": bool(torch.isfinite(algo.state.x_flat).all()),
        "K1_per_client": launches["qsgd_quantize_pack"] >= res.uploads,
        "K2_per_flush": launches["qsgd_quantize_pack_batch"] == flushes > 0,
        "K3_per_flush": launches["qsgd_unpack_dequantize"] >= flushes > 0,
        "K4_per_flush": launches["buffer_aggregate"] == flushes > 0,
    }
    record = {"phase": "main_path", "uploads": res.uploads,
              "server_steps": flushes, "wall_s": wall,
              "uploads_per_s": res.uploads / wall,
              "client_ms_median": 1e3 * statistics.median(spans["client"]),
              "flush_ms_median": 1e3 * statistics.median(spans["flush"]),
              "eval_ms_median": 1e3 * statistics.median(spans["eval"]),
              "time_shares": {k: sum(v) / wall for k, v in spans.items()},
              "bytes_per_upload": wire, "payload_bytes": payload_bytes[0],
              "final_accuracy": res.final_accuracy,
              "hidden_drift": m["hidden_drift"], "tau_max": m["tau_max"],
              "launches": launches, "checks": checks}
    emit(record)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main path checks failed: {failed}")
    return record, launches


def profile_window(dev, uploads: int = 20):
    """A short second run of the main path under ``torch.profiler``: the
    device's busy and idle share of the window, and the kernels that take
    the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import QAFeL
    from repro_torch.examples import federated_celeba as fc
    from repro_torch.models.cnn import init_cnn
    from repro_torch.sim import AsyncFLSimulator, SimConfig

    task = fc.celeba_task(dev)
    algo = QAFeL(fc.qafel_config(), task.loss_fn, init_cnn(1, device=dev),
                 device=dev)
    sim = AsyncFLSimulator(algo, SimConfig(concurrency=CONCURRENCY,
                                           max_uploads=uploads,
                                           eval_every_steps=3),
                           task.client_batches, task.eval_fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    busy_s = 1e-6 * sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    record = {"phase": "profile", "uploads": uploads, "wall_s": wall,
              "device_busy_s": busy_s, "device_idle_share": 1 - busy_s / wall,
              "device_launches": sum(e.count for e in kernels),
              "top_kernels": [{"name": e.key[:80],
                               "ms": 1e-3 * e.self_device_time_total,
                               "count": e.count} for e in top]}
    emit(record)
    if busy_s <= 0:
        raise AssertionError("the profiler saw no device time")
    return record


def check_against_cpu(dev):
    """Identical uploads into a server on the card and one on the CPU (plain
    versions): 3 flushes of the CNN-sized qsgd4 path must agree bit for
    bit; and the quickstart on both devices."""
    import torch

    from repro_torch.common import prng
    from repro_torch.core import QAFeL
    from repro_torch.core.protocol import CLIENT_UPDATE, Message
    from repro_torch.core.quantizers import packed_qsgd_payload
    from repro_torch.examples import federated_celeba as fc
    from repro_torch.examples import quickstart
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import init_cnn

    def unused(params, batch, key):
        raise AssertionError("no training here")

    params0 = init_cnn(5)
    servers = {d: QAFeL(fc.qafel_config(), unused, params0, device=d)
               for d in ("cpu", dev)}
    gen = torch.Generator().manual_seed(9)
    n = servers["cpu"].state.n
    for i in range(3 * CNN_K):
        delta = torch.randn(n, generator=gen) * 1e-3
        packed, norms = ops.qsgd_quantize(delta, prng.PRNGKey(i), BITS)
        key = prng.split(prng.PRNGKey(100 + i))[1]
        out = {}
        for d, algo in servers.items():
            enc = packed_qsgd_payload(packed.to(d), norms.to(d), BITS, n,
                                      algo.state.layout)
            msg = Message(CLIENT_UPDATE, enc, 42_417.0,
                          {"version": max(0, algo.state.t - i % 3)})
            out[d] = algo.receive(msg, key, n_receivers=4)
        if out["cpu"] is not None:
            for field in ("packed", "norms"):
                assert bits_equal(out["cpu"].payload[field],
                                  out[dev].payload[field].cpu()), field
    for name in ("x_flat", "hidden_flat", "momentum_flat"):
        assert bits_equal(getattr(servers["cpu"].state, name),
                          getattr(servers[dev].state, name).cpu()), name
    assert servers["cpu"].meter.summary() == servers[dev].meter.summary()
    q_cpu, sync_cpu = quickstart.run("cpu", 40, verbose=False)
    q_dev, sync_dev = quickstart.run(dev, 40, verbose=False)
    assert sync_cpu and sync_dev
    quick_equal = bits_equal(q_cpu.state.hidden_flat,
                             q_dev.state.hidden_flat.cpu())
    assert quick_equal, "quickstart x-hat differs between cpu and cuda"
    emit({"phase": "card_vs_cpu", "server_flushes": servers[dev].state.t,
          "server_bit_exact": True, "quickstart_bit_exact": quick_equal})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.common.device import resolve_device
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = resolve_device("cuda")
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    build_dir = _build.build_all(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "dir": str(build_dir.relative_to(ROOT))})

    cnn = check_kernels(CNN_ROWS, CNN_K, dev, reps=50, plain_reps=10)
    big = check_kernels(BIG_ROWS, CNN_K, dev, reps=10, plain_reps=3)
    torch.cuda.empty_cache()

    record, launches = run_main_path(dev)
    profile_window(dev)
    check_against_cpu(dev)

    kernels_line = []
    for name, m in cnn.items():
        b = big[name]
        kernels_line.append({
            "name": name, "route": "cuda", "source": m["source"],
            "replaces": m["replaces"], "launches": launches[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
            "equal": m["equal"], "bytes_formula": m["bytes_formula"],
            "d1e8": {"ms": b["ms"], "plain_ms": b["plain_ms"],
                     "bound_ms": b["bound_ms"], "equal": b["equal"],
                     "max_abs_err": b["max_abs_err"]}})
    print(smi, flush=True)
    emit({"kernels": kernels_line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
