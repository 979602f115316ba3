#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. the card's name and power limit (``nvidia-smi``);
2. build of the eleven CUDA kernel libraries from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once), timed; the int32 instructions
   per element of the in-kernel threefry dither and of the batched
   encode's counter hash, by pipe, and the decode kernels' int32
   instruction counts, from the built SASS (``cuobjdump -sass``);
3. each kernel against its plain PyTorch version on the card, bit for bit
   (``torch.equal`` on the bit patterns), at the main path's shapes (the
   CNN: 624 rows, K = 10, qsgd4) and at d = 1e8 (781,250 rows): median
   device time per launch, the plain version's time and the bound with its
   formula; then the b=1 upload at d = 1e8 before (``prng.uniform`` + the
   given-uniforms kernel) and after (the fused entry), in one run; then
   silu by the reference's law (``csrc/silu.cu``, one launch each way)
   against its plain version (``xla_math.silu_fwd`` / ``silu_bwd``) bit for
   bit (a nan as a nan) over 2^24 values on [-100, 100], 2^20 on the tail
   [-88.8, -87.3] where XLA:CPU flushes the logistic to zero, and the
   special values (zeros, subnormals, infinities, nan), the length not a
   multiple of 4, from an aligned and a misaligned start: device ms
   against the byte bound, the plain version's and ``F.silu`` /
   ``aten.silu_backward`` as the library time, registers and blocks an
   SM, and the same at mamba2-1.3b's conv output and gate at the round's
   seq 64 and at ``train_4k`` (``silu_kernel``); then the loss's
   logsumexp (``csrc/logsumexp.cu``: the forward, its sum-only and
   log-only modes, the backward) against its plain version
   (``logsumexp.plain_*``) bit for bit on a (64, 256,000) chunk, a view
   one float off the 16-byte grid and one loss chunk (128 rows) of each
   pool vocabulary, special rows included; the device launches of a
   forward (amax and the kernel: 2) and a backward (1) by the profiler;
   device ms against ``torch.logsumexp`` / ``torch.exp`` and the byte
   bound (``logsumexp_kernel``);
4. the cohort path's kernel shapes the same way: K2 as the cohort upload
   at B = 32 over 624 rows in qsgd4 and qsgd2, at B = 512 (the population
   path) and at B = 8 over d = 1e8, K3 decoding a qsgd2 tier upload at
   624 rows and K3's eager variant over a lowrank window;
5. the b=1 upload under ``torch.profiler``: device launches of one
   ``ops.qsgd_quantize`` (exactly one) against the old composition's, and
   device launches per client step; and one broadcast encode as the flush
   makes it (``ops.qsgd_quantize_batch``): exactly one device activity;
6. the main path through its entry points: ``AsyncFLSimulator`` driving
   ``QAFeL`` on the paper's CNN at full width (79,842 parameters), the
   federated example's configuration, concurrency 16, 100 uploads, with the
   launch counters set to 0 just before and read just after; then a short
   second run under ``torch.profiler``: the device's idle share, launches
   per upload and busiest kernels;
7. the cohort path through its entry points: ``CohortAsyncFLSimulator``
   driving ``QAFeL`` on the same CNN and task under ``tiered_bits`` (30%
   of the clients upload qsgd2), concurrency 100, cohorts of 32, 200
   uploads, the launch counters set to 0 just before and read just after;
   the peak memory of one such client step of 32 members, per member and
   parameter, against the member-chunk rule's constant; then the same run
   again under ``torch.profiler``;
8. the server path on the card against the CPU's plain versions on
   identical uploads, the quickstart on both devices, and the cohort
   engine on the quad task (cohorts of 4, ``tiered_bits``) on both
   devices, bit for bit;
9. telemetry: the two metric-tap kernels (``flush_taps.cu``,
   ``upload_taps.cu``) against their plain versions, bit for bit, timed
   with their byte bounds, at the CNN's flush (and its identity case),
   b = 1 qsgd4, B = 32 in qsgd4, qsgd2 and identity, and d = 1e8 (the
   flush, B = 8); the cohort path with a ``RunTracer(taps=True)`` and with
   no tracer in this process (state bit-identical, trace valid under
   ``build/telemetry/``, one more launch per flush and per tier group by
   the counters and the profiler, uploads/s and flush median taps off and
   on in turns); the main path with taps on for 10 uploads (one more
   launch per client step and per flush); the quad's traced cohort run on
   the card and the CPU, event streams bit for bit;
10. the quantizer family: K1, K2 and K3 at the lowrank uplink's shapes
    (the CNN's 2,496 rank coordinates, b = 1 and B = 32) against their
    plain versions; the quad task on the card and the CPU bit for bit,
    taps on (the cohort engine under lowrank4g32 clients and a qsgd4
    server in cohorts of 1 and 4, the sequential engine with qsgd4 clients
    under a top_k0.1 server and rand_k0.1 clients under a qsgd4 server:
    state, every upload and broadcast, every residual, the event streams);
    three runs on the full-width CNN with the federated example's
    configuration, the launch counters set to 0 just before and read just
    after (sequential, qsgd4 under top_k0.1, 100 uploads; sequential,
    lowrank4g32 under qsgd4, 40 uploads; cohorts of 32, lowrank4g32, 200
    uploads): uploads/s, flush median, launches per kernel, device
    launches of one client step and one flush, replicas in sync, bytes
    per upload and per broadcast against the exact 1,328 / 63,880 /
    42,417 B, and the lowrank cohort step's peak memory per member and
    parameter against the member-chunk rule; then one lowrank b = 1 upload
    at d = 1e8 (projection, K1, K3, expand, residual) timed by CUDA
    events, with its device launches;
11. the population engine: the quad task (cohorts of 4, 40 uploads,
    in-step draws under ``lognormal_dropout`` and ``trace_replay``) on the
    card and the CPU, every macro step's packed output and the final
    population state bit for bit (``population_quad_card_vs_cpu``); the
    cohort path's configuration under the cohort engine and under
    ``PopulationAsyncFLSimulator(draws="host")`` with cuDNN's
    deterministic algorithms, state bit for bit and the trajectory equal
    (``population_host_vs_cohort``); the CNN at full width under in-step
    ``lognormal_dropout`` draws, concurrency 1,000, cohorts and pops of
    512, 2,400 uploads, the launch counters set to 0 just before and read
    just after: uploads/s, macro steps of each kind with their median ms
    (CUDA events) and device launches, a profiled run's idle share, one
    512-member client step's peak memory per member and parameter
    (``population_cnn``); ``PopulationEngine`` at 100,000 clients to
    horizon 1.0 and 1,000,000 clients to 0.05 (``population_engine``:
    events/s, ms and launches per macro step, state bytes); and the CNN's
    gradients against the reference's eager ones from the committed
    fixture, twice with cuDNN's default algorithms
    (``cnn_grad_vs_fixture``);
12. the LLM round (ROADMAP queue A items 14a, 13a): ``distributed.steps
    .make_qafel_round`` on gemma2-2b at full width and its published depth
    (26 layers, d = 2,614,341,888) in bf16, every message encoded in row
    chunks of 2^20 rows, remat on, the federated example's settings (qsgd4
    both ways, K = 4, P = 2, local batch 2, sequence 64): one warm-up and
    2 measured rounds with the launch counters set to 0 just before and
    read just after (``llm_round_step`` lines: loss, |x - x_hat|_1, ms by
    CUDA events; ``llm_round``: peak ``max_memory_allocated`` against the
    reckoning of the round's buffers plus 15% and under 60 GB, K1, K3 and
    server-update launches per round against the design's formula by the
    counters and by ``torch.profiler`` over a fifth round, that round's
    device time by phase (the round's ``record_function`` ranges: client
    (local SGD and K1), accumulate (K3 into the weighted sum), server and
    broadcast; each kernel counted in the range its launch was made in),
    bytes per upload against (4 d + 32 ceil(d/128)) / 8); one more round
    with the taps on (``llm_round_taps``: its ms, its launches (one
    finishing launch more), the seven taps finite, its peak against the
    reckoning with the tap rows) and a taps-off and a taps-on round timed
    by CUDA events from the last upload on (the device ms the taps add to
    the server half and after the broadcast); then
    serving the x that round trained, hidden state and momentum freed
    (``launch.serve.serve``): ``serve_gemma2`` (B = 4, prompt 64, 32
    greedy steps: prefill ms, each decode step by CUDA events, tokens/s,
    device launches per decode step and the idle share of the decode loop
    from a profiled call, the byte bound of a step, peak memory, the
    cache's k and v bytes against their count, decode against forward at
    the last position) and ``serve_gemma2_long`` (B = 1, prompt 4,160 past
    the local layers' 4,096-slot ring, 64 steps: the cache's bytes, every
    ``slot_pos`` against the ring law, decode against forward); then at
    the round's d K1 over the whole message and in the round's row chunks
    at their row offsets, K3 plain, K3's weighted add into an f32 sum in
    place, its broadcast decode into a bf16 x-hat in place and that apply
    with the round's taps, the server-update kernel on a bf16 state
    without and with the taps, and the taps' finishing pass, each against
    its plain version taken in chunks, bit for bit, timed with its bound
    (``llm_kernel``); then gemma2-2b cut to 2 layers, a taps-off and a
    taps-on round from clones of one state bit-equal, the taps equal to
    ``ref.round_taps`` over the materialized vectors
    (``llm_round_taps_2layer``); one round whole and one in ragged row
    chunks of 4,099 from the same state, bit for bit, with each round's
    peak (``llm_streamed_vs_whole``); then the reduced round on the card
    and the CPU in row chunks, 2 rounds, and its server half
    (``steps.accumulate`` and ``steps.server_half``) on identical client
    messages bit for bit (``llm_reduced_card_vs_cpu``); the reduced
    config served on the card and the CPU (B = 2, 32 tokens, 8 steps,
    with and without a window): logits within the CPU tests' bound,
    tokens and ``slot_pos`` equal (``serve_reduced_card_vs_cpu``); then
    the training launcher (``launch.train.run``) on gemma2-2b as published
    at its defaults (seq 128, global batch 32, K = 4, P = 1, qsgd4 both
    ways, remat off), 4 rounds with the launch counters set to 0 just
    before and read just after: losses, K1, K3 and server-update
    launches, peak under 60 GB, bytes per upload, and its msgpack
    checkpoint of x (bytes, seconds to write and to read, the reloaded x
    bit-equal to the trained x), then ms per round by CUDA events over 3
    more rounds of its round function (``train_launcher``); then the
    round under the other quantizers at full width and 2 layers, two
    rounds each (the first cold) for a lowrank4g32 client under a
    top_k0.1 server, rand_k0.1 and identity both ways (``llm_quantizers``:
    ms, peak, metered bytes, launches by kernel), and the reduced config's
    server half under each
    non-qsgd server kind bit for bit card vs CPU
    (``llm_quantizers_card_vs_cpu``); then the rest of the attention-only
    pool (ROADMAP queue A items 14c.1, 14c.2): ``musicgen_round`` and
    ``internvl2_round``, musicgen-large (48 layers, four codebooks, d =
    3,254,978,560, past 2^31) and internvl2-1b (24 layers, 256 patch
    embeddings + 64 tokens) as published through the same round and
    settings, one warm-up and 1 round timed by CUDA events with the
    launch counters set to 0 just before and read just after (K1, K3 and
    server-update launches by name, peak against the reckoning plus 15%
    and under 60 GB, bytes per upload), a profiled round's device busy ms
    and launches; each trained x served (``serve_musicgen``: B = 4,
    prompt 64 of (B, 64, 4) codebook tokens, 32 greedy (B, 4) steps;
    ``serve_internvl2``: prompt 320 counting the patch embeddings, 32
    steps); K1, K3 (plain, weighted add, bf16 apply) and the server update
    at musicgen-large's d, bit for bit against their plain versions on the
    2^18 rows across element 2^31 and on the last 2^18 rows (``llm_kernel``
    lines named ``*_musicgen``); ``serve_dense_siblings``: codeqwen1.5-7b
    and qwen3-14b at full size and granite-34b at full width cut to 24 of
    its 88 layers (its 94.5 GB of bf16 weights exceed the card), B = 4,
    prompt 64, 32 greedy steps, and the granite cut one step with
    ``window_override = 16``: prefill and step ms, the caches' bytes and
    ``slot_pos`` laws, decode against forward; then
    ``llm_reduced_card_vs_cpu`` (one round) and
    ``serve_reduced_card_vs_cpu`` over the five reduced configs; then
    Mamba2 and the hybrid (``run_mamba``): ``mamba2_round``, the same
    round on mamba2-1.3b as published (48 layers, its mixed bf16/f32 state
    in place: ``A_log``, ``D`` and ``dt_bias`` f32 beside the bf16
    buffers), ``serve_mamba2`` (its trained x: B = 4, prompt 64, 32 steps;
    B = 1, a prompt of 4,160 that pads the SSD's last chunk; the recurrent
    cache's bytes by count and constant in the prompt, launches a step),
    K1, K3 and the server update at its d (``*_mamba2``),
    ``zamba2_round`` (zamba2-7b cut to 20 of its 27 super-blocks, d past
    2^31), K1, K3 and the server update at its d (``*_zamba2``),
    ``serve_zamba2`` (all 81 layers, fresh weights), and both reduced
    configs card against CPU (a round, the server half in f32 and on the
    mixed bf16/f32 tree bit for bit, serving); then MoE and MLA
    (``run_moe``): ``qwen3_moe_round``, the same round on
    qwen3-moe-235b-a22b at full width cut to 1 of its 94 layers (128
    experts of 1,536, top-8; d = 3,732,418,816, past 2^31; the share of
    token copies dropped at capacity factor 1.25, capacity 10 an expert),
    ``serve_qwen3_moe`` (its x: B = 4, prompt 64, 32 steps: the decode's
    drop share at the published factor 2.0, one slot an expert), K1, K3
    and the server update at its d (``*_qwen3moe``),
    ``serve_deepseek`` and ``serve_deepseek_long`` (deepseek-v3-671b at
    full width, fresh weights, 1 routed layer and its 3 dense prefix
    layers: B = 4 at prompt 64, B = 1 at 4,160; the MLA latent caches'
    bytes against (512 + 64) * 2 B a token and layer), each served model
    also on its no-drop ``replace`` with decode against forward, and both
    reduced configs card against CPU (a round with MLA, the prefix and the
    MTP term, the server half, the routing ids, serving);
12b. the assigned shapes (``launch/shapes.py``): ``shapes_reckoning``
    (every arch of the registry x ``train_4k``, ``prefill_32k``,
    ``decode_32k``, ``long_500k`` from ``input_specs`` on ``meta``: bytes of
    the parameters, round state, cache and inputs, ``llm_peak_reckoning``
    for the round, whether the pair fits under the 60 GB gate and the
    largest global batch that does); then on gemma2-2b (26 layers) and
    mamba2-1.3b (48 layers) at full width, each cell printing the
    published shape, its cut, ms by CUDA events, tokens/s, peak against
    the reckoning, device launches and idle share from a device profile,
    finite logits or loss: ``shape_train_4k`` (``make_qafel_round`` at K =
    8, P = 1, seq 4,096, qsgd4 both ways, remat, the local batch cut; K1,
    K3 and the update launches by the counters), ``shape_prefill_32k``
    (``transformer.prefill`` of 32,768-token prompts, B cut),
    ``shape_decode_32k`` (a 32,768-position cache, row 0 the prefill's
    first prompt and held against its logits, the other rows drawn from a
    seed; gemma2-2b's B cut, mamba2-1.3b at B = 128) and
    ``shape_long_500k`` (B = 1, the caches of the 8,192 window filled from
    a seed, 32 greedy steps from 524,272 across the rings' wrap, one more
    step against the same decode recomputed: the window's positions in a
    linear cache, or mamba2 at position 0, bit for bit);
13. the streamed uplink (``QAFeL.run_client_stream``, then ``receive``
    chunk by chunk) against ``run_client``: the quickstart's quad on the
    card and the CPU, the paper's CNN on the card; codes, broadcasts,
    state and meters bit for bit, the quad card against the CPU, K1
    launches per streamed upload (``streamed_uplink``);
13b. the flat mesh (``flat_mesh``): a one-rank NCCL group (a
    ``FileStore`` in a temporary directory under ``build/``), its
    ``make_sim_mesh(1)`` and ``QAFeL(mesh=)`` on the paper's CNN for 10
    flushes against the meshless run, bit for bit; then
    ``kernels.ops.flush_segment`` at d = 1e8, K = 10, qsgd4 both ways, for
    the 4 segments of a ("data",) extent of 4 and of the (2, 2) fold, one
    after another on this card with no group, whole and in row chunks of
    2^16, the segments concatenated against the unsharded flush bit for bit
    (x, x-hat, m, codes, norms, the taps of the gathered parts), one
    segment's kernel launches, and the ms of one segment's flush and of
    the unsharded flush;
13c. the LLM round on a ("data", "model") mesh (``model_mesh``): a
    one-rank NCCL group on a (1, 1) mesh; gemma2-2b at full width cut to
    2 layers, ``make_qafel_round(mesh=)`` against the meshless round from
    the same seeds for 2 rounds (the second with taps): x, x-hat, m, the
    loss, the wire bytes and the taps bit for bit on host copies; the
    launcher at 26 layers under the group (its host mesh) for 2 rounds:
    peak against the meshless launcher's (within 5%), K1 / K3 / update
    launches, one more round profiled (ms, device launches); then the
    ``mesh_reckoning`` lines: each arch at the LLM round's settings and
    at ``train_4k`` on (1, 4), (2, 2), (4, 1) and (16, 16), the
    reference's per-rank state bytes and the port's per-rank round
    reckoned on its layout, against the 60 GB gate;
14. one line listing every kernel (``silu_forward`` and ``silu_backward``
    with ``F.silu`` / ``aten.silu_backward`` as the library time, their
    launches on mamba2-1.3b's round; ``logsumexp_forward`` /
    ``logsumexp_backward`` with ``torch.logsumexp`` / ``torch.exp``, their
    launches on the LLM round's loss; each kernel's launches in one
    segment's flush of ``flat_mesh`` and in the mesh launcher's rounds of
    ``model_mesh``) with its launches on both paths, on
    the family's runs, on the population run, on the LLM round, the
    launcher's rounds, the quantizer rounds and the musicgen-large,
    internvl2-1b, mamba2-1.3b, zamba2-7b and qwen3-moe-235b-a22b rounds,
    times
    and bound (the tap kernels' launches from the taps-on runs; the
    server update's from the LLM round, the only path that runs it; the
    round's finishing pass from its taps-on round);
15. each phase's wall seconds (``phase_seconds`` lines), then the card's
    name and power limit, the kernels line and last ``{"ok": true,
    "device": {...}}``.

Any failure raises and the script exits non-zero; without a CUDA device it
exits non-zero before printing any result. Every record is also written
to ``build/chip_smoke.jsonl``, since a remote run may return only the end
of the output. Times come from CUDA events
(kernels) or the host clock around synchronized work (the main path syncs
around every client step, flush and eval to time them). The bounds use
the H100 SXM's published 3.35 TB/s and 67 TFLOP/s (float32, no tensor
cores), and for integer work 64 lanes per SM and clock on each of the
two pipes that take int32 instructions (the CUDA programming guide's rate
for compute capability 9.0): IMAD and IMUL issue on the FMA pipe, the
other int32 instructions on the int32 ALU, so the two overlap and the
larger count bounds; at the card's SM count and maximum SM clock
(``nvidia-smi``).
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
INT32_LANES_PER_SM = 64  # per pipe; CUDA programming guide, capability 9.0
# SASS opcodes of per-lane int32 work (the uniform datapath's U*
# instructions run once per warp and are not counted); IMAD and IMUL issue
# on the FMA pipe, the others on the int32 ALU
FMA_PIPE_OPCODES = frozenset(("IMAD", "IMUL"))
INT32_OPCODES = FMA_PIPE_OPCODES | frozenset((
    "IADD3", "IADD", "VIADD", "LOP3", "LOP", "SHF", "LEA", "ISETP", "IMNMX",
    "VIMNMX", "PRMT", "IABS", "SEL", "SGXT", "BMSK", "BREV", "FLO", "POPC"))
CNN_N, CNN_ROWS, CNN_K, BITS = 79_842, 624, 10, 4
BIG_ROWS = 781_250  # d = 1e8
MAIN_UPLOADS, CONCURRENCY = 100, 16
# the cohort path: tiered_bits, 200 uploads at concurrency 100 in cohorts
# of 32; K2 is also held at B = 8 over d = 1e8 (3.2 GB of input)
COHORT_UPLOADS, COHORT_CONCURRENCY, COHORT_SIZE, COHORT_BIG_B = 200, 100, 32, 8
# population_cnn: the reference's population operating point on the CNN
POP_UPLOADS, POP_CONCURRENCY, POP_COHORT = 2400, 1000, 512
POP_PROFILE_UPLOADS = 1024
# PopulationEngine rows: (clients, horizon)
POP_ENGINE_ROWS = ((100_000, 1.0), (1_000_000, 0.05))
FIXTURE = ROOT / "tests" / "fixtures_torch" / "cnn_grad_ref.npz"
# the card's CNN gradients against the CPU reference's eager ones
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


_T0 = time.perf_counter()
_LOG = []  # the open record log, once ``main`` has opened it


def emit(obj) -> None:
    """Print one record as a JSON line, and append it to the record log; a
    phase record gets the seconds since the script started
    (``elapsed_s``)."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
    line = json.dumps(obj)
    print(line, flush=True)
    for log in _LOG:
        log.write(line + "\n")
        log.flush()


_PHASE_SECONDS = []  # (phase, wall seconds), printed before the kernels


def timed(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds kept under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    _PHASE_SECONDS.append((name, time.perf_counter() - t0))
    return out


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


def launch_floor_ms(dev, reps: int = 200) -> float:
    """``device_ms`` of a kernel that does no work to speak of (one float
    set to 0): what a launch costs by that measure, the floor of every
    small case."""
    import torch

    t = torch.empty(1, device=dev)
    return device_ms(t.zero_, reps)


# Hopper's per-SM limits (CUDA programming guide, compute capability 9.0)
SM_REGS, SM_WARPS, SM_BLOCKS, SM_SMEM, BLOCK_SMEM_RESERVED = (
    65_536, 64, 32, 233_472, 1_024)


def kernel_resources(lib: Path, kernel: str, threads: int,
                     dynamic_smem: int = 0) -> dict:
    """Registers a thread and static shared bytes of the kernels whose
    (mangled) name contains ``kernel`` in the built library ``lib``
    (``cuobjdump -res-usage``; the largest over their instantiations), and
    the blocks an SM holds at ``threads`` a block with ``dynamic_smem``
    bytes more, by Hopper's limits: registers in units of 256 a warp,
    shared memory in units of 128 B plus 1 KB a block, 64 warps, 32
    blocks. ``occupancy`` is the resident warps' share of 64."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-res-usage", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    regs = smem = 0
    lines = text.splitlines()
    for i, line in enumerate(lines[:-1]):
        if "Function" in line and kernel in line:
            m = re.search(r"REG:(\d+).*SHARED:(\d+)", lines[i + 1])
            if m:
                regs = max(regs, int(m.group(1)))
                smem = max(smem, int(m.group(2)))
    warps = threads // 32
    by_regs = SM_REGS // (-(-regs * 32 // 256) * 256 * warps) if regs else 0
    block_smem = -(-(smem + dynamic_smem) // 128) * 128 + BLOCK_SMEM_RESERVED
    blocks = min(SM_BLOCKS, SM_WARPS // warps, by_regs,
                 SM_SMEM // block_smem)
    return {"registers": regs, "static_smem": smem,
            "dynamic_smem": dynamic_smem, "blocks_per_sm": blocks,
            "occupancy": blocks * warps / SM_WARPS}


def tap_resources(build_dir: Path) -> dict:
    """``kernel_resources`` of the three tap kernels (the wrappers' block
    size and dynamic shared bytes, ``kernels.taps.THREADS`` and
    ``SMEM_BYTES``, where the build has them; 128 threads and none
    before)."""
    from repro_torch.kernels import taps

    threads = getattr(taps, "THREADS", 128)
    smem = getattr(taps, "SMEM_BYTES", {})
    return {name: kernel_resources(build_dir / f"lib{name}.so",
                                   f"{name}_kernel", threads,
                                   smem.get(name, 0))
            for name in ("flush_taps", "upload_taps", "round_taps")}


def bits_equal(a, b) -> bool:
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def sass_int32_ops(lib: Path, kernel: str) -> dict:
    """Int32 instructions in the SASS of the kernels whose (mangled) name
    contains ``kernel``, in the built library ``lib``, by pipe: ``fma``
    (IMAD, IMUL) and ``alu`` (the others)."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts = {"fma": 0, "alu": 0}
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z0-9]+)", line)
            if m and m.group(1) in INT32_OPCODES:
                pipe = "fma" if m.group(1) in FMA_PIPE_OPCODES else "alu"
                counts[pipe] += 1
    return counts


def per_element(work: dict, base: dict, elements: int) -> dict:
    """Int32 instructions per element of what ``work`` has beyond ``base``,
    for ``elements`` elements per thread: ``total`` over both pipes, and by
    pipe (a pipe where ``work`` has fewer counts 0); ``bound`` is the larger
    pipe's, the one that sets the time."""
    pipes = {p: max(0, work[p] - base[p]) / elements for p in ("fma", "alu")}
    total = (sum(work.values()) - sum(base.values())) / elements
    return {**pipes, "total": total, "bound": max(pipes.values())}


def dither_ops(build_dir: Path) -> dict:
    """Int32 instructions per element of the in-kernel threefry dither, by
    pipe: the fused kernel's int32 SASS instructions minus those of the
    given-uniforms kernel (the same row body, reading u instead), over the
    four elements a thread quantizes."""
    fused = sass_int32_ops(build_dir / "libquantize_pack_threefry.so",
                           "quantize_pack_threefry_kernel")
    given = sass_int32_ops(build_dir / "libquantize_pack.so",
                           "quantize_pack_kernel")
    ops = per_element(fused, given, 4)
    emit({"phase": "sass", "fused_int32_instructions": fused,
          "given_u_int32_instructions": given,
          "dither_int32_per_element": ops["total"],
          "dither_int32_per_element_by_pipe": ops,
          "formula": "(int32 SASS of quantize_pack_threefry_kernel - int32 "
                     "SASS of quantize_pack_kernel) / 4 elements per thread, "
                     "by pipe (fma: IMAD, IMUL; alu: the others)"})
    if ops["total"] < 60:  # 20 rounds of add, rotate and xor at the least
        raise AssertionError(f"dither counted at {ops['total']} int32 "
                             "instructions per element: the SASS parse failed")
    return ops


def batch_encode_ops(build_dir: Path) -> dict:
    """Int32 instructions per element of the batched encode's counter hash
    (K2), by pipe, in each of its two qsgd4 kernels (``whole``: messages of
    whole aligned rows; ``general``: any message): the kernel's int32 SASS
    instructions minus those of the same source built with
    ``QSGD_BATCH_CONSTANT_DITHER`` (a constant dither in place of the hash),
    over the 32 elements a thread quantizes per loop pass (the loop body is
    the kernel's only copy of the encode). Printed beside them, the int32
    SASS counts of the decode kernels (K3, and K4 summed over its
    instantiations) so that they can be compared between checkouts."""
    from repro_torch.kernels import _build

    lib = build_dir / "libquantize_pack_batch.so"
    base_lib = build_dir / "libquantize_pack_batch_constant_dither.so"
    if not base_lib.exists():
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                        "-DQSGD_BATCH_CONSTANT_DITHER", "-I", str(_build.CSRC),
                        "-o", str(base_lib),
                        str(_build.CSRC / "quantize_pack_batch.cu")],
                       capture_output=True, text=True, check=True)
    record, ops = {"phase": "sass_decode_encode"}, {}
    for variant, flag in (("whole", 1), ("general", 0)):
        name = f"quantize_pack_batch_kernelILi4ELb{flag}E"
        hashed = sass_int32_ops(lib, name)
        constant = sass_int32_ops(base_lib, name)
        ops[variant] = per_element(hashed, constant, 32)
        record[f"batch_encode_{variant}"] = {
            "int32_instructions": hashed,
            "constant_dither_int32_instructions": constant,
            "hash_int32_per_element": ops[variant]}
    emit({**record,
          "formula": "(int32 SASS of quantize_pack_batch_kernel<4, kWhole> "
                     "- int32 SASS of it built with a constant dither) / 32 "
                     "elements per thread and loop pass, for each kWhole, by "
                     "pipe (fma: IMAD, IMUL; alu: the others)",
          "unpack_dequantize_int32_instructions": sass_int32_ops(
              build_dir / "libunpack_dequantize.so",
              "unpack_dequantize_kernel"),
          "buffer_aggregate_int32_instructions": sass_int32_ops(
              build_dir / "libbuffer_aggregate.so", "buffer_aggregate_kernel")})
    for variant, o in ops.items():
        if o["total"] < 16:  # two fmix32 rounds at the least
            raise AssertionError(f"counter hash ({variant} kernel) counted at "
                                 f"{o['total']} int32 instructions per "
                                 "element: the SASS parse failed")
    return ops


def kernel_cases(rows: int, k: int, dev, dither_int32: dict,
                 hash_int32: dict, int32_ops_per_s: float):
    """Inputs of the five kernels at ``rows`` wire rows (K messages for the
    aggregate), their byte and operation counts with the rate that bounds
    the operations, and the TPU kernel each replaces. The int32 counts per
    element are ``dither_ops``' and ``batch_encode_ops``' (the larger pipe
    bounds; for K2, that of the kernel the message takes)."""
    import torch

    from repro_torch.common import prng
    from repro_torch.kernels import buffer_agg, qsgd, ref

    gen = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn((rows, 128), generator=gen, device=dev) * 0.01
    x[rows // 2] = 0.0  # an all-zero bucket
    u = prng.uniform(prng.PRNGKey(1), (rows, 128), device=dev)
    key = torch.tensor([0x9E3779B9, 0xFFFFFFF0])  # both words >= 2**31
    keys = prng.split(prng.PRNGKey(2), k)
    stack, norms = qsgd.qsgd_quantize_pack_batch(
        x[None].expand(k, rows, 128).contiguous(), keys, BITS)
    w = torch.rand(k, generator=gen, device=dev) / k
    code_b = 128 * BITS // 8
    n = rows * 128
    # the b=1 upload and the broadcast encode take the flat message: the
    # CNN's is ragged
    n_flat = CNN_N if rows == CNN_ROWS else n
    hash_ops = hash_int32["whole" if n_flat % 128 == 0 else "general"]
    f32 = (F32_OPS_PER_S, "float32")
    int32 = (int32_ops_per_s, "int32")
    return {
        "qsgd_quantize_pack": dict(
            source="src/repro_torch/kernels/csrc/quantize_pack.cu",
            replaces="src/repro/kernels/qsgd.py:70",
            fn=qsgd.qsgd_quantize_pack, plain=ref.quantize_pack,
            args=(x, u, BITS),
            bytes=n * 8 + rows * (code_b + 4),
            bytes_formula="rows*128*(4 x + 4 u) + rows*(128*bits/8 + 4)",
            ops=n * 8 + rows * 4, rate=f32),
        "qsgd_quantize_pack_threefry": dict(
            source="src/repro_torch/kernels/csrc/quantize_pack_threefry.cu",
            replaces="src/repro/kernels/qsgd.py:70",
            fn=qsgd.qsgd_quantize_pack_threefry,
            plain=ref.quantize_pack_threefry,
            args=(x.reshape(-1)[:n_flat], key, BITS),
            bytes=n_flat * 4 + rows * (code_b + 4),
            bytes_formula="n*4 x + rows*(128*bits/8 + 4)",
            ops=n_flat * dither_int32["bound"],
            ops_formula=f"n*max(fma {dither_int32['fma']}, alu "
                        f"{dither_int32['alu']}) int32 per element (SASS) / "
                        "(SMs*64*max SM clock)",
            rate=int32),
        # as the flush calls it: one flat message, seed words from the CPU
        "qsgd_quantize_pack_batch": dict(
            source="src/repro_torch/kernels/csrc/quantize_pack_batch.cu",
            replaces="src/repro/kernels/qsgd.py:160",
            fn=qsgd.qsgd_quantize_pack_batch_flat,
            plain=lambda f, s, b: ref.quantize_pack_batch(ref.rows2d(f), s, b),
            args=(x.reshape(-1)[:n_flat][None], keys[:1], BITS),
            bytes=n_flat * 4 + 8 + rows * (code_b + 4),
            bytes_formula="B*n*4 x + B*8 seeds + B*rows*(128*bits/8 + 4)",
            ops=n_flat * hash_ops["bound"],
            ops_formula=f"B*n*max(fma {hash_ops['fma']}, alu "
                        f"{hash_ops['alu']}) int32 per element (SASS) / "
                        "(SMs*64*max SM clock)",
            rate=int32),
        "qsgd_unpack_dequantize": dict(
            source="src/repro_torch/kernels/csrc/unpack_dequantize.cu",
            replaces="src/repro/kernels/qsgd.py:356",
            fn=qsgd.qsgd_unpack_dequantize, plain=ref.unpack_dequantize,
            args=(stack[0], norms[0], BITS),
            bytes=rows * (code_b + 4) + n * 4,
            bytes_formula="rows*(128*bits/8 + 4) + rows*128*4 out",
            ops=n * 4, rate=f32),
        "buffer_aggregate": dict(
            source="src/repro_torch/kernels/csrc/buffer_aggregate.cu",
            replaces="src/repro/kernels/buffer_agg.py:61",
            fn=buffer_agg.buffer_aggregate, plain=ref.buffer_aggregate,
            args=(stack, norms, w, BITS),
            bytes=k * rows * (code_b + 4) + k * 4 + n * 4,
            bytes_formula="K*rows*(128*bits/8 + 4) + K*4 + rows*128*4 out",
            ops=k * n * 6, rate=f32),
    }


def measure_case(name: str, case: dict, reps: int, plain_reps: int) -> dict:
    """One kernel case against its plain version on the same inputs, bit
    for bit (raises on a difference), then both timed; with the bound."""
    import torch

    got = case["fn"](*case["args"])
    want = case["plain"](*case["args"])
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    equal = all(bits_equal(g, w) for g, w in zip(got, want))
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got, want))
    if not equal:
        raise AssertionError(f"{name}: kernel and plain version differ "
                             f"(max abs err {err})")
    del got, want
    ops_rate, ops_type = case["rate"]
    bytes_s, ops_s = case["bytes"] / HBM_BYTES_PER_S, case["ops"] / ops_rate
    return dict(
        source=case["source"], replaces=case["replaces"],
        equal=equal, max_abs_err=err,
        ms=device_ms(lambda: case["fn"](*case["args"]), reps),
        plain_ms=device_ms(lambda: case["plain"](*case["args"]), plain_reps),
        bound_ms=1e3 * max(bytes_s, ops_s),
        bound_by="bytes" if bytes_s >= ops_s else "operations",
        bytes=case["bytes"], bytes_formula=case["bytes_formula"],
        bytes_ms=1e3 * bytes_s, ops=case["ops"], ops_type=ops_type,
        ops_ms=1e3 * ops_s,
        ops_formula=case.get("ops_formula", f"counted / {ops_type} peak"))


def check_kernels(rows: int, k: int, dev, reps: int, plain_reps: int,
                  dither_int32: dict, hash_int32: dict,
                  int32_ops_per_s: float):
    """Each kernel against its plain version at one shape; returns the
    per-kernel measurements."""
    out = {}
    for name, case in kernel_cases(rows, k, dev, dither_int32, hash_int32,
                                   int32_ops_per_s).items():
        out[name] = measure_case(f"{name} at rows={rows}", case, reps,
                                 plain_reps)
        emit({"phase": "kernel", "name": name, "rows": rows, "k": k,
              **{key: v for key, v in out[name].items()
                 if key not in ("source", "replaces")}})
    return out


def cohort_kernel_cases(dev, hash_int32: dict, int32_ops_per_s: float):
    """The cohort path's new kernel shapes: K2 as the cohort upload (the
    flat (B, n) delta stack as ``encode_deltas`` hands it over, seed words
    from the CPU) at B = 32 over the CNN's 624 rows in qsgd4 and qsgd2, at
    B = 512 (the population path's cohorts) and at B = 8 over d = 1e8; K3
    decoding a qsgd2 tier upload at 624 rows, and K3's eager variant over
    a lowrank window of the non-fused flush chain (200 rows). The plain version of the B = 8 case runs message by message (a
    message's codes do not depend on its batch), which keeps its int64
    temporaries to one message's."""
    import torch

    from repro_torch.common import prng
    from repro_torch.kernels import qsgd, ref

    gen = torch.Generator(device=dev).manual_seed(11)
    int32 = (int32_ops_per_s, "int32")

    def plain_batch(f, s, b):
        return ref.quantize_pack_batch(ref.rows2d(f), s, b)

    def plain_by_message(f, s, b):
        parts = [ref.quantize_pack_batch(ref.rows2d(f[i:i + 1]), s[i:i + 1],
                                         b) for i in range(f.shape[0])]
        return (torch.cat([p for p, _ in parts]),
                torch.cat([nm for _, nm in parts]))

    def k2(b, n, bits, plain):
        x = torch.randn((b, n), generator=gen, device=dev) * 0.01
        x[:, 128:256] = 0.0  # an all-zero bucket
        seeds = prng.split_each(prng.split(prng.PRNGKey(b + bits), b))[:, 1]
        rows = ref.rows_for(n)
        hash_ops = hash_int32["whole" if n % 128 == 0 else "general"]
        return dict(
            source="src/repro_torch/kernels/csrc/quantize_pack_batch.cu",
            replaces="src/repro/kernels/qsgd.py:160",
            fn=qsgd.qsgd_quantize_pack_batch_flat, plain=plain,
            args=(x, seeds, bits),
            bytes=b * n * 4 + b * 8 + b * rows * (16 * bits + 4),
            bytes_formula="B*n*4 x + B*8 seeds + B*rows*(128*bits/8 + 4)",
            ops=b * n * hash_ops["bound"],
            ops_formula=f"B*n*max(fma {hash_ops['fma']}, alu "
                        f"{hash_ops['alu']}) int32 per element (SASS, qsgd4 "
                        "kernel) / (SMs*64*max SM clock)",
            rate=int32)

    cases = {f"K2_B{COHORT_SIZE}_qsgd{bits}_cnn":
             k2(COHORT_SIZE, CNN_N, bits, plain_batch) for bits in (4, 2)}
    p2, n2 = qsgd.qsgd_quantize_pack_batch_flat(
        cases[f"K2_B{COHORT_SIZE}_qsgd2_cnn"]["args"][0][:1],
        torch.tensor([[3, 4]]), 2)
    cases["K3_qsgd2_cnn"] = dict(
        source="src/repro_torch/kernels/csrc/unpack_dequantize.cu",
        replaces="src/repro/kernels/qsgd.py:356",
        fn=qsgd.qsgd_unpack_dequantize, plain=ref.unpack_dequantize,
        args=(p2[0], n2[0], 2),
        bytes=CNN_ROWS * (32 + 4) + CNN_ROWS * 128 * 4,
        bytes_formula="rows*(128*bits/8 + 4) + rows*128*4 out",
        ops=CNN_ROWS * 128 * 4, rate=(F32_OPS_PER_S, "float32"))
    # the population path's cohort upload
    cases[f"K2_B{POP_COHORT}_qsgd4_cnn"] = k2(POP_COHORT, CNN_N, 4,
                                              plain_batch)
    # the non-fused flush chain's eager decode of a K = 10 lowrank window
    # over the CNN's 2,496 rank coordinates (20 rows each)
    rows_w = CNN_K * 20
    xw = torch.randn((1, rows_w * 128), generator=gen, device=dev)
    pw, nw = qsgd.qsgd_quantize_pack_batch_flat(xw, torch.tensor([[5, 6]]),
                                                4)
    cases["K3_eager_qsgd4_lowrank_window_cnn"] = dict(
        source="src/repro_torch/kernels/csrc/unpack_dequantize.cu",
        replaces="src/repro/kernels/qsgd.py:356",
        fn=lambda p, nm, b: qsgd.qsgd_unpack_dequantize(p, nm, b, eager=True),
        plain=lambda p, nm, b: ref.unpack_dequantize(p, nm, b, eager=True),
        args=(pw[0], nw[0], 4),
        bytes=rows_w * (64 + 4) + rows_w * 128 * 4,
        bytes_formula="rows*(128*bits/8 + 4) + rows*128*4 out",
        ops=rows_w * 128 * 4, rate=(F32_OPS_PER_S, "float32"))
    cases[f"K2_B{COHORT_BIG_B}_qsgd4_d1e8"] = k2(
        COHORT_BIG_B, BIG_ROWS * 128, 4, plain_by_message)
    return cases


def check_cohort_kernels(dev, hash_int32: dict, int32_ops_per_s: float):
    """The cohort path's kernel shapes against their plain versions, bit
    for bit, timed with their bounds."""
    import torch

    out = {}
    for name, case in cohort_kernel_cases(dev, hash_int32,
                                          int32_ops_per_s).items():
        big = "d1e8" in name
        out[name] = measure_case(name, case, 10 if big else 50,
                                 1 if big else 10)
        emit({"phase": "cohort_kernel", "name": name,
              **{key: v for key, v in out[name].items()
                 if key not in ("source", "replaces")}})
        case.clear()
        torch.cuda.empty_cache()
    return out


def upload_before_after(dev, reps: int = 5):
    """The b=1 upload at d = 1e8 as it was (``prng.uniform`` drawn as int64
    tensor ops, then the given-uniforms kernel) and as it is (the fused
    entry, ``ops.qsgd_quantize``), timed in turns in this run."""
    import torch

    from repro_torch.common import prng
    from repro_torch.kernels import ops, qsgd

    gen = torch.Generator(device=dev).manual_seed(3)
    flat = torch.randn(BIG_ROWS * 128, generator=gen, device=dev) * 0.01
    key = prng.split(prng.PRNGKey(4))[1]

    def before():
        x2d = flat.reshape(BIG_ROWS, 128)
        return qsgd.qsgd_quantize_pack(
            x2d, prng.uniform(key, x2d.shape, device=dev), BITS)

    def after():
        return ops.qsgd_quantize(flat, key, BITS)

    equal = all(bits_equal(a, b) for a, b in zip(before(), after()))
    times = {"before_ms": [], "after_ms": []}
    for fn, name in ((before, "before_ms"), (after, "after_ms"),
                     (after, "after_ms"), (before, "before_ms")):
        times[name].append(device_ms(fn, reps))
    record = {"phase": "upload_d1e8", "rows": BIG_ROWS, "equal": equal,
              **{k: statistics.median(v) for k, v in times.items()},
              "runs": times}
    emit(record)
    if not equal:
        raise AssertionError("fused upload differs from uniform + kernel")
    torch.cuda.empty_cache()
    return record


def device_launches(fn) -> list:
    """(name, count) of every device activity (kernels, copies, sets) that
    ``torch.profiler`` records while ``fn`` runs. The profiler loses the
    activities of the first millisecond or so after it starts (seen on
    the H100 machine: none of a 1 ms flush's), so a device sleep of about
    10 ms runs first and is left out of the counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return [(name, c) for name, (c, _) in kernel_table(prof).items()]


def upload_launches(dev, steps: int = 5):
    """Device launches of one b=1 upload at the CNN's size (the fused entry
    against the old composition) and of one whole client step."""
    import torch

    from repro_torch.common import prng
    from repro_torch.core import QAFeL
    from repro_torch.examples import federated_celeba as fc
    from repro_torch.kernels import ops, qsgd
    from repro_torch.models.cnn import init_cnn

    task = fc.celeba_task(dev)
    algo = QAFeL(fc.qafel_config(), task.loss_fn, init_cnn(2, device=dev),
                 device=dev)
    n = algo.state.n
    assert n == CNN_N
    delta = torch.randn(n, device=dev) * 1e-3
    key = prng.split(prng.PRNGKey(5))[1]

    def old_upload():
        x2d = ops.rows2d(delta)
        return qsgd.qsgd_quantize_pack(
            x2d, prng.uniform(key, x2d.shape, device=dev), BITS)

    for fn in (old_upload, lambda: ops.qsgd_quantize(delta, key, BITS)):
        fn()  # warm up: the build and the first launches
    new = device_launches(lambda: ops.qsgd_quantize(delta, key, BITS))
    old = device_launches(old_upload)
    keys = prng.split(prng.PRNGKey(6), 2 * (steps + 1))
    batches = [task.client_batches(i, keys[2 * i]) for i in range(steps + 1)]
    algo.run_client(batches[0], keys[1])

    def client_steps():
        for i in range(1, steps + 1):
            algo.run_client(batches[i], keys[2 * i + 1])

    per_step = sum(c for _, c in device_launches(client_steps)) / steps
    record = {"phase": "upload_launches", "n": n,
              "upload_device_launches": sum(c for _, c in new),
              "upload_kernels": [name for name, _ in new],
              "old_upload_device_launches": sum(c for _, c in old),
              "client_step_device_launches": per_step}
    emit(record)
    if (record["upload_device_launches"] != 1
            or "quantize_pack_threefry" not in new[0][0]):
        raise AssertionError(f"the b=1 upload launched {new}, not the one "
                             "fused kernel")
    return record


def broadcast_encode_launches(dev):
    """Device activities of one broadcast encode as the flush makes it
    (``ops.qsgd_quantize_batch`` of the CNN-sized flat diff, B = 1, the key
    on the CPU): exactly one, the batched kernel, with no padding pass and
    no copy of the seed words."""
    import torch

    from repro_torch.common import prng
    from repro_torch.kernels import ops

    diff = torch.randn(CNN_N, device=dev) * 1e-3
    key2d = prng.split(prng.PRNGKey(7))[1].reshape(1, -1)
    ops.qsgd_quantize_batch(diff[None], key2d, BITS)  # warm up
    got = device_launches(lambda: ops.qsgd_quantize_batch(diff[None], key2d,
                                                          BITS))
    record = {"phase": "broadcast_encode_launches", "n": CNN_N,
              "device_activities": sum(c for _, c in got),
              "activities": [name for name, _ in got]}
    emit(record)
    if (record["device_activities"] != 1
            or "quantize_pack_batch" not in got[0][0]):
        raise AssertionError(f"one broadcast encode ran {got}, not the one "
                             "batched kernel")
    return record


def run_main_path(dev, client_step_launches: float):
    """The sequential simulator on the full-width CNN; returns its record
    (with the device launches per client step measured beside it) and the
    launch counts of exactly this run."""
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
        "n_params": algo.state.n == CNN_N,
        "accuracy_finite": math.isfinite(res.final_accuracy),
        "state_finite": bool(torch.isfinite(algo.state.x_flat).all()),
        "K1_per_client": launches["qsgd_quantize_pack_threefry"]
        >= res.uploads,
        "given_u_K1_off_path": launches["qsgd_quantize_pack"] == 0,
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
              "client_step_device_launches": client_step_launches,
              "launches": launches, "checks": checks}
    emit(record)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main path checks failed: {failed}")
    return record, launches


def profiled_run(sim, uploads: int, phase: str, cohort_size=None) -> dict:
    """One simulator run under ``torch.profiler`` (device activities,
    read raw by ``kernel_table``): the device's busy and idle share of the
    run, its launches per upload (and per client trained: whole cohorts of
    ``cohort_size``) and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = kernel_table(prof)
    busy_s = 1e-3 * sum(t for _, t in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    launches = sum(c for c, _ in by_name.values())
    trained = (uploads if cohort_size is None
               else sim.cohorts * cohort_size)
    record = {"phase": phase, "uploads": uploads, "cohort_size": cohort_size,
              "clients_trained": trained, "wall_s": wall,
              "device_busy_s": busy_s, "device_idle_share": 1 - busy_s / wall,
              "device_launches": launches,
              "device_launches_per_upload": launches / uploads,
              "device_launches_per_client_trained": launches / trained,
              "top_kernels": [{"name": n[:80], "ms": t, "count": c}
                              for n, (c, t) in top]}
    emit(record)
    if busy_s <= 0:
        raise AssertionError("the profiler saw no device time")
    return record


def profile_window(dev, uploads: int = 20, cohort_size=None):
    """A short second run under ``torch.profiler`` (``profiled_run``): the
    main path (``AsyncFLSimulator``), or with ``cohort_size`` the cohort
    path (``CohortAsyncFLSimulator`` under ``tiered_bits``)."""
    from repro_torch.core import QAFeL
    from repro_torch.examples import federated_celeba as fc
    from repro_torch.models.cnn import init_cnn
    from repro_torch.sim import (AsyncFLSimulator, CohortAsyncFLSimulator,
                                 SimConfig)

    task = fc.celeba_task(dev)
    algo = QAFeL(fc.qafel_config(), task.loss_fn, init_cnn(1, device=dev),
                 device=dev)
    if cohort_size is None:
        sim = AsyncFLSimulator(algo, SimConfig(concurrency=CONCURRENCY,
                                               max_uploads=uploads,
                                               eval_every_steps=3),
                               task.client_batches, task.eval_fn)
        return profiled_run(sim, uploads, "profile")
    sim = CohortAsyncFLSimulator(
        algo, SimConfig(concurrency=COHORT_CONCURRENCY, max_uploads=uploads,
                        eval_every_steps=3),
        task.client_batches, task.eval_fn, scenario="tiered_bits",
        cohort_size=cohort_size)
    # clients trained: the cohort engine admits whole cohorts, beyond the
    # uploads delivered
    return profiled_run(sim, uploads, "cohort_profile",
                        cohort_size=cohort_size)


def run_cohort_path(dev, main_profile: dict, client_step_launches: float):
    """The cohort engine on the full-width CNN through its entry points:
    ``CohortAsyncFLSimulator`` driving ``QAFeL`` with the federated
    example's task and configuration under ``tiered_bits`` (30% of the
    clients upload qsgd2), concurrency 100, cohorts of 32, 200 uploads,
    the launch counters set to 0 just before and read just after. Returns
    its record and the launch counts of exactly this run."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import QAFeL
    from repro_torch.examples import federated_celeba as fc
    from repro_torch.models.cnn import init_cnn
    from repro_torch.sim import CohortAsyncFLSimulator, SimConfig

    task = fc.celeba_task(dev)
    algo = QAFeL(fc.qafel_config(), task.loss_fn, init_cnn(0, device=dev),
                 device=dev)
    flush_s = []
    inner_flush = algo._flush

    def timed_flush(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner_flush(*args, **kw)
        torch.cuda.synchronize()
        flush_s.append(time.perf_counter() - t0)
        return out

    algo._flush = timed_flush
    # flushes whose window held packed uploads, each one K4 launch (a
    # window of tier uploads only has nothing to aggregate)
    packed_windows = []
    inner_drain = algo.buffer.drain

    def counted_drain():
        batch = inner_drain()
        packed_windows.append(batch.stack is not None)
        return batch

    algo.buffer.drain = counted_drain
    sim = CohortAsyncFLSimulator(
        algo, SimConfig(concurrency=COHORT_CONCURRENCY,
                        max_uploads=COHORT_UPLOADS, eval_every_steps=3),
        task.client_batches, task.eval_fn, scenario="tiered_bits",
        cohort_size=COHORT_SIZE)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    m = res.metrics
    flushes = res.server_steps
    tier = algo.meter.uploads_by_kind.get("qsgd2", 0)
    checks = {
        "replicas_in_sync": bool(m["replicas_in_sync"]),
        "uploads": res.uploads == COHORT_UPLOADS,
        "n_params": algo.state.n == CNN_N,
        "tiers_present": 0 < tier < res.uploads,
        "accuracy_finite": math.isfinite(res.final_accuracy),
        "state_finite": bool(torch.isfinite(algo.state.x_flat).all()),
        # one K2 launch at B = 32 per tier group of every cohort, and one
        # broadcast encode per flush
        "K2_per_group_and_flush": launches["qsgd_quantize_pack_batch"]
        == sim.groups + flushes and sim.groups >= sim.cohorts > 0,
        "K1_off_path": launches["qsgd_quantize_pack_threefry"]
        == launches["qsgd_quantize_pack"] == 0,
        # the flush's decode, the replicas' decode, every tier upload's
        "K3_per_flush_and_tier": launches["qsgd_unpack_dequantize"]
        == 2 * flushes + tier,
        "K4_per_packed_window": launches["buffer_aggregate"]
        == sum(packed_windows) > 0 and len(packed_windows) == flushes,
    }
    record = {"phase": "cohort_path", "uploads": res.uploads,
              "cohort_size": COHORT_SIZE, "scenario": "tiered_bits",
              "concurrency": COHORT_CONCURRENCY,
              "cohorts_admitted": sim.cohorts, "tier_groups": sim.groups,
              "server_steps": flushes,
              "packed_windows": sum(packed_windows),
              "wall_s": wall, "uploads_per_s": res.uploads / wall,
              "flush_ms_median": 1e3 * statistics.median(flush_s),
              "dropped_uploads": m["dropped_uploads"],
              "tier_decoded_uploads": tier,
              "final_accuracy": res.final_accuracy,
              "replicas_in_sync": bool(m["replicas_in_sync"]),
              "tau_max": m["tau_max"],
              "kB_per_upload": {k: v for k, v in m.items()
                                if k.startswith("kB_per_upload")},
              "launches": launches,
              "main_path_device_launches_per_upload":
                  main_profile["device_launches_per_upload"],
              "main_path_client_step_device_launches": client_step_launches,
              "checks": checks}
    emit(record)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"cohort path checks failed: {failed}")
    cohort_step_memory(dev, algo, task)
    return record, launches


def cohort_step_memory(dev, algo, task, b: int = COHORT_SIZE) -> dict:
    """Peak device memory of one client step of ``b`` members (the CNN, in
    one vmap, their batches included), per member and parameter, held
    against the constant of the member-chunk rule
    (``sim.cohort.auto_member_chunk``). Run after a path's counts are
    read; the step's launches are not counted."""
    import torch

    from repro_torch.common import prng
    from repro_torch.core.qafel import client_update_flat
    from repro_torch.sim import cohort

    st = algo.state
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    batches = cohort._stack_trees(
        [task.client_batches(i, None) for i in range(b)])
    keys = prng.split_each(prng.split(prng.PRNGKey(7), b))
    chunk = cohort.auto_member_chunk(b, st.n, dev)
    client_update_flat(algo.loss_fn, algo.qcfg, algo.cq.spec, st.layout,
                       st.hidden_flat, batches, keys[:, 0], keys[:, 1], b=b)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    per = peak / (b * st.n)
    record = {"phase": "cohort_step_memory", "members": b, "params": st.n,
              "peak_bytes": peak, "bytes_per_member_param": per,
              "rule_bytes_per_member_param": cohort._BYTES_PER_MEMBER_PARAM,
              "auto_member_chunk": chunk}
    emit(record)
    if not per <= cohort._BYTES_PER_MEMBER_PARAM or chunk is not None:
        raise AssertionError("the member-chunk rule's constant is below the "
                             "measured working set, or it chunks the "
                             "cohort path")
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

    params0 = init_cnn(5, device="cpu")
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
    cohort = cohort_quad_on_both(dev)
    emit({"phase": "card_vs_cpu", "server_flushes": servers[dev].state.t,
          "server_bit_exact": True, "quickstart_bit_exact": quick_equal,
          **cohort})


def cohort_quad_on_both(dev) -> dict:
    """The cohort engine on the quad task (d = 2048, cohort_size 4,
    ``tiered_bits``, 40 uploads) on the card and on the CPU: x, x-hat,
    momentum and every broadcast's codes and norms bit for bit."""
    from repro_torch.core import QAFeL
    from repro_torch.examples import cohort_scenarios as cs
    from repro_torch.sim import CohortAsyncFLSimulator, SimConfig

    runs = {}
    for d in ("cpu", dev):
        task = cs.quad_task(d)
        algo = QAFeL(cs.qafel_config(4), task.loss_fn, task.params0,
                     device=d)
        sent, inner = [], algo.receive

        def receive(msg, key, n_receivers=1, inner=inner, sent=sent):
            bmsg = inner(msg, key, n_receivers)
            if bmsg is not None:
                sent.append(bmsg.payload)
            return bmsg

        algo.receive = receive
        res = CohortAsyncFLSimulator(
            algo, SimConfig(concurrency=8, max_uploads=40,
                            eval_every_steps=3),
            task.client_batches, task.eval_fn, scenario="tiered_bits",
            cohort_size=4).run()
        runs[str(d)] = (algo, res, sent)
    (ca, cr, cs_sent), (ga, gr, gs_sent) = runs["cpu"], runs[str(dev)]
    for name in ("x_flat", "hidden_flat", "momentum_flat"):
        assert bits_equal(getattr(ca.state, name),
                          getattr(ga.state, name).cpu()), name
    assert len(cs_sent) == len(gs_sent) == ca.state.t > 0
    for c, g in zip(cs_sent, gs_sent):
        assert bits_equal(c["packed"], g["packed"].cpu())
        assert bits_equal(c["norms"], g["norms"].cpu())
    assert cr.metrics["replicas_in_sync"] and gr.metrics["replicas_in_sync"]
    assert ca.meter.summary() == ga.meter.summary()
    tier = ca.meter.uploads_by_kind.get("qsgd2", 0)
    assert tier > 0, "no tier upload in the quad run"
    return {"cohort_quad_bit_exact": True, "cohort_quad_flushes": ca.state.t,
            "cohort_quad_tier_uploads": tier}


# ---------------------------------------------------------------------------
# telemetry: the metric-tap kernels and the traced runs
# ---------------------------------------------------------------------------


# lengths where a level of the tap sums' padding changes (around 32, 1,024
# and 32,768 values, past 2^20 and past 32 level-2 windows), held bit for
# bit, not timed; at B = 8 the last two take the long plan
# (``tap_reduce.cuh``), B = 1 the short one; the flush's long plan from
# 8,192 level-1 windows
TAP_LENGTHS = (1, 31, 33, 1_023, 1_025, 32_767, 32_768, 32_769, 79_842,
               1_048_577, 32 * 32_768 + 5)
TAP_FLUSH_LONG_N = 8_192 * 1_024 + 5


def tap_kernel_cases(dev):
    """The two tap kernels at the telemetry phase's shapes: the flush at
    the CNN's n (K = 10 weights, and an identity broadcast, q = diff) and
    at d = 1e8; the upload at b = 1 qsgd4, B = 32 in qsgd4, qsgd2 and
    identity over the CNN's n, and B = 8 qsgd4 at d = 1e8 (``timed``);
    then, checked only, the flush and the upload at b = 1 and B = 8 (qsgd4)
    at ``TAP_LENGTHS``, and the flush at ``TAP_FLUSH_LONG_N``. Their bytes
    are each input read once and the output written once; their f32
    operations (flush: 2 differences, 5 squares and 5 adds per element;
    upload: 1 square and add, and with codes 2 products, a difference, a
    square and an add) bound nothing. No single PyTorch call computes
    either (an XLA-ordered sum of squares, the upload's fused decode
    error): library time null."""
    import torch

    from repro_torch.common import prng
    from repro_torch.kernels import ref, taps
    from repro_torch.kernels.ops import qsgd_quantize_batch

    gen = torch.Generator(device=dev).manual_seed(13)
    f32 = (F32_OPS_PER_S, "float32")
    cases = {}

    def flush(n, identity, timed=True):
        v = [torch.randn(n, generator=gen, device=dev) * s
             for s in (1.0, 1e-3, 1e-3, 1e-2, 1e-2)]
        v[1] = v[0] + v[1]
        if identity:
            v[4] = v[3]
        w = torch.rand(CNN_K, generator=gen, device=dev) / CNN_K
        return dict(
            source="src/repro_torch/kernels/csrc/flush_taps.cu",
            replaces=None, fn=taps.flush_taps, plain=ref.flush_taps,
            args=(*v, w), bytes=5 * n * 4 + CNN_K * 4 + 7 * 4,
            bytes_formula="5*n*4 (x_old, x_new, delta, diff, q) + K*4 "
                          "weights + 7*4 out",
            ops=n * 12, rate=f32, timed=timed)

    def plain_by_message(f, p, nm, bits):
        return torch.cat([ref.upload_taps(
            f[i:i + 1], None if p is None else p[i:i + 1],
            None if nm is None else nm[i:i + 1], bits)
            for i in range(f.shape[0])])

    def upload(b, n, bits, plain=ref.upload_taps, timed=True):
        x = torch.randn((b, n), generator=gen, device=dev) * 0.01
        x[:, 128:256] = 0.0  # an all-zero bucket
        rows = ref.rows_for(n)
        packed = norms = None
        code_bytes = 0
        if bits is not None:
            seeds = prng.split_each(prng.split(prng.PRNGKey(b + bits), b))
            packed, norms = qsgd_quantize_batch(x, seeds[:, 1], bits)
            code_bytes = b * rows * (16 * bits + 4)
        return dict(
            source="src/repro_torch/kernels/csrc/upload_taps.cu",
            replaces=None, fn=taps.upload_taps, plain=plain,
            args=(x, packed, norms, bits),
            bytes=b * n * 4 + code_bytes + b * 2 * 4,
            bytes_formula="B*n*4 deltas + B*rows*(128*bits/8 + 4) codes and "
                          "norms + B*2*4 out",
            ops=b * n * (2 if bits is None else 7), rate=f32, timed=timed)

    cases["flush_taps_cnn"] = flush(CNN_N, False)
    cases["flush_taps_identity_cnn"] = flush(CNN_N, True)
    cases["upload_taps_b1_qsgd4_cnn"] = upload(1, CNN_N, 4)
    for bits in (4, 2, None):
        name = "identity" if bits is None else f"qsgd{bits}"
        cases[f"upload_taps_B{COHORT_SIZE}_{name}_cnn"] = upload(
            COHORT_SIZE, CNN_N, bits)
    cases["flush_taps_d1e8"] = flush(BIG_ROWS * 128, False)
    cases[f"upload_taps_B{COHORT_BIG_B}_qsgd4_d1e8"] = upload(
        COHORT_BIG_B, BIG_ROWS * 128, 4, plain_by_message)
    for n in TAP_LENGTHS:
        cases[f"flush_taps_n{n}"] = flush(n, False, timed=False)
        cases[f"upload_taps_b1_qsgd4_n{n}"] = upload(1, n, 4, timed=False)
        cases[f"upload_taps_B{COHORT_BIG_B}_qsgd4_n{n}"] = upload(
            COHORT_BIG_B, n, 4, plain_by_message, timed=False)
    cases[f"flush_taps_n{TAP_FLUSH_LONG_N}"] = flush(TAP_FLUSH_LONG_N, False,
                                                     timed=False)
    return cases


def check_tap_kernels(dev) -> dict:
    """Each tap kernel case against its plain version on the card, bit for
    bit; the timed ones timed, with their byte bound and share, and the
    launch floor's distance (``launch_floor_ms``, measured first); every
    B > 1 upload case row by row against the kernel on each message alone
    (a member's tap does not depend on its cohort)."""
    import torch

    floor = launch_floor_ms(dev)
    emit({"phase": "launch_floor", "ms": floor})
    out = {}
    for name, case in tap_kernel_cases(dev).items():
        big = "d1e8" in name
        if case["timed"]:
            out[name] = measure_case(name, case, 10 if big else 50,
                                     1 if big else 10)
            out[name]["bound_share"] = out[name]["bound_ms"] / out[name]["ms"]
            out[name]["over_floor_ms"] = out[name]["ms"] - floor
        else:
            got = case["fn"](*case["args"])
            want = case["plain"](*case["args"])
            torch.cuda.synchronize()
            if not bits_equal(got, want):
                raise AssertionError(f"{name}: kernel and plain version "
                                     "differ")
            out[name] = {"equal": True}
        flat, packed, norms, bits = (case["args"] if name.startswith(
            "upload") else (None,) * 4)
        if flat is not None and flat.shape[0] > 1:
            whole = case["fn"](*case["args"])
            alone = torch.cat([case["fn"](
                flat[i:i + 1], None if packed is None else packed[i:i + 1],
                None if norms is None else norms[i:i + 1], bits)
                for i in range(flat.shape[0])])
            out[name]["b_invariant"] = bits_equal(whole, alone)
            if not out[name]["b_invariant"]:
                raise AssertionError(f"{name}: a message's taps depend on "
                                     "its cohort")
        emit({"phase": "tap_kernel", "name": name,
              **{key: v for key, v in out[name].items()
                 if key not in ("source", "replaces")}})
        case.clear()
        torch.cuda.empty_cache()
    return out


def kernel_counts(prof) -> dict:
    """Launches per device kernel name in a ``torch.profiler`` window, and
    the copies and sets apart (``Memcpy``/``Memset`` activities), read
    from its raw events (``kineto_results.events()``) as ``kernel_table``
    reads them: ``key_averages`` builds the profiler's event tree first,
    which took most of the telemetry phase's time."""
    from torch.autograd import DeviceType

    counts = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            counts[e.name()] = counts.get(e.name(), 0) + 1
    return counts


def profiled_counts(dev, engine: str, uploads: int) -> dict:
    """The run with no tracer (None) and with taps on (True), each profiled
    twice in the order off, on, on, off, with cuDNN's deterministic
    algorithms so that the two states can be compared bit for bit."""
    runs = {None: [], True: []}
    for t in (None, True, True, None):
        runs[t].append(traced_cnn_run(dev, t, engine=engine, uploads=uploads,
                                      profiled=True, deterministic=True))
    return runs


# profiled quartets at most for one tap launch check (``profiled_tap_diff``)
TAP_PROFILE_ATTEMPTS = 3


def profiled_tap_diff(dev, engine: str, uploads: int):
    """``tap_launch_diff`` of a quartet of ``profiled_counts``. The
    profiler drops activity records under load and never adds one; a
    quartet whose check fails where it shows such loss (two runs of one
    configuration with different totals, or a tap kernel profiled fewer
    times than its counter launched it) is profiled anew, up to
    ``TAP_PROFILE_ATTEMPTS`` quartets, each judged alone. A quartet that
    fails with no loss seen fails the check. Returns the last quartet's
    runs and its diff, with every quartet's summary under "attempts"."""
    attempts = []
    for _ in range(TAP_PROFILE_ATTEMPTS):
        runs = profiled_counts(dev, engine, uploads)
        on = runs[True][0]
        diff = tap_launch_diff(runs, on["res"].server_steps,
                               on["client_steps"])
        attempts.append({k: diff[k] for k in (
            "kernels_off_per_run", "kernels_on_per_run",
            "record_loss_bound", "tap_records_short", "differing_kernels",
            "ok")})
        lost = diff["record_loss_bound"] > 0 or diff["tap_records_short"] > 0
        if diff["ok"] or not lost:
            break
    diff["attempts"] = attempts
    return runs, diff


def tap_launch_diff(runs: dict, flushes: int, steps: int) -> dict:
    """The profiled launches of the taps-on runs against the runs with no
    tracer: the tap kernels launched once per flush and once per client
    step with taps on and never without; every other kernel
    name as often with taps as without. The profiler drops a few activity
    records under load (seen: 1 to 230 of ~30,000 per run) and never adds
    one, so each name counts the larger of a configuration's two runs,
    and a name passes within the record loss measured in this run (the
    largest difference between two runs of one configuration); copies
    (the taps' device-to-host reads) are counted apart."""
    def split(counts):
        kern = {k: c for k, c in counts.items()
                if not k.startswith(("Memcpy", "Memset"))}
        return kern, sum(c for k, c in counts.items() if k not in kern)

    def tap(kern, name):
        return sum(c for k, c in kern.items() if name in k)

    per = {t: [split(r["counts"]) for r in rs] for t, rs in runs.items()}
    short = sum(max(0, r["launches"][c] - tap(kern, c + "_kernel"))
                for t, rs in runs.items() for r, (kern, _) in zip(rs, per[t])
                for c in ("flush_taps", "upload_taps"))
    merged = {t: {k: max(kern.get(k, 0) for kern, _ in ps)
                  for k in set().union(*(kern for kern, _ in ps))}
              for t, ps in per.items()}
    k_off, k_on = merged[None], merged[True]
    totals = {t: [sum(kern.values()) for kern, _ in ps]
              for t, ps in per.items()}
    loss = max(abs(a - b) for a, b in totals.values())
    differing = sorted(
        (k[:60], k_off.get(k, 0), k_on.get(k, 0))
        for k in set(k_on) | set(k_off)
        if "taps_kernel" not in k and k_on.get(k, 0) != k_off.get(k, 0))
    taps_exact = all(
        (tap(merged[t], "flush_taps_kernel"),
         tap(merged[t], "upload_taps_kernel"))
        == ((flushes, steps) if t else (0, 0)) for t in merged)
    return {"kernels_off_per_run": totals[None],
            "kernels_on_per_run": totals[True],
            "record_loss_bound": loss,
            "tap_records_short": short,
            "flush_taps_kernels": tap(k_on, "flush_taps_kernel"),
            "upload_taps_kernels": tap(k_on, "upload_taps_kernel"),
            "copies_off_per_run": [c for _, c in per[None]],
            "copies_on_per_run": [c for _, c in per[True]],
            "differing_kernels": differing,
            "ok": taps_exact and all(abs(on - off) <= loss
                                     for _, off, on in differing)}


def traced_cnn_run(dev, taps, *, engine: str, uploads: int,
                   profiled: bool = False, deterministic: bool = False):
    """One run of the CNN path through its entry points: ``engine``
    "cohort" is the cohort path (``tiered_bits``, cohorts of 32,
    concurrency 100), "sequential" the main path (concurrency 16);
    ``taps`` None attaches no tracer, else a ``RunTracer(taps=taps)``.
    Flushes are timed (synchronized), client steps counted, the launch
    counters set to 0 just before and read just after, and the run
    optionally profiled or made with cuDNN's deterministic algorithms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.core import QAFeL
    from repro_torch.examples import federated_celeba as fc
    from repro_torch.models.cnn import init_cnn
    from repro_torch.obs import RunTracer
    from repro_torch.sim import (AsyncFLSimulator, CohortAsyncFLSimulator,
                                 SimConfig)

    task = fc.celeba_task(dev)
    tracer = None if taps is None else RunTracer(taps=taps)
    algo = QAFeL(fc.qafel_config(), task.loss_fn, init_cnn(0, device=dev),
                 device=dev, telemetry=tracer)
    flush_s, steps = [], [0]
    inner_flush = algo._flush

    def timed_flush(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner_flush(*args, **kw)
        torch.cuda.synchronize()
        flush_s.append(time.perf_counter() - t0)
        return out

    algo._flush = timed_flush
    if engine == "cohort":
        sim = CohortAsyncFLSimulator(
            algo, SimConfig(concurrency=COHORT_CONCURRENCY,
                            max_uploads=uploads, eval_every_steps=3),
            task.client_batches, task.eval_fn, scenario="tiered_bits",
            cohort_size=COHORT_SIZE)
    else:
        inner_client = algo.run_client

        def counted_client(*args, **kw):
            steps[0] += 1
            return inner_client(*args, **kw)

        algo.run_client = counted_client
        sim = AsyncFLSimulator(algo, SimConfig(concurrency=CONCURRENCY,
                                               max_uploads=uploads,
                                               eval_every_steps=3),
                               task.client_batches, task.eval_fn)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        prof = None
        t0 = time.perf_counter()
        if profiled:  # device activity only: the counts read nothing else
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                res = sim.run()
                torch.cuda.synchronize()
        else:
            res = sim.run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = det
    return {"algo": algo, "sim": sim, "res": res, "tracer": tracer,
            "wall": wall, "flush_s": flush_s,
            "client_steps": sim.groups if engine == "cohort" else steps[0],
            "launches": kernels.launches(),
            "counts": None if prof is None else kernel_counts(prof)}


def check_trace(run: dict, path: Path) -> dict:
    """Write the run's trace as JSONL, validate it against the schema and
    check that its event counts add up."""
    from repro_torch.obs import validate_jsonl, write_jsonl

    tracer, res = run["tracer"], run["res"]
    written = write_jsonl(tracer, path)
    errors = validate_jsonl(path)
    c = tracer.counters()
    flushes = res.server_steps
    checks = {
        "schema_valid": errors == [],
        "no_ring_overflow": c["events_evicted"] == 0,
        "upload_events": c["events_upload"] == res.uploads,
        "flush_events": c["events_flush"] == flushes > 0,
        "broadcast_events": c["events_broadcast"] == flushes,
        "drop_events": c["events_drop"]
        == res.metrics.get("dropped_uploads", 0),
        "taps_on_every_upload": all(
            "taps" in e.data for e in tracer.events("upload")),
        "taps_on_every_flush": all(
            "taps" in e.data for e in tracer.events("flush")),
        "taps_finite": all(math.isfinite(v) for e in tracer.events()
                           for v in e.data.get("taps", {}).values()),
    }
    return {"trace": str(path.relative_to(ROOT)), "events": written,
            "schema_errors": errors[:5], "counters": {
                k: v for k, v in c.items() if v and k.startswith("events_")},
            "trace_checks": checks}


def same_state(a, b) -> bool:
    return all(bits_equal(getattr(a.state, name).cpu(),
                          getattr(b.state, name).cpu())
               for name in ("x_flat", "hidden_flat", "momentum_flat"))


# the profiled pairs of the telemetry phase: their trace processing is
# most of the phase's time, so they run shorter than the paths they check
TELEMETRY_PROFILED_UPLOADS = 100


def telemetry_cohort(dev, out_dir: Path) -> dict:
    """The cohort path (the CNN, ``tiered_bits``, cohorts of 32, 200
    uploads) with a ``RunTracer(taps=True)`` and with no tracer, in this
    one process: the state bit-identical (cuDNN's deterministic
    algorithms for this pair, so that only the taps could move a bit), the
    trace valid and its counts adding up, taps on one more launch per
    flush and per tier group (counters; the profiler over runs of
    ``TELEMETRY_PROFILED_UPLOADS``), the other launches
    as pinned; then uploads/s and the flush median with taps off, on, on,
    off."""
    import statistics as st

    from repro_torch.obs import summary_table

    pair = {t: traced_cnn_run(dev, t, engine="cohort",
                              uploads=COHORT_UPLOADS, deterministic=True)
            for t in (None, True)}
    off, on = pair[None], pair[True]
    flushes, groups = on["res"].server_steps, on["client_steps"]
    trace = check_trace(on, out_dir / "telemetry_cohort.jsonl")
    lo, ln = off["launches"], on["launches"]
    _, diff = profiled_tap_diff(dev, "cohort", TELEMETRY_PROFILED_UPLOADS)
    timed = {"off": [], "on": []}
    for t in (None, True, True, None):
        r = traced_cnn_run(dev, t, engine="cohort", uploads=COHORT_UPLOADS)
        timed["off" if t is None else "on"].append(
            (r["res"].uploads / r["wall"],
             1e3 * st.median(r["flush_s"])))
    checks = {
        "state_bit_identical": same_state(off["algo"], on["algo"]),
        "replicas_in_sync": bool(off["res"].metrics["replicas_in_sync"]
                                 and on["res"].metrics["replicas_in_sync"]),
        "same_trajectory": (off["res"].accuracy_trace
                            == on["res"].accuracy_trace
                            and off["res"].server_steps == flushes > 0),
        "flush_taps_per_flush": ln["flush_taps"] == flushes,
        "upload_taps_per_group": ln["upload_taps"] == groups
        == off["client_steps"] > 0,
        "taps_off_no_tap_launch": lo["flush_taps"] == lo["upload_taps"] == 0,
        "other_launches_unchanged": all(
            lo[k] == ln[k] for k in lo if k not in ("flush_taps",
                                                    "upload_taps")),
        "pinned_K2_K3_K4": (lo["qsgd_quantize_pack_batch"],
                            lo["qsgd_unpack_dequantize"],
                            lo["buffer_aggregate"]) == (40, 95, 20),
        "profiler_one_launch_each": diff["ok"],
        **trace.pop("trace_checks"),
    }
    record = {"phase": "telemetry_cohort", "uploads": on["res"].uploads,
              "server_steps": flushes, "tier_groups": groups,
              "launches_off": lo, "launches_on": ln, "profiled": diff,
              "uploads_per_s_off": [u for u, _ in timed["off"]],
              "uploads_per_s_on": [u for u, _ in timed["on"]],
              "flush_ms_median_off": [f for _, f in timed["off"]],
              "flush_ms_median_on": [f for _, f in timed["on"]],
              **trace, "checks": checks}
    emit(record)
    print(summary_table(on["tracer"], title="telemetry (cohort path)"),
          flush=True)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"telemetry cohort checks failed: {failed}")
    return record


def telemetry_main_path(dev, out_dir: Path, uploads: int = 10) -> dict:
    """The sequential main path (the CNN, concurrency 16) for ``uploads``
    uploads with taps on, profiled beside the same run with no tracer:
    the state bit-identical, the trace valid, one more launch per client
    step and per flush."""
    runs, diff = profiled_tap_diff(dev, "sequential", uploads)
    off, on = runs[None][0], runs[True][0]
    flushes, steps = on["res"].server_steps, on["client_steps"]
    trace = check_trace(on, out_dir / "telemetry_main.jsonl")
    lo, ln = off["launches"], on["launches"]
    checks = {
        "state_bit_identical": same_state(off["algo"], on["algo"]),
        "same_trajectory": off["res"].accuracy_trace
        == on["res"].accuracy_trace,
        "flush_taps_per_flush": ln["flush_taps"] == flushes > 0,
        "upload_taps_per_client_step": ln["upload_taps"] == steps
        == ln["qsgd_quantize_pack_threefry"] >= on["res"].uploads,
        "other_launches_unchanged": all(
            lo[k] == ln[k] for k in lo if k not in ("flush_taps",
                                                    "upload_taps")),
        "profiler_one_launch_each": diff["ok"],
        **trace.pop("trace_checks"),
    }
    record = {"phase": "telemetry_main_path", "uploads": on["res"].uploads,
              "server_steps": flushes, "client_steps": steps,
              "launches_on": ln, "profiled": diff, **trace,
              "checks": checks}
    emit(record)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"telemetry main path checks failed: {failed}")
    return record


def telemetry_quad_on_both(dev) -> dict:
    """The quad's cohort engine (cohorts of 4, ``tiered_bits``, 40
    uploads) with taps on, on the card and on the CPU: the comparable event
    streams (no wall clock, no compile events) equal, tap values included,
    bit for bit (their JSON text, which tells -0.0 from 0.0)."""
    import json as _json

    from repro_torch.core import QAFeL
    from repro_torch.examples import cohort_scenarios as cs
    from repro_torch.obs import RunTracer
    from repro_torch.sim import CohortAsyncFLSimulator, SimConfig

    streams, states = {}, {}
    for d in ("cpu", dev):
        task = cs.quad_task(d)
        tracer = RunTracer(taps=True)
        algo = QAFeL(cs.qafel_config(4), task.loss_fn, task.params0,
                     device=d, telemetry=tracer)
        CohortAsyncFLSimulator(
            algo, SimConfig(concurrency=8, max_uploads=40,
                            eval_every_steps=3),
            task.client_batches, task.eval_fn, scenario="tiered_bits",
            cohort_size=4).run()
        streams[str(d)] = [e.comparable() for e in tracer.events()
                           if e.kind != "compile"]
        states[str(d)] = algo
    cpu, card = streams["cpu"], streams[str(dev)]
    equal = _json.dumps(cpu) == _json.dumps(card)
    record = {"phase": "telemetry_quad_card_vs_cpu", "events": len(card),
              "tap_events": sum("taps" in e for e in card),
              "streams_bit_equal": equal,
              "state_bit_equal": same_state(states["cpu"],
                                            states[str(dev)])}
    emit(record)
    if not (equal and record["state_bit_equal"] and record["tap_events"]):
        raise AssertionError("the quad's traced cohort run differs between "
                             "the card and the CPU")
    return record


def run_telemetry(dev):
    """The telemetry phase; returns the tap kernels' measurements and
    their launches on the traced main path and cohort path."""
    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "telemetry"
    out_dir.mkdir(parents=True, exist_ok=True)
    emit({"phase": "tap_resources", **tap_resources(_build.build_all())})
    cases = check_tap_kernels(dev)
    cohort = telemetry_cohort(dev, out_dir)
    main = telemetry_main_path(dev, out_dir)
    telemetry_quad_on_both(dev)
    return cases, main["launches_on"], cohort["launches_on"]


# ---------------------------------------------------------------------------
# the quantizer family: sparse messages both ways, the lowrank uplink
# ---------------------------------------------------------------------------

# exact wire bytes at the CNN's n = 79,842, from the reference's
# ``wire_bits``: lowrank4g32 is 4 bits on each of its 2,496 rank
# coordinates and one f32 norm per 128 of them; top_k0.1 / rand_k0.1 are
# 7,985 (index, value) pairs of 64 bits; qsgd4 4 bits per coordinate and
# one norm per 128
LOWRANK_UPLOAD_B, TOP_K_MESSAGE_B, QSGD4_MESSAGE_B = 1_328, 63_880, 42_417
LOWRANK_RANK, FAMILY_QUAD_UPLOADS = 2_496, 40
# (name, engine, client quantizer, server quantizer, uploads, cohort size)
FAMILY_CNN_RUNS = (
    ("seq_qsgd4_topk10", "sequential", "qsgd4", "top_k0.1", 100, None),
    ("seq_lowrank4g32_qsgd4", "sequential", "lowrank4g32", "qsgd4", 40, None),
    ("cohort_lowrank4g32_qsgd4", "cohort", "lowrank4g32", "qsgd4", 200,
     COHORT_SIZE))
PAYLOAD_FIELDS = ("packed", "norms", "idx", "vals", "payload", "seed")


def family_kernel_cases(dev) -> dict:
    """K1, K2 and K3 at the lowrank uplink's shapes on the CNN: K1 over the
    2,496 rank coordinates of one upload (20 rows, the last ragged), K2
    over 32 of them (the cohort upload), K3 over the 32 x 20 rows of their
    decode; each bit for bit against its plain version, timed, with its
    byte bound."""
    import torch

    from repro_torch.common import prng
    from repro_torch.kernels import qsgd, ref

    gen = torch.Generator(device=dev).manual_seed(16)
    y = torch.randn((COHORT_SIZE, LOWRANK_RANK), generator=gen,
                    device=dev) * 0.01
    rows = ref.rows_for(LOWRANK_RANK)
    code_b = 128 * BITS // 8
    key = prng.split(prng.PRNGKey(3))[1]
    seeds = prng.split(prng.PRNGKey(4), COHORT_SIZE)
    packed, norms = qsgd.qsgd_quantize_pack_batch_flat(y, seeds, BITS)
    packed2d = packed.reshape(COHORT_SIZE * rows, -1)
    norms1d = norms.reshape(-1)
    f32 = (F32_OPS_PER_S, "float32")
    cases = {
        "K1_lowrank_rank_b1": dict(
            source="src/repro_torch/kernels/csrc/quantize_pack_threefry.cu",
            replaces="src/repro/kernels/qsgd.py:70",
            fn=qsgd.qsgd_quantize_pack_threefry,
            plain=ref.quantize_pack_threefry, args=(y[0].contiguous(), key,
                                                     BITS),
            bytes=LOWRANK_RANK * 4 + rows * (code_b + 4),
            bytes_formula="r*4 y + rows*(128*bits/8 + 4)",
            ops=LOWRANK_RANK * 8, rate=f32),
        "K2_lowrank_rank_B32": dict(
            source="src/repro_torch/kernels/csrc/quantize_pack_batch.cu",
            replaces="src/repro/kernels/qsgd.py:160",
            fn=qsgd.qsgd_quantize_pack_batch_flat,
            plain=lambda f, s, b: ref.quantize_pack_batch(ref.rows2d(f), s,
                                                          b),
            args=(y, seeds, BITS),
            bytes=COHORT_SIZE * (LOWRANK_RANK * 4 + 8 + rows * (code_b + 4)),
            bytes_formula="B*(r*4 y + 8 seeds + rows*(128*bits/8 + 4))",
            ops=COHORT_SIZE * LOWRANK_RANK * 8, rate=f32),
        "K3_lowrank_rank_B32": dict(
            source="src/repro_torch/kernels/csrc/unpack_dequantize.cu",
            replaces="src/repro/kernels/qsgd.py:356",
            fn=qsgd.qsgd_unpack_dequantize, plain=ref.unpack_dequantize,
            args=(packed2d, norms1d, BITS),
            bytes=COHORT_SIZE * rows * (code_b + 4 + 128 * 4),
            bytes_formula="B*rows*(128*bits/8 + 4) + B*rows*128*4 out",
            ops=COHORT_SIZE * rows * 128 * 4, rate=f32),
    }
    out = {}
    for name, case in cases.items():
        out[name] = measure_case(name, case, 50, 10)
        emit({"phase": "family_kernel", "name": name,
              **{k: v for k, v in out[name].items()
                 if k not in ("source", "replaces")}})
    return out


def _recording(algo) -> dict:
    """Wrap ``algo.receive`` to keep every upload's and every broadcast's
    payload; returns the lists."""
    rec = {"uploads": [], "broadcasts": []}
    inner = algo.receive

    def receive(msg, key, n_receivers=1):
        rec["uploads"].append(msg.payload)
        bmsg = inner(msg, key, n_receivers)
        if bmsg is not None:
            rec["broadcasts"].append(bmsg.payload)
        return bmsg

    algo.receive = receive
    return rec


def _same_payload(cpu: dict, card: dict) -> bool:
    import torch

    if cpu["kind"] != card["kind"]:
        return False
    for f in PAYLOAD_FIELDS:
        if f in cpu:
            a, b = cpu[f], card[f]
            if not bits_equal(torch.as_tensor(a), torch.as_tensor(b).cpu()):
                return False
    return True


def quad_family_on_both(dev) -> dict:
    """The quad task (d = 2048, K = 4, 40 uploads) on the card and on the
    CPU, bit for bit: the cohort engine under lowrank4g32 clients and a
    qsgd4 server at cohort sizes 1 and 4, and the sequential engine with
    qsgd4 clients under a top_k0.1 server and rand_k0.1 clients under a
    qsgd4 server: x, x-hat, momentum, every upload's and broadcast's
    payload, every residual, the traffic summary, and with taps on the
    comparable event streams, taps included (their JSON text)."""
    import dataclasses
    import json as _json

    from repro_torch.core import QAFeL
    from repro_torch.examples import cohort_scenarios as cs
    from repro_torch.obs import RunTracer
    from repro_torch.sim import (AsyncFLSimulator, CohortAsyncFLSimulator,
                                 SimConfig)

    cases = (("cohort", "lowrank4g32", "qsgd4", 1),
             ("cohort", "lowrank4g32", "qsgd4", 4),
             ("sequential", "qsgd4", "top_k0.1", 1),
             ("sequential", "rand_k0.1", "qsgd4", 1))
    out = {}
    for engine, cq, sq, size in cases:
        runs = {}
        for d in ("cpu", dev):
            task = cs.quad_task(d)
            stacked = task.client_batches

            def one(cid, key, stacked=stacked):
                return {k: v[0] for k, v in stacked([cid], [key]).items()}

            qcfg = dataclasses.replace(cs.qafel_config(4),
                                       client_quantizer=cq,
                                       server_quantizer=sq)
            tracer = RunTracer(taps=True)
            algo = QAFeL(qcfg, task.loss_fn, task.params0, device=d,
                         telemetry=tracer)
            rec = _recording(algo)
            scfg = SimConfig(concurrency=8, max_uploads=FAMILY_QUAD_UPLOADS,
                             eval_every_steps=3)
            if engine == "sequential":
                res = AsyncFLSimulator(algo, scfg, one, task.eval_fn).run()
            else:
                res = CohortAsyncFLSimulator(
                    algo, scfg, stacked if size > 1 else one, task.eval_fn,
                    cohort_size=size).run()
            rec["events"] = [e.comparable() for e in tracer.events()
                             if e.kind != "compile"]
            runs[str(d)] = (algo, res, rec)
        (ca, cr, crec), (ga, gr, grec) = runs["cpu"], runs[str(dev)]
        name = f"{engine}{size}_{cq}_{sq}"
        checks = {
            "state": all(bits_equal(getattr(ca.state, f),
                                    getattr(ga.state, f).cpu())
                         for f in ("x_flat", "hidden_flat", "momentum_flat")),
            "uploads": len(crec["uploads"]) == len(grec["uploads"])
            == FAMILY_QUAD_UPLOADS and all(
                _same_payload(c, g)
                for c, g in zip(crec["uploads"], grec["uploads"])),
            "broadcasts": len(crec["broadcasts"]) == len(grec["broadcasts"])
            == ca.state.t > 0 and all(
                _same_payload(c, g)
                for c, g in zip(crec["broadcasts"], grec["broadcasts"])),
            "residuals": set(ca._residuals) == set(ga._residuals) and all(
                bits_equal(ca._residuals[c], ga._residuals[c].cpu())
                for c in ca._residuals),
            "traffic": ca.meter.summary() == ga.meter.summary(),
            "events_with_taps": any("taps" in e for e in crec["events"])
            and _json.dumps(crec["events"]) == _json.dumps(grec["events"]),
            "replicas_in_sync": bool(cr.metrics["replicas_in_sync"]
                                     and gr.metrics["replicas_in_sync"]),
        }
        out[name] = {"flushes": ca.state.t, "residual_clients":
                     len(ca._residuals), "checks": checks}
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            emit({"phase": "family_quad_card_vs_cpu", "runs": out})
            raise AssertionError(f"{name}: card and CPU differ in {failed}")
    emit({"phase": "family_quad_card_vs_cpu", "runs": out})
    return out


def _profiled_launches(fn) -> int:
    """Device activities ``torch.profiler`` records while ``fn`` runs."""
    return sum(c for _, c in device_launches(fn))


def _profiled_kinds(fn) -> dict:
    """The same, by activity name (shortened)."""
    out = {}
    for name, count in device_launches(fn):
        out[name[:60]] = out.get(name[:60], 0) + count
    return out


def _launches_per_call(fn, reps: int = 3) -> tuple:
    """Device activities of one call of ``fn`` by the profiler, as the
    difference of a session of ``reps`` calls and one of a single call,
    divided by ``reps - 1``: the profiler loses some activities at the
    start of a session (seen on the H100 machine: the first kernels of a
    flush, K4 among them, while the counters say it ran), the same in both
    sessions. Returns (per call, the single call's session by name)."""
    one = _profiled_kinds(fn)
    many = _profiled_launches(lambda: [fn() for _ in range(reps)])
    return (many - sum(one.values())) / (reps - 1), one


def family_step_launches(dev, algo, task, cohort_size) -> dict:
    """Device launches of one client step (of ``cohort_size`` members for
    the cohort engine) and of one flush of ``algo``'s configuration, by
    ``_launches_per_call``; a flush is the receives of a window of K
    uploads made just before (the first K - 1 launch nothing). Runs after
    the launch counts of the run are read."""
    import torch

    from repro_torch.common import prng
    from repro_torch.core.qafel import client_update_flat
    from repro_torch.sim import cohort

    reps = 3
    keys = prng.split(prng.PRNGKey(21), 2 * (reps + 1) * CNN_K + 2)
    batches = [task.client_batches(i, None) for i in range(CNN_K)]
    if cohort_size is None:
        def call():
            return algo.run_client(batches[1], keys[1], client=1)
    else:
        st, b = algo.state, cohort_size
        stacked = cohort._stack_trees(
            [task.client_batches(i, None) for i in range(b)])
        k = prng.split_each(prng.split(prng.PRNGKey(22), b))
        kw = {}
        if algo.cq.spec.kind == "lowrank":
            kw = {"residual": algo.client_residuals(list(range(b))),
                  "basis_seed": algo.round_basis_seed()}

        def call():
            return client_update_flat(
                algo.loss_fn, algo.qcfg, algo.cq.spec, st.layout,
                st.hidden_flat, stacked, k[:, 0], k[:, 1], b=b, **kw)

    call()  # warm up
    step, _ = _launches_per_call(call, reps)
    torch.cuda.synchronize()
    while algo.buffer.count:  # start from an empty window
        msg, _ = algo.run_client(batches[0], keys[0], client=0)
        algo.receive(msg, keys[0])
    windows = [[algo.run_client(batches[i], keys[2 + w * CNN_K + i],
                                client=i)[0] for i in range(CNN_K)]
               for w in range(reps + 1)]

    def flush():
        for msg in windows.pop():
            out = algo.receive(msg, keys[-1])
        if out is None:
            raise AssertionError("the window did not flush")

    per_flush, one = _launches_per_call(flush, reps)
    return {"client_step_device_launches": step,
            "flush_device_launches": per_flush,
            "flush_device_activities_one_session": one}


def family_cnn_run(dev, name, engine, cq, sq, uploads, cohort_size) -> dict:
    """One run of the family on the paper's CNN at full width through its
    entry points (the federated example's task and configuration: 300
    clients, K = 10, P = 2, batch 8), the launch counters set to 0 just
    before and read just after: uploads/s, flush median, launches per
    kernel, replicas in sync, metered bytes against the exact values; then
    the device launches of one client step and one flush; for the cohort
    engine under lowrank, one client step's peak memory per member and
    parameter against the member-chunk rule's constant."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import QAFeL
    from repro_torch.core.protocol import payload_wire_bytes
    from repro_torch.examples import federated_celeba as fc
    from repro_torch.models.cnn import init_cnn
    from repro_torch.sim import (AsyncFLSimulator, CohortAsyncFLSimulator,
                                 SimConfig)

    task = fc.celeba_task(dev)
    algo = QAFeL(fc.qafel_config(cq, sq), task.loss_fn,
                 init_cnn(0, device=dev), device=dev)
    flush_s = []
    inner_flush = algo._flush

    def timed_flush(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner_flush(*args, **kw)
        torch.cuda.synchronize()
        flush_s.append(time.perf_counter() - t0)
        return out

    algo._flush = timed_flush
    rec = _recording(algo)
    if engine == "sequential":
        sim = AsyncFLSimulator(algo, SimConfig(
            concurrency=CONCURRENCY, max_uploads=uploads, eval_every_steps=3),
            task.client_batches, task.eval_fn)
    else:
        sim = CohortAsyncFLSimulator(
            algo, SimConfig(concurrency=COHORT_CONCURRENCY,
                            max_uploads=uploads, eval_every_steps=3),
            task.client_batches, task.eval_fn, cohort_size=cohort_size)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    m = res.metrics
    flushes = res.server_steps
    up_bytes = {payload_wire_bytes(p) for p in rec["uploads"]}
    bc_bytes = {payload_wire_bytes(p) for p in rec["broadcasts"]}
    lowrank = cq.startswith("lowrank")
    want_up = LOWRANK_UPLOAD_B if lowrank else QSGD4_MESSAGE_B
    want_bc = TOP_K_MESSAGE_B if sq.startswith("top_k") else QSGD4_MESSAGE_B
    # client steps run: one per tier group of each cohort, or one K1 launch
    # per sequential client (more clients start than deliver)
    steps = (sim.groups if engine == "cohort"
             else launches["qsgd_quantize_pack_threefry"])
    checks = {
        "replicas_in_sync": bool(m["replicas_in_sync"]),
        "uploads": res.uploads == uploads,
        "n_params": algo.state.n == CNN_N,
        "state_finite": bool(torch.isfinite(algo.state.x_flat).all()),
        "accuracy_finite": math.isfinite(res.final_accuracy),
        "upload_bytes_exact": up_bytes == {want_up}
        and algo.meter.upload_bytes == res.uploads * want_up
        and algo.cq.wire_bytes_packed(algo.state.layout) == want_up,
        "broadcast_bytes_exact": bc_bytes == {want_bc}
        and algo.meter.broadcast_wire_bytes == flushes * want_bc
        and algo.sq.wire_bytes_packed(algo.state.layout) == want_bc,
        "flushes": flushes == uploads // CNN_K,
        "K4_off_lowrank": launches["buffer_aggregate"]
        == (0 if lowrank else flushes),
    }
    if sq.startswith("top_k"):
        # a sparse broadcast: no encode kernel, a scatter for its decode
        checks["K2_K3_off_top_k"] = (launches["qsgd_quantize_pack_batch"]
                                     == launches["qsgd_unpack_dequantize"]
                                     == 0)
        checks["K1_per_client_step"] = (
            launches["qsgd_quantize_pack_threefry"] >= res.uploads)
    elif engine == "sequential":
        # each client step: K1 over the rank coordinates, K3 its decode;
        # each flush: K3 of the window, K2 and K3 of the broadcast, K3 of
        # the replicas' decode
        k1 = launches["qsgd_quantize_pack_threefry"]
        checks["K1_per_client_step"] = k1 >= res.uploads
        checks["K3_per_step_and_flush"] = (
            launches["qsgd_unpack_dequantize"] == k1 + 3 * flushes)
        checks["K2_per_flush"] = launches["qsgd_quantize_pack_batch"] \
            == flushes
    else:
        # each cohort: K2 and K3 over its 32 members; each flush as above
        checks["K1_off_cohort"] = launches["qsgd_quantize_pack_threefry"] == 0
        checks["K2_per_group_and_flush"] = (
            launches["qsgd_quantize_pack_batch"] == sim.groups + flushes)
        checks["K3_per_group_and_flush"] = (
            launches["qsgd_unpack_dequantize"] == sim.groups + 3 * flushes)
    record = {"phase": "family_cnn", "run": name, "engine": engine,
              "client_quantizer": cq, "server_quantizer": sq,
              "cohort_size": cohort_size, "uploads": res.uploads,
              "server_steps": flushes, "wall_s": wall,
              "uploads_per_s": res.uploads / wall,
              "flush_ms_median": 1e3 * statistics.median(flush_s),
              "bytes_per_upload": sorted(up_bytes),
              "bytes_per_broadcast": sorted(bc_bytes),
              "upload_MB": m["upload_MB"],
              "broadcast_wire_MB": algo.meter.broadcast_wire_bytes / 1e6,
              "final_accuracy": res.final_accuracy,
              "replicas_in_sync": bool(m["replicas_in_sync"]),
              "tau_max": m["tau_max"], "launches": launches,
              "client_steps": steps, "residual_clients":
                  len(algo._residuals), "checks": checks}
    record.update(family_step_launches(dev, algo, task, cohort_size))
    if engine == "cohort":
        record["step_memory"] = lowrank_step_memory(dev, algo, task)
    emit(record)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{name}: checks failed: {failed}")
    return record


def lowrank_step_memory(dev, algo, task) -> dict:
    """Peak device memory of one lowrank client step of ``COHORT_SIZE``
    members (their batches and residuals included), per member and
    parameter, held against ``sim.cohort._BYTES_PER_MEMBER_PARAM``."""
    import torch

    from repro_torch.common import prng
    from repro_torch.core.qafel import client_update_flat
    from repro_torch.sim import cohort

    b, st = COHORT_SIZE, algo.state
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    batches = cohort._stack_trees(
        [task.client_batches(i, None) for i in range(b)])
    residual = algo.client_residuals(list(range(1000, 1000 + b)))
    keys = prng.split_each(prng.split(prng.PRNGKey(8), b))
    client_update_flat(algo.loss_fn, algo.qcfg, algo.cq.spec, st.layout,
                       st.hidden_flat, batches, keys[:, 0], keys[:, 1], b=b,
                       residual=residual, basis_seed=algo.round_basis_seed())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    per = peak / (b * st.n)
    if not per <= cohort._BYTES_PER_MEMBER_PARAM:
        raise AssertionError(f"a lowrank client step takes {per} B per "
                             "member and parameter, above the member-chunk "
                             "rule's constant")
    return {"members": b, "peak_bytes": peak, "bytes_per_member_param": per,
            "rule_bytes_per_member_param": cohort._BYTES_PER_MEMBER_PARAM}


def lowrank_upload_d1e8(dev, reps: int = 5) -> dict:
    """One lowrank4g32 b = 1 upload at d = 1e8 as the client step makes it
    after training (``ops._lowrank_encode``: the error-compensated sum,
    projection, K1 over the 3,125,000 rank coordinates, K3, expand and the
    new residual): median device time by CUDA events, device launches by
    the profiler, the wire bytes, and the byte bound of the whole (delta
    and residual read once, the new residual and the codes written once).
    The baseline of a fused sketch kernel."""
    import torch

    from repro_torch.common import prng
    from repro_torch.core import make_quantizer
    from repro_torch.kernels import ops, qsgd

    n = 10**8
    gen = torch.Generator(device=dev).manual_seed(17)
    delta = torch.randn((1, n), generator=gen, device=dev) * 1e-3
    residual = torch.randn((1, n), generator=gen, device=dev) * 1e-4
    seeds = qsgd.basis_seeds(0, 1)
    key = prng.split(prng.PRNGKey(18))[1]
    spec = make_quantizer("lowrank4g32").spec

    def upload():
        return ops._lowrank_encode(delta, key, BITS, spec.group, seeds,
                                   residual, False)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = upload()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    rank = spec.rank(n)
    rows = -(-rank // 128)
    if (out["packed"].shape != (1, rows, 16 * BITS)
            or not bool(torch.isfinite(out["residual"]).all())):
        raise AssertionError("the d = 1e8 lowrank upload is malformed")
    del out
    launches = _profiled_launches(upload)
    ms = device_ms(upload, reps)
    bytes_ = 3 * n * 4 + rows * (16 * BITS + 4)
    record = {"phase": "lowrank_upload_d1e8", "n": n, "rank": rank,
              "ms": ms, "device_launches": launches,
              "wire_bytes": spec.wire_bits(n) / 8,
              "bound_ms": 1e3 * bytes_ / HBM_BYTES_PER_S,
              "bytes_formula": "n*4 delta + n*4 residual + n*4 new residual "
                               "+ rows*(128*bits/8 + 4) codes",
              "peak_bytes_above_inputs": peak}
    emit(record)
    if record["wire_bytes"] != 1_660_160:
        raise AssertionError("lowrank4g32 wire bytes at d = 1e8")
    return record


def run_quantizer_family(dev):
    """The quantizer-family phase; returns the kernel cases and, per
    kernel, its launches summed over the three CNN runs."""
    import torch

    cases = family_kernel_cases(dev)
    quad_family_on_both(dev)
    launches = {}
    for run in FAMILY_CNN_RUNS:
        record = family_cnn_run(dev, *run)
        for k, v in record["launches"].items():
            launches[k] = launches.get(k, 0) + v
        torch.cuda.empty_cache()
    big = lowrank_upload_d1e8(dev)
    torch.cuda.empty_cache()
    return cases, launches, big


# ---------------------------------------------------------------------------
# the population engine
# ---------------------------------------------------------------------------



class _StepTimer:
    """Wraps ``kernels.ops.population_advance`` while in use: CUDA events
    around each call's launches, by kind (``admit``/``deliver``), read
    once at the end (``timed``); ``record`` keeps each call's host view
    and the state it advanced."""

    def __init__(self, *, timed: bool = True, record: bool = False):
        self.events = {"admit": [], "deliver": []}
        self.outs, self.pop = [], None
        self.timed, self.record = timed, record

    def __enter__(self):
        import torch

        from repro_torch.kernels import ops
        from repro_torch.kernels.population import PopStepOut

        self._inner = inner = ops.population_advance

        def wrapped(pop, *args, admitting, **kw):
            if self.timed:
                ends = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                ends[0].record()
            packed = inner(pop, *args, admitting=admitting, **kw)
            if self.timed:
                ends[1].record()
                self.events["admit" if admitting else "deliver"].append(ends)
            if self.record:
                self.outs.append(PopStepOut(packed, kw["admit"],
                                            kw["deliver"]))
                self.pop = pop
            return packed

        ops.population_advance = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.population_advance = self._inner

    def medians(self) -> dict:
        import torch

        torch.cuda.synchronize()
        return {k: (statistics.median(s.elapsed_time(e) for s, e in v)
                    if v else None) for k, v in self.events.items()}


def step_launches(eng) -> dict:
    """Device activities of one macro step of each kind of a
    ``PopulationEngine`` (the step's launches and its one device-to-host
    copy), by ``_launches_per_call``: each call restores the state saved
    before the step (one copy per state tensor) and takes the step; the
    restore's own activities, counted the same way, are subtracted."""
    out = {}
    for kind in ("admit", "deliver"):
        while eng._admitting != (kind == "admit"):
            eng.step()
        snap = {k: v.clone() for k, v in eng.pop.items()}
        host = (eng._admitting, eng.version, eng.macro_steps,
                dict(eng.steps_by_kind), eng._na, eng._nf, eng._o,
                list(eng.monitor.history))

        def restore():
            for k, v in snap.items():
                eng.pop[k].copy_(v)
            (eng._admitting, eng.version, eng.macro_steps, by_kind, eng._na,
             eng._nf, eng._o, hist) = host
            eng.steps_by_kind = dict(by_kind)
            eng.monitor.history = list(hist)

        def one():
            restore()
            eng.step()

        both, _ = _launches_per_call(one)
        alone, _ = _launches_per_call(restore)
        out[kind] = both - alone
        restore()
    return out


def population_host_vs_cohort(dev) -> dict:
    """The equivalence pin on the card: the cohort path's configuration
    (the CNN at full width, ``tiered_bits``, concurrency 100, cohorts of
    32, 200 uploads) under the cohort engine and under the population
    engine with host draws, cuDNN's deterministic algorithms in both:
    uploads, traffic, staleness, the accuracy trace and the event
    sequence equal, x, x-hat and momentum bit for bit, times within rtol
    1e-5 (the population clock is f32)."""
    import torch

    from repro_torch.core import QAFeL
    from repro_torch.examples import federated_celeba as fc
    from repro_torch.models.cnn import init_cnn
    from repro_torch.obs import RunTracer
    from repro_torch.sim import (CohortAsyncFLSimulator,
                                 PopulationAsyncFLSimulator, SimConfig)

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        # a short run first, so neither timed run pays the deterministic
        # algorithms' first use
        task = fc.celeba_task(dev)
        CohortAsyncFLSimulator(
            QAFeL(fc.qafel_config(), task.loss_fn, init_cnn(0, device=dev),
                  device=dev),
            SimConfig(concurrency=COHORT_CONCURRENCY, max_uploads=COHORT_SIZE),
            task.client_batches, task.eval_fn, scenario="tiered_bits",
            cohort_size=COHORT_SIZE).run()
        for engine in ("cohort", "population"):
            task = fc.celeba_task(dev)
            tracer = RunTracer(taps=False)
            algo = QAFeL(fc.qafel_config(), task.loss_fn,
                         init_cnn(0, device=dev), device=dev,
                         telemetry=tracer)
            cfg = SimConfig(concurrency=COHORT_CONCURRENCY,
                            max_uploads=COHORT_UPLOADS, eval_every_steps=3)
            kw = dict(scenario="tiered_bits", cohort_size=COHORT_SIZE)
            if engine == "cohort":
                sim = CohortAsyncFLSimulator(algo, cfg, task.client_batches,
                                             task.eval_fn, **kw)
            else:
                sim = PopulationAsyncFLSimulator(
                    algo, cfg, task.client_batches, task.eval_fn,
                    draws="host", **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sim.run()
            torch.cuda.synchronize()
            runs[engine] = (algo, res, tracer, sim,
                            time.perf_counter() - t0)
    finally:
        torch.backends.cudnn.deterministic = det
    (ca, cr, ct, _, cwall), (pa, pr, pt, psim, pwall) = (
        runs["cohort"], runs["population"])

    def events(tracer):
        seq, times = [], []
        for e in tracer.events():
            if e.kind == "compile":
                continue
            d = e.comparable()
            d.pop("population", None)
            times.append(d.pop("t_sim"))
            seq.append(d)
        return seq, times

    (cseq, ctimes), (pseq, ptimes) = events(ct), events(pt)
    strip = {k: v for k, v in pr.metrics.items()
             if k != "population_states" and not k.startswith("population/")}
    checks = {
        "uploads": pr.uploads == cr.uploads == COHORT_UPLOADS,
        "traffic": pa.meter.summary() == ca.meter.summary(),
        "metrics": strip == dict(cr.metrics),
        "accuracy_trace": [tuple(p)[1:] for p in pr.accuracy_trace]
        == [tuple(p)[1:] for p in cr.accuracy_trace],
        "event_sequence": pseq == cseq,
        "times_rtol_1e-5": len(ptimes) == len(ctimes) and all(
            abs(a - b) <= 1e-5 * abs(b) + 1e-6
            for a, b in zip(ptimes, ctimes)),
        "replicas_in_sync": bool(pr.metrics["replicas_in_sync"]),
        **{f"{name}_bit_exact": bits_equal(getattr(ca.state, name),
                                           getattr(pa.state, name))
           for name in ("x_flat", "hidden_flat", "momentum_flat")}}
    record = {"phase": "population_host_vs_cohort", "uploads": pr.uploads,
              "cohort_uploads_per_s": cr.uploads / cwall,
              "population_uploads_per_s": pr.uploads / pwall,
              "macro_steps": dict(psim.macro_steps),
              "events": len(pseq), "flushes": pa.state.t,
              "tau_max": pr.metrics["tau_max"], "checks": checks}
    emit(record)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"population host vs cohort: {failed}")
    return record


def population_cnn(dev, hash_int32: dict) -> tuple:
    """The population engine on the CNN at full width through its entry
    points: in-step draws under ``lognormal_dropout``, concurrency 1,000,
    cohort_size = deliver_batch = 512, 2,400 uploads, the launch counters
    set to 0 just before and read just after. Then the launches of one
    macro step of each kind, a profiled run (the device's idle share) and
    the peak memory of one 512-member client step. Returns the record and
    the launch counts of the run."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import QAFeL
    from repro_torch.examples import federated_celeba as fc
    from repro_torch.models.cnn import init_cnn
    from repro_torch.sim import (PopulationAsyncFLSimulator,
                                 PopulationEngine, SimConfig)

    def build(uploads, seed):
        task = fc.celeba_task(dev)
        algo = QAFeL(fc.qafel_config(), task.loss_fn,
                     init_cnn(seed, device=dev), device=dev)
        sim = PopulationAsyncFLSimulator(
            algo, SimConfig(concurrency=POP_CONCURRENCY, max_uploads=uploads,
                            eval_every_steps=3),
            task.client_batches, task.eval_fn, scenario="lognormal_dropout",
            cohort_size=POP_COHORT, deliver_batch=POP_COHORT)
        return task, algo, sim

    task, algo, sim = build(POP_UPLOADS, 0)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with _StepTimer() as timer:
        t0 = time.perf_counter()
        res = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernels.launches()
    ms = timer.medians()
    m, flushes = res.metrics, res.server_steps
    checks = {
        "replicas_in_sync": bool(m["replicas_in_sync"]),
        "uploads": res.uploads == POP_UPLOADS,
        "dropouts": m["dropped_uploads"] > 0,
        "state_finite": bool(torch.isfinite(algo.state.x_flat).all()),
        "accuracy_finite": math.isfinite(res.final_accuracy),
        # one K2 at B = 512 per admitted cohort, one broadcast encode per
        # flush; the flush's and the replicas' decodes; one K4 per flush
        "K2_per_cohort_and_flush": launches["qsgd_quantize_pack_batch"]
        == sim.groups + flushes and sim.groups
        == sim.macro_steps["admit"] > 0,
        "K1_off_path": launches["qsgd_quantize_pack_threefry"]
        == launches["qsgd_quantize_pack"] == 0,
        "K3_per_flush": launches["qsgd_unpack_dequantize"] == 2 * flushes,
        "K4_per_flush": launches["buffer_aggregate"] == flushes > 0,
    }
    eng = PopulationEngine("lognormal_dropout", POP_CONCURRENCY, horizon=5.0,
                           admit_batch=POP_COHORT, deliver_batch=POP_COHORT,
                           device=dev)
    assert eng.capacity == sim.capacity
    per_step = step_launches(eng)
    record = {"phase": "population_cnn", "uploads": res.uploads,
              "scenario": "lognormal_dropout",
              "concurrency": POP_CONCURRENCY, "cohort_size": POP_COHORT,
              "deliver_batch": POP_COHORT, "capacity": sim.capacity,
              "wall_s": wall, "uploads_per_s": res.uploads / wall,
              "macro_steps": dict(sim.macro_steps),
              "macro_step_ms_median": ms,
              "macro_step_device_launches": per_step,
              "server_steps": flushes,
              "dropped_uploads": m["dropped_uploads"],
              "population_states": m["population_states"],
              "final_accuracy": res.final_accuracy,
              "replicas_in_sync": bool(m["replicas_in_sync"]),
              "tau_max": m["tau_max"], "launches": launches,
              "checks": checks}
    emit(record)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"population_cnn checks failed: {failed}")
    del sim, algo
    torch.cuda.empty_cache()
    # the device's idle share over a shorter profiled run
    _, _, psim = build(POP_PROFILE_UPLOADS, 1)
    record["profile"] = profiled_run(psim, POP_PROFILE_UPLOADS,
                                     "population_profile")
    del psim
    torch.cuda.empty_cache()
    _, malgo, _ = build(1, 0)
    record["memory"] = cohort_step_memory(dev, malgo, task, b=POP_COHORT)
    torch.cuda.empty_cache()
    return record, launches


def population_engine_rows(dev) -> list:
    """``PopulationEngine("lognormal_dropout")`` at 100,000 clients to
    horizon 1.0 and at 1,000,000 clients to horizon 0.05: admitted,
    delivered, dropped, macro steps of each kind, events per second, the
    median ms (CUDA events) and device launches per macro step of each
    kind, and the bytes of population state on the card; the lifecycle
    conserved."""
    import torch

    from repro_torch.kernels.population import state_bytes
    from repro_torch.sim import PopulationEngine

    rows = []
    for clients, horizon in POP_ENGINE_ROWS:
        eng = PopulationEngine("lognormal_dropout", clients, horizon=horizon,
                               seed=0, device=dev)
        torch.cuda.synchronize()
        with _StepTimer() as timer:
            t0 = time.perf_counter()
            m = eng.advance_to(horizon)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ms = timer.medians()
        states = m["population_states"]
        checks = {
            "conserved": sum(states.values()) == eng.capacity,
            "lifecycle": m["admitted"] == states["working"]
            + states["offline"] + m["delivered"] + m["discarded"],
            "dropouts": m["dropped"] == states["offline"] + m["discarded"]
            and m["dropped"] > 0,
            "staleness": m["staleness"]["n"] == m["delivered"] > 0,
        }
        per_step = step_launches(PopulationEngine(
            "lognormal_dropout", clients, horizon=horizon, seed=1,
            device=dev))
        record = {"phase": "population_engine", "clients": clients,
                  "horizon": horizon, "capacity": eng.capacity,
                  "admit_batch": eng.admit_batch,
                  "deliver_batch": eng.deliver_batch,
                  "admitted": m["admitted"], "delivered": m["delivered"],
                  "dropped": m["dropped"], "discarded": m["discarded"],
                  "macro_steps": m["macro_steps"],
                  "steps_by_kind": dict(eng.steps_by_kind), "wall_s": wall,
                  "events_per_s": (m["admitted"] + m["delivered"]) / wall,
                  "macro_step_ms_median": ms,
                  "macro_step_device_launches": per_step,
                  "state_bytes": state_bytes(eng.pop),
                  "tau_max": m["staleness"]["tau_max"], "checks": checks}
        emit(record)
        rows.append(record)
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"population engine at {clients}: {failed}")
        del eng
        torch.cuda.empty_cache()
    return rows


def population_quad_on_both(dev) -> dict:
    """The quad task (d = 2048, K = 4), concurrency 8, cohorts of 4, 40
    uploads, in-step draws under ``lognormal_dropout`` and
    ``trace_replay``, on the card and on the CPU: every macro step's
    packed output field, the final population state, x, x-hat and
    momentum bit for bit."""
    import numpy as np

    from repro_torch.core import QAFeL
    from repro_torch.examples import cohort_scenarios as cs
    from repro_torch.sim import PopulationAsyncFLSimulator, SimConfig

    out = {}
    for scenario in ("lognormal_dropout", "trace_replay"):
        runs = {}
        for d in ("cpu", dev):
            task = cs.quad_task(d)
            algo = QAFeL(cs.qafel_config(4), task.loss_fn, task.params0,
                         device=d)
            with _StepTimer(timed=False, record=True) as rec:
                res = PopulationAsyncFLSimulator(
                    algo, SimConfig(concurrency=8, max_uploads=40,
                                    eval_every_steps=3),
                    task.client_batches, task.eval_fn, scenario=scenario,
                    cohort_size=4).run()
            runs[str(d)] = (algo, res, rec.outs, rec.pop)
        (ca, cr, couts, cpop), (ga, gr, gouts, gpop) = (runs["cpu"],
                                                         runs[str(dev)])
        assert len(couts) == len(gouts) > 0, scenario
        for i, (c, g) in enumerate(zip(couts, gouts)):
            for key in c.keys():
                a, b = np.asarray(c[key]), np.asarray(g[key])
                if a.dtype == np.float32:
                    a, b = a.view(np.int32), b.view(np.int32)
                assert np.array_equal(a, b), (scenario, i, key)
        for key, v in cpop.items():
            assert bits_equal(v, gpop[key].cpu()), (scenario, key)
        for name in ("x_flat", "hidden_flat", "momentum_flat"):
            assert bits_equal(getattr(ca.state, name),
                              getattr(ga.state, name).cpu()), name
        assert ca.meter.summary() == ga.meter.summary()
        assert cr.sim_time == gr.sim_time
        out[scenario] = {"macro_steps": len(couts),
                         "dropped_uploads": cr.metrics["dropped_uploads"]}
    record = {"phase": "population_quad_card_vs_cpu", "bit_exact": True,
              "runs": out}
    emit(record)
    return record


def cnn_grad_vs_fixture(dev) -> dict:
    """The CNN's gradients on the card against the JAX reference's eager
    ones (``tests/fixtures_torch/cnn_grad_ref.npz``, made on the CPU), for
    one batch with ``train=False`` and one with the fixture's dropout key,
    each computed twice with cuDNN's default algorithms: the largest
    difference per leaf, within rtol ``GRAD_RTOL`` and atol ``GRAD_ATOL``,
    and whether the two runs are bit-equal."""
    import numpy as np
    import torch

    from repro_torch.common.tree import tree_leaves
    from repro_torch.core.quantizers import TreeLayout
    from repro_torch.data import SyntheticCelebA
    from repro_torch.models.cnn import cnn_loss, init_cnn

    with np.load(FIXTURE) as z:
        ref = {k: z[k] for k in z.files}
    layout = TreeLayout.of(init_cnn(0, device="cpu"))
    params = layout.unflatten(torch.from_numpy(ref["params"]).to(dev))
    data = SyntheticCelebA(n_samples=int(ref["n_samples"])).batch(
        ref["indices"])
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    key = torch.from_numpy(ref["dropout_key"].astype(np.int64))
    assert not torch.backends.cudnn.deterministic
    record = {"phase": "cnn_grad_vs_fixture", "rtol": GRAD_RTOL,
              "atol": GRAD_ATOL, "modes": {}}
    ok = True
    for mode in ("eval", "train"):
        train = mode == "train"
        runs = []
        for _ in range(2):
            grads = torch.func.grad(
                lambda p: cnn_loss(p, batch, train=train,
                                   key=key if train else None)[0])(params)
            runs.append([g.detach().reshape(-1) for g in tree_leaves(grads)])
        torch.cuda.synchronize()
        want = torch.from_numpy(ref[f"grad_{mode}"])
        leaves, off, within = [], 0, True
        for g in runs[0]:
            w = want[off:off + g.numel()]
            off += g.numel()
            diff = (g.cpu().double() - w.double()).abs()
            tol = GRAD_ATOL + GRAD_RTOL * w.double().abs()
            within &= bool((diff <= tol).all())
            leaves.append(float(diff.max()))
        same = all(bits_equal(a, b) for a, b in zip(*runs))
        record["modes"][mode] = {"max_abs_diff_per_leaf": leaves,
                                 "within_tolerance": within,
                                 "two_runs_bit_equal": same}
        ok &= within
    emit(record)
    if not ok:
        raise AssertionError("the card's CNN gradients are outside the "
                             "stated tolerance of the reference's")
    return record


def run_population(dev, hash_int32: dict) -> tuple:
    """The population-engine phase; returns the population_cnn record and
    its launch counts."""
    import torch

    population_quad_on_both(dev)
    population_host_vs_cohort(dev)
    torch.cuda.empty_cache()
    record, launches = population_cnn(dev, hash_int32)
    population_engine_rows(dev)
    cnn_grad_vs_fixture(dev)
    torch.cuda.empty_cache()
    return record, launches


# the LLM round (queue A items 14a, 13a): gemma2-2b at full width and bf16
# at its published depth (26 layers), the federated example's QAFeL
# settings (qsgd4 both ways, K = 4, P = 2, local batch 2, sequence 64),
# every message encoded in row chunks of LLM_CHUNK_ROWS, remat on (the
# round's default); one warm-up round, 2 measured, 1 profiled
# LLM_ROUNDS measured rounds (2 until model_mesh took their time)
LLM_ARCH, LLM_LAYERS, LLM_SEQ, LLM_ROUNDS = "gemma2-2b", 26, 64, 1
LLM_CHUNK_ROWS = 1 << 20
# the round's peak by count of its buffers (PERF.md section 5): x, x-hat
# and m in bf16 (6 B an element), the f32 sum buf (4 B), a client's y and
# its gradients in bf16 (4 B), one message's codes and norms (d/2 +
# 4*ceil(d/128) B), the chunk transients (four f32 chunks) and the
# activations with the tied embedding's second gradient
LLM_TRANSIENT_BYTES = 4 * 4 * 128 * LLM_CHUNK_ROWS + 2.0e9
LLM_PEAK_SLACK, LLM_PEAK_CAP_GB = 1.15, 60.0
LLM_PLAIN_CHUNK_ROWS = 1 << 18  # rows per chunk of the plain versions
# the reduced round card vs CPU: model math within this of the CPU's
LLM_REDUCED_LOSS_RTOL = 1e-4
LLM_REDUCED_CHUNK_ROWS = 1000
# llm_streamed_vs_whole: full width cut to 2 layers (one super-block), one
# round whole and one in ragged row chunks
LLM_STREAM_LAYERS, LLM_STREAM_CHUNK_ROWS = 2, 4099


def llm_peak_reckoning(d: int, taps: bool = False) -> float:
    """The round's peak bytes by the count of its buffers; with taps, the
    five rows of level-1 window sums, 20 B per 32 elements, on top."""
    return (14.5 * d + 4 * -(-d // 128) + LLM_TRANSIENT_BYTES
            + (20 * -(-d // 32) if taps else 0))


LLM_PHASES = ("client", "accumulate", "server", "broadcast")
# the port's kernels on the round's path
ROUND_KERNELS = ("qsgd_quantize_pack_threefry", "qsgd_unpack_dequantize",
                 "server_update", "round_taps")


def phase_activity(prof, path: Path, phases) -> dict:
    """Device activity by phase of a profiled run, from its trace: each
    kernel, copy and fill counts in the ``record_function`` range of
    ``phases`` during which its launch call was made (on any thread: the
    autograd engine launches the backward from its own), else in
    ``"other"``. Returns {phase: {"ms", "launches", "wall_ms"}}, ``ms`` the
    device time, ``launches`` the device activities, ``wall_ms`` the
    range's own duration on the host."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("name") in phases)
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out = {name: {"ms": 0.0, "launches": 0, "wall_ms": 0.0}
           for name in tuple(phases) + ("other",)}
    for t0, t1, name in ranges:
        out[name]["wall_ms"] += (t1 - t0) / 1e3
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset") \
                or "spin_kernel" in e.get("name", ""):
            continue
        ts = launched.get(e.get("args", {}).get("correlation"))
        name = next((n for t0, t1, n in ranges
                     if ts is not None and t0 <= ts <= t1), "other")
        out[name]["ms"] += e["dur"] / 1e3
        out[name]["launches"] += 1
    return out


def phase_device_ms(prof, path: Path) -> dict:
    """Device ms by phase of a profiled round (``phase_activity`` over the
    round's ranges ``LLM_PHASES``; the batch's copies and the drift go to
    ``"other"``)."""
    return {name: v["ms"] for name, v in
            phase_activity(prof, path, LLM_PHASES).items()}


def kernel_table(prof) -> dict:
    """{kernel name: (launches, device ms)} of a profile's CUDA activities
    (the profiler's own spin kernel and the ranges left out), read from
    its raw events (``kineto_results.events()``) without building the
    profiler's event tree, which takes minutes for a 48-layer round's
    ~130,000 kernels."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation() \
                and "spin_kernel" not in e.name():
            c, t = by_name.get(e.name(), (0, 0.0))
            by_name[e.name()] = (c + 1, t + e.duration_ns() / 1e6)
    return by_name


def llm_round(dev) -> tuple:
    """The QAFeL round on gemma2-2b at full width and depth (26 layers,
    bf16) through ``distributed.steps.make_qafel_round`` with
    ``chunk_rows = LLM_CHUNK_ROWS`` and remat, as ``examples.federated_llm``
    drives it: one warm-up round, then ``LLM_ROUNDS`` rounds with the
    launch counters set to 0 just before and read just after (loss,
    |x - x_hat|_1, ms by CUDA events, peak memory, bytes per upload), then
    one round under ``torch.profiler`` (launches and device time per
    kernel, device time by phase); then one round with the taps on
    (``llm_round_taps``: its ms, launches and taps, its peak against the
    reckoning with the tap rows) and a taps-off and a taps-on round timed
    by CUDA events from the last upload on (the device ms the taps add to
    the server half and after the broadcast). Hidden and momentum are then freed and the trained x kept for
    serving. Returns (record, launches, d, x tree, taps record)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.common import prng
    from repro_torch.common.tree import tree_leaves
    from repro_torch.distributed.steps import (init_round_state,
                                               make_qafel_round)
    from repro_torch.examples import federated_llm as fl
    from repro_torch.launch.train import round_batch
    from repro_torch.kernels import launches as kernel_launches
    from repro_torch.kernels import reset_launches
    from repro_torch.obs.taps import FLUSH_TAP_NAMES

    cfg = configs.get_config(LLM_ARCH)
    if cfg.n_layers != LLM_LAYERS:
        raise AssertionError(f"{LLM_ARCH} has {cfg.n_layers} layers")
    qcfg = fl.qafel_config(4)
    k = qcfg.buffer_size
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    holder = [init_round_state(cfg, 0, dev)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    d = sum(t.numel() for t in tree_leaves(holder[0].x))
    rows = -(-d // 128)
    chunks = -(-rows // LLM_CHUNK_ROWS)
    round_fn = make_qafel_round(cfg, qcfg, chunk_rows=LLM_CHUNK_ROWS)
    weights = torch.ones(k)
    rng = np.random.default_rng(0)

    def one(step: int, fn=round_fn) -> dict:
        batch = round_batch(cfg, qcfg, rng, fl.LOCAL_BATCH, LLM_SEQ, dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        new, met = fn(holder[0], batch, weights, prng.PRNGKey(step))
        end.record()
        holder[0] = new
        del batch
        drift = fl.model_drift(new.x, new.hidden)
        torch.cuda.synchronize()
        row = {"round": step, "loss": float(met["loss"]),
               "drift_l1": float(drift), "ms": start.elapsed_time(end),
               "upload_bytes": met["upload_bytes"],
               "broadcast_bytes": met["broadcast_bytes"]}
        if "taps" in met:
            row["taps"] = met["taps"].cpu().tolist()
        emit({"phase": "llm_round_step", **row})
        return row

    warm = one(0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rows_out = [one(step) for step in range(1, 1 + LLM_ROUNDS)]
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize()
        profiled = one(1 + LLM_ROUNDS)
    by_name = kernel_table(prof)

    def kernel(part: str, by_name=by_name) -> dict:
        hits = [(c, t) for name, (c, t) in by_name.items() if part in name]
        n = sum(c for c, _ in hits)
        ms = sum(t for _, t in hits)
        return {"launches": n, "device_ms": ms,
                "ms_per_launch": ms / n if n else None}

    k1 = kernel("quantize_pack_threefry")
    k3 = kernel("unpack_dequantize")
    su = kernel("server_update")
    busy = sum(t for _, t in by_name.values())
    phases = phase_device_ms(prof, ROOT / "build" / "llm_round_trace.json")
    ms = [r["ms"] for r in rows_out]
    per_round = lambda name: launches[name] / LLM_ROUNDS
    # the design's launches per round: each of the K uploads and the
    # broadcast is one K1 launch per row chunk; K3 decodes each upload into
    # buf (weighted, in place) and the broadcast into x-hat (in place); one
    # server update
    want = {"qsgd_quantize_pack_threefry": (k + 1) * chunks,
            "qsgd_unpack_dequantize": k + 1, "server_update": 1}
    reckoning = llm_peak_reckoning(d)
    upload_want = (4 * d + 32 * rows) / 8
    record = {
        "phase": "llm_round", "arch": cfg.arch_id, "n_layers": cfg.n_layers,
        "cut": "none", "d": d, "param_count": cfg.param_count(),
        "dtype": cfg.param_dtype, "seq": LLM_SEQ, "local_batch":
        fl.LOCAL_BATCH, "K": k, "P": qcfg.local_steps,
        "chunk_rows": LLM_CHUNK_ROWS, "row_chunks": chunks, "remat": True,
        "init_s": init_s, "warmup_round": warm, "rounds": rows_out,
        "ms_median": statistics.median(ms), "ms_rounds": ms,
        "profiled_round": {"ms": profiled["ms"], "K1": k1, "K3": k3,
                           "server_update": su,
                           "phases_device_ms": phases,
                           "client_training_device_ms": phases["client"]
                           - k * chunks * (k1["ms_per_launch"] or 0.0),
                           "device_busy_ms": busy,
                           "device_launches": sum(
                               c for c, _ in by_name.values())},
        "peak_bytes": peak, "peak_gb": peak / 1e9,
        "peak_reckoning_gb": reckoning / 1e9,
        "peak_limit_gb": min(LLM_PEAK_SLACK * reckoning / 1e9,
                             LLM_PEAK_CAP_GB),
        "launches_per_round": {n: per_round(n) for n in want},
        "launches_per_round_formula": {
            "qsgd_quantize_pack_threefry": "(K + 1) * ceil(rows / chunk_rows)",
            "qsgd_unpack_dequantize": "K + 1", "server_update": "1"},
        "upload_bytes": rows_out[0]["upload_bytes"],
        "upload_bytes_formula": "(4*d + 32*ceil(d/128)) / 8"}
    checks = {
        "losses_finite": all(math.isfinite(r["loss"])
                             for r in rows_out + [warm, profiled]),
        "drift_positive": all(r["drift_l1"] > 0 for r in rows_out),
        **{f"{n}_per_round": per_round(n) == v for n, v in want.items()},
        "k1_profiled": k1["launches"] == want["qsgd_quantize_pack_threefry"],
        "k3_profiled": k3["launches"] == want["qsgd_unpack_dequantize"],
        "server_update_profiled": su["launches"] == 1,
        "other_kernels_idle": all(v == 0 for n, v in launches.items()
                                  if n not in want
                                  and n not in MODEL_KERNELS),
        # the loss's logsumexp: one launch a loss chunk (one at seq 64) a
        # step each way
        "logsumexp_per_step": all(per_round(n) == k * qcfg.local_steps
                                  for n in LSE_KERNELS),
        "peak_under_reckoning": peak <= LLM_PEAK_SLACK * reckoning
        and peak < LLM_PEAK_CAP_GB * 1e9,
        "phases_read": all(phases[name] > 0 for name in LLM_PHASES),
        "upload_bytes_exact": all(r["upload_bytes"] == upload_want
                                  for r in rows_out)}
    record["checks"] = checks
    emit(record)
    if not all(checks.values()):
        raise AssertionError(f"llm_round: {checks}")

    # one round with the taps on (queue A item 13c), after the taps-off
    # ones: timed and counted; then one taps-off and one taps-on round with
    # CUDA events at the last client's upload (A), at the broadcast (B,
    # after its decode into x-hat) and at the round's end (C): B - A is the
    # device time of the last weighted add, the server update and the
    # broadcast, where the taps' squares are taken; C - B holds the taps'
    # finishing pass (the clients run the same code either way)
    taps_fn = make_qafel_round(cfg, qcfg, chunk_rows=LLM_CHUNK_ROWS,
                               taps=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    trow = one(2 + LLM_ROUNDS, taps_fn)
    taps_launches = kernel_launches()
    taps_peak = torch.cuda.max_memory_allocated()

    def windowed(taps: bool, step: int) -> dict:
        ev = {}

        def mark(name):
            ev[name] = torch.cuda.Event(enable_timing=True)
            ev[name].record()

        def at_message(kind, index, packed, norms):
            if (kind, index) in (("upload", k - 1), ("broadcast", k)):
                mark(kind)

        fn = make_qafel_round(cfg, qcfg, chunk_rows=LLM_CHUNK_ROWS,
                              taps=taps, on_message=at_message)

        def timed_fn(*args):
            out = fn(*args)
            mark("end")
            return out

        one(step, timed_fn)
        return {"server_broadcast_ms": ev["upload"].elapsed_time(
                    ev["broadcast"]),
                "after_broadcast_ms": ev["broadcast"].elapsed_time(ev["end"])}

    w_off, w_on = windowed(False, 3 + LLM_ROUNDS), windowed(True,
                                                            4 + LLM_ROUNDS)
    taps_reckoning = llm_peak_reckoning(d, taps=True)
    taps_record = {
        "phase": "llm_round_taps", "arch": cfg.arch_id,
        "n_layers": cfg.n_layers, "d": d, "ms": trow["ms"],
        "ms_taps_off_median": record["ms_median"],
        "taps": dict(zip(FLUSH_TAP_NAMES, trow["taps"])),
        "device_ms_taps_off": w_off, "device_ms_taps_on": w_on,
        "added_device_ms": {n: w_on[n] - w_off[n] for n in w_on},
        "added_device_ms_note": "server_broadcast: the last weighted add, "
        "the server update and the broadcast (K1 chunks, K3 into x-hat), "
        "by CUDA events; after_broadcast: the taps' finishing pass",
        "added_port_launches": {n: taps_launches[n] - launches[n]
                                / LLM_ROUNDS for n in ROUND_KERNELS},
        "launches": {n: v for n, v in taps_launches.items() if v},
        "peak_bytes": taps_peak, "peak_gb": taps_peak / 1e9,
        "peak_reckoning_gb": taps_reckoning / 1e9,
        "peak_limit_gb": min(LLM_PEAK_SLACK * taps_reckoning / 1e9,
                             LLM_PEAK_CAP_GB),
        "partials_gb": 20 * -(-d // 32) / 1e9}
    want_taps = {**want, "round_taps": 1}
    taps_checks = {
        "taps_finite": all(math.isfinite(v) for v in trow["taps"]),
        "taps_seven": len(trow["taps"]) == len(FLUSH_TAP_NAMES) == 7,
        **{f"{n}_launches": taps_launches[n] == v
           for n, v in want_taps.items()},
        "other_kernels_idle": all(v == 0 for n, v in taps_launches.items()
                                  if n not in want_taps
                                  and n not in MODEL_KERNELS),
        "one_added_port_launch": all(
            v == (n == "round_taps")
            for n, v in taps_record["added_port_launches"].items()),
        "peak_under_reckoning": taps_peak <= LLM_PEAK_SLACK * taps_reckoning
        and taps_peak < LLM_PEAK_CAP_GB * 1e9}
    taps_record["checks"] = taps_checks
    emit(taps_record)
    if not all(taps_checks.values()):
        raise AssertionError(f"llm_round_taps: {taps_checks}")
    launches["round_taps"] = taps_launches["round_taps"]

    # serve the trained x: hidden, momentum and the round's buffers go
    x_tree = holder.pop().x
    del round_fn, taps_fn
    torch.cuda.empty_cache()
    return record, launches, d, x_tree, taps_record


def _plain_threefry_rows(x, key, bits: int, r0: int, r1: int):
    """``ref.quantize_pack_threefry`` of the whole message, rows r0..r1
    only: the rows' values and their elements' threefry counters (the
    dither of element i is ``threefry(key, (0, i))``)."""
    import torch

    from repro_torch.common import prng
    from repro_torch.kernels import ref

    d = x.numel()
    seg = x[r0 * 128:min(d, r1 * 128)]
    x2d = torch.nn.functional.pad(seg, (0, (r1 - r0) * 128 - seg.numel()))
    lo = torch.arange(r0 * 128, r1 * 128, dtype=torch.int64, device=x.device)
    w0, w1 = prng.threefry2x32(key, torch.zeros_like(lo), lo)
    u = ((w0 ^ w1) >> 9).to(torch.float32) * 2.0 ** -23
    return ref.quantize_pack(x2d.reshape(-1, 128), u.reshape(-1, 128), bits)


def _det_values(a: int, b: int, scale: float, salt: int, dtype, dev):
    """Values of flat elements [a, b) of a vector made from its indices
    alone (a multiplicative hash, uniform in [-scale/2, scale/2)), so any
    chunk of it can be made again after a kernel wrote over it."""
    import torch

    idx = torch.arange(a, b, dtype=torch.int64, device=dev)
    h = ((idx + salt) * 0x9E3779B1) & 0xFFFFFF
    return ((h.to(torch.float32) * 2.0 ** -24 - 0.5) * scale).to(dtype)


def llm_kernels(dev, d: int, dither_int32: dict, int32_ops_per_s: float,
                suffix: str = "llm", check=None, taps: bool = True) -> dict:
    """The round's kernels at its d, against their plain versions taken in
    row chunks, bit for bit, with kernel times (CUDA events), plain times
    and bounds: K1 (the threefry upload and broadcast encode) over the
    whole message and in the round's row chunks at their row offsets
    (each chunk bit-equal to those rows of the whole); K3 (the plain
    decode, the weighted add into an f32 sum in place, the broadcast
    decode added into a bf16 x-hat in place, and that apply with the
    round's taps); the server-update kernel on a bf16 state, without and
    with the taps; the taps' finishing pass over the tap rows the two
    wrote. The in-place kernels' inputs are made from their indices
    (``_det_values``), so each chunk's plain version runs on the inputs
    remade. ``check``: the (r0, r1) row ranges where each kernel is held
    to its plain version and the plain version timed (None: every chunk,
    the whole vector); ``taps=False`` leaves out the taps' variants; each
    case is named with ``suffix``."""
    import numpy as np
    import torch

    from repro_torch.kernels import qsgd, ref
    from repro_torch.kernels.server_update import server_update_
    from repro_torch.kernels.taps import round_taps

    rows = ref.rows_for(d)
    windows = ref.tap_windows(d)
    parts = (torch.empty((ref.ROUND_TAP_SUMS, windows), device=dev)
             if taps else None)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(d, generator=gen, device=dev) * 1e-3
    x[:1000] = 0.0  # an all-zero bucket
    key = torch.tensor([0x9E3779B9, 0xFFFFFFF0])
    code_b = 16 * BITS
    out = {}

    def timed(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def finish(name, equal, err, ms, plain_ms, nbytes, ops, rate, formula):
        bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, ops / rate
        rec = dict(equal=equal, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=1e3 * max(bytes_s, ops_s),
                   bound_by="bytes" if bytes_s >= ops_s else "operations",
                   bytes=nbytes, bytes_formula=formula, d=d, rows=rows)
        rec["bound_share"] = rec["bound_ms"] / ms
        rec["plain_rows"] = sum(r1 - r0 for r0, r1 in checked)
        name = f"{name}_{suffix}"
        emit({"phase": "llm_kernel", "name": name, **rec})
        if not equal:
            raise AssertionError(f"{name} at d={d}: kernel and plain differ "
                                 f"(max abs err {err})")
        out[name] = rec

    def chunks_of(step):
        return [(r0, min(rows, r0 + step)) for r0 in range(0, rows, step)]

    fill = chunks_of(LLM_PLAIN_CHUNK_ROWS)
    checked = fill if check is None else check

    packed, norms = qsgd.qsgd_quantize_pack_threefry(x, key, BITS)
    torch.cuda.synchronize()
    equal, err = True, 0.0
    for r0, r1 in checked:
        p, n = _plain_threefry_rows(x, key, BITS, r0, r1)
        equal &= bits_equal(p, packed[r0:r1]) and bits_equal(n, norms[r0:r1])
        err = max(err, float((n - norms[r0:r1]).abs().max()))
    k1_bytes = d * 4 + rows * (code_b + 4)
    finish("K1_threefry", equal, err,
           device_ms(lambda: qsgd.qsgd_quantize_pack_threefry(x, key, BITS),
                     5),
           timed(lambda: [_plain_threefry_rows(x, key, BITS, r0, r1)
                          for r0, r1 in checked]),
           k1_bytes, d * dither_int32["bound"], int32_ops_per_s,
           "d*4 x + rows*(128*bits/8 + 4)")

    def k1_chunked():
        return [qsgd.qsgd_quantize_pack_threefry(
            x[r0 * 128:r1 * 128], key, BITS, row0=r0, total_rows=rows)
            for r0, r1 in chunks_of(LLM_CHUNK_ROWS)]

    equal, err = True, 0.0
    for (r0, r1), (p, n) in zip(chunks_of(LLM_CHUNK_ROWS), k1_chunked()):
        equal &= bits_equal(p, packed[r0:r1]) and bits_equal(n, norms[r0:r1])
        err = max(err, float((n - norms[r0:r1]).abs().max()))
        want_p, want_n = ref.quantize_pack_threefry(
            x[r0 * 128:r0 * 128 + 128 * min(2, r1 - r0)], key, BITS, row0=r0)
        equal &= bits_equal(want_p, p[:2]) and bits_equal(want_n, n[:2])
    finish("K1_row_offset", equal, err, device_ms(k1_chunked, 5),
           timed(lambda: [_plain_threefry_rows(x, key, BITS, r0, r1)
                          for r0, r1 in checked]),
           k1_bytes, d * dither_int32["bound"], int32_ops_per_s,
           "d*4 x + rows*(128*bits/8 + 4), in chunks of "
           f"{LLM_CHUNK_ROWS} rows")
    del x
    torch.cuda.empty_cache()

    got = qsgd.qsgd_unpack_dequantize(packed, norms, BITS)
    torch.cuda.synchronize()
    equal, err = True, 0.0
    for r0, r1 in checked:
        want = ref.unpack_dequantize(packed[r0:r1], norms[r0:r1], BITS)
        equal &= bits_equal(want, got[r0:r1])
        err = max(err, float((want - got[r0:r1]).abs().max()))
    del got
    finish("K3", equal, err,
           device_ms(lambda: qsgd.qsgd_unpack_dequantize(packed, norms,
                                                         BITS), 5),
           timed(lambda: [ref.unpack_dequantize(packed[r0:r1], norms[r0:r1],
                                                BITS)
                          for r0, r1 in checked]),
           rows * (code_b + 4) + rows * 128 * 4, rows * 128 * 4,
           F32_OPS_PER_S, "rows*(128*bits/8 + 4) + rows*128*4 out")

    weight = torch.tensor([0.7], device=dev)
    for name, dtype, w in (("K3_accum_inplace", torch.float32, weight),
                           ("K3_apply_inplace_bf16", torch.bfloat16, None)):
        make = lambda a, b: _det_values(a, b, 2e-2, 5, dtype, dev)
        acc = torch.empty(d, dtype=dtype, device=dev)
        for r0, r1 in fill:
            acc[r0 * 128:min(d, r1 * 128)] = make(r0 * 128,
                                                  min(d, r1 * 128))
        qsgd.qsgd_unpack_dequantize(packed, norms, BITS, acc=acc, weight=w)
        torch.cuda.synchronize()
        equal, err, plain_ms = True, 0.0, 0.0
        for r0, r1 in checked:
            a = make(r0 * 128, min(d, r1 * 128))
            start = time.perf_counter()
            want = ref.unpack_dequantize(
                packed[r0:r1], norms[r0:r1], BITS, acc=a.to(torch.float32),
                weight=w).reshape(-1)[:a.numel()].to(dtype)
            torch.cuda.synchronize()
            plain_ms += 1e3 * (time.perf_counter() - start)
            seg = acc[r0 * 128:min(d, r1 * 128)]
            equal &= bits_equal(want, seg)
            err = max(err, float((want.float() - seg.float()).abs().max()))
        size = acc.element_size()
        finish(name, equal, err,
               device_ms(lambda: qsgd.qsgd_unpack_dequantize(
                   packed, norms, BITS, acc=acc, weight=w), 5),
               plain_ms, rows * (code_b + 4) + 2 * size * d,
               d * (4 if w is None else 5), F32_OPS_PER_S,
               f"rows*(128*bits/8 + 4) + d*{size} acc read + d*{size} "
               "written")
        del acc

    # K3's x-hat apply with the round's taps: a bf16 x-hat, an f32 diff
    if taps:
        make_acc = lambda a, b: _det_values(a, b, 2e-2, 5, torch.bfloat16,
                                            dev)
        make_diff = lambda a, b: _det_values(a, b, 4e-3, 6, torch.float32,
                                             dev)
        acc = torch.empty(d, dtype=torch.bfloat16, device=dev)
        diff = torch.empty(d, device=dev)
        for r0, r1 in fill:
            a, b = r0 * 128, min(d, r1 * 128)
            acc[a:b], diff[a:b] = make_acc(a, b), make_diff(a, b)
        qsgd.qsgd_unpack_dequantize(packed, norms, BITS, acc=acc,
                                    tap_diff=diff, taps=parts[3:])
        torch.cuda.synchronize()
        start = time.perf_counter()
        want = ref.dequantize_taps(packed, norms, BITS, diff)
        equal = bits_equal(want, parts[3:])
        err = float((want - parts[3:]).abs().max())
        for r0, r1 in checked:
            a, b = r0 * 128, min(d, r1 * 128)
            w_acc = ref.unpack_dequantize(
                packed[r0:r1], norms[r0:r1], BITS,
                acc=make_acc(a, b).to(torch.float32)).reshape(-1)[
                    :b - a].to(torch.bfloat16)
            equal &= bits_equal(w_acc, acc[a:b])
            err = max(err, float((w_acc.float() - acc[a:b].float())
                                 .abs().max()))
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - start)
        finish("K3_apply_taps_bf16", equal, err,
               device_ms(lambda: qsgd.qsgd_unpack_dequantize(
                   packed, norms, BITS, acc=acc, tap_diff=diff,
                   taps=parts[3:]), 5),
               plain_ms,
               rows * (code_b + 4) + 2 * 2 * d + 4 * d + 8 * windows,
               8 * d, F32_OPS_PER_S,
               "rows*(128*bits/8 + 4) + d*2 acc read + d*2 written + d*4 "
               "diff + ceil(d/32)*2*4 tap rows")
        del acc, diff, want
    del packed, norms
    torch.cuda.empty_cache()

    # the server update on a bf16 state: buf f32, m, x, x-hat bf16
    specs = (("buf", torch.float32, 4e-2, 1), ("m", torch.bfloat16, 1e-2, 2),
             ("x", torch.bfloat16, 2.0, 3), ("xhat", torch.bfloat16, 2.0, 4))
    state = {}
    for name, dtype, scale, salt in specs:
        t = torch.empty(d, dtype=dtype, device=dev)
        for r0, r1 in fill:
            a, b = r0 * 128, min(d, r1 * 128)
            t[a:b] = _det_values(a, b, scale, salt, dtype, dev)
        state[name] = t
    kw = dict(k=4, beta=0.3, lr=1.0)
    server_update_(state["buf"], state["m"], state["x"], state["xhat"], **kw)
    torch.cuda.synchronize()
    equal, err, plain_ms = True, 0.0, 0.0
    for r0, r1 in checked:
        a, b = r0 * 128, min(d, r1 * 128)
        fresh = [_det_values(a, b, scale, salt, dtype, dev)
                 for _, dtype, scale, salt in specs]
        start = time.perf_counter()
        ref.server_update_(*fresh, inv_k=0.25, beta=float(np.float32(0.3)),
                           lr=1.0)
        torch.cuda.synchronize()
        plain_ms += 1e3 * (time.perf_counter() - start)
        for (name, _, _, _), want in zip(specs[:3], fresh[:3]):
            equal &= bits_equal(want, state[name][a:b])
            err = max(err, float((want.float() - state[name][a:b].float())
                                 .abs().max()))
    finish("server_update", equal, err,
           device_ms(lambda: server_update_(
               state["buf"], state["m"], state["x"], state["xhat"], **kw), 5),
           plain_ms, 18 * d, 7 * d, F32_OPS_PER_S,
           "d*(4 buf + 3*2 m, x, x-hat read + 4 buf + 2*2 m, x written)")

    if not taps:
        del state
        torch.cuda.empty_cache()
        return out

    # the same with the round's taps: three rows of level-1 window sums
    for name, dtype, scale, salt in specs:
        for r0, r1 in fill:
            a, b = r0 * 128, min(d, r1 * 128)
            state[name][a:b] = _det_values(a, b, scale, salt, dtype, dev)
    server_update_(state["buf"], state["m"], state["x"], state["xhat"],
                   taps=parts[:3], **kw)
    torch.cuda.synchronize()
    want = torch.empty((3, windows), device=dev)
    equal, err, plain_ms = True, 0.0, 0.0
    for r0, r1 in checked:
        a, b = r0 * 128, min(d, r1 * 128)
        fresh = [_det_values(a, b, scale, salt, dtype, dev)
                 for _, dtype, scale, salt in specs]
        start = time.perf_counter()
        ref.server_update_(*fresh, inv_k=0.25, beta=float(np.float32(0.3)),
                           lr=1.0, taps=want[:, a // 32:-(-b // 32)])
        torch.cuda.synchronize()
        plain_ms += 1e3 * (time.perf_counter() - start)
        for (name, _, _, _), w in zip(specs[:3], fresh[:3]):
            equal &= bits_equal(w, state[name][a:b])
            err = max(err, float((w.float() - state[name][a:b].float())
                                 .abs().max()))
    equal &= bits_equal(want, parts[:3])
    err = max(err, float((want - parts[:3]).abs().max()))
    finish("server_update_taps", equal, err,
           device_ms(lambda: server_update_(
               state["buf"], state["m"], state["x"], state["xhat"],
               taps=parts[:3], **kw), 5),
           plain_ms, 18 * d + 12 * windows, 13 * d, F32_OPS_PER_S,
           "d*18 (the update) + ceil(d/32)*3*4 tap rows")
    del state, want
    torch.cuda.empty_cache()

    # the taps' finishing pass over the five rows the two kernels wrote
    weights = torch.tensor([0.9, 1.0, 0.7, 0.5], device=dev)
    got = round_taps(parts, weights)
    torch.cuda.synchronize()
    start = time.perf_counter()
    want = ref.round_taps_finish(parts, weights)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - start)
    finish("round_taps", bits_equal(got, want),
           float((got - want).abs().max()),
           device_ms(lambda: round_taps(parts, weights), 5), plain_ms,
           4 * ref.ROUND_TAP_SUMS * windows, ref.ROUND_TAP_SUMS * windows,
           F32_OPS_PER_S, "5 rows * ceil(d/32) * 4 read")
    del parts
    torch.cuda.empty_cache()
    return out


def _server_half_card_vs_cpu(dev, cfg) -> bool:
    """The server half of ``cfg``'s round on both devices from the same
    trees (its initial x, x-hat and m moved by seeded noise, each leaf in
    its dtype: a mixed tree's other leaves beside its buffers), the same
    K packed client messages and weights, through the round's weighted
    accumulation (``steps.accumulate``: K3's weighted mode in place) and
    ``steps.server_half`` (the server-update kernel, the chunked K1, K3
    into x-hat in place, the side leaves' plain recompute): every leaf
    of x, x-hat and m and the broadcast bit for bit."""
    import torch

    from repro_torch.common import prng
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.core.quantizers import TreeLayout
    from repro_torch.distributed import steps
    from repro_torch.examples import federated_llm as fl
    from repro_torch.kernels import ops

    base = steps.init_round_state(cfg, 0, "cpu")
    g = torch.Generator().manual_seed(5)
    noisy = lambda tr, s: tree_map(lambda t: (t.float() + s * torch.randn(
        t.shape, generator=g)).to(t.dtype), tr)
    trees = (base.x, noisy(base.x, 2e-3), noisy(base.momentum, 1e-3))
    d = sum(t.numel() for t in tree_leaves(base.x))
    packed, norms = ops.qsgd_quantize_batch(
        3e-3 * torch.randn((4, d), generator=g),
        torch.randint(0, 2 ** 32, (4, 2), generator=g), BITS)
    w = torch.tensor([0.9, 1.0, 0.7, 0.5])
    out = {}
    for where in ("cpu", dev):
        st = steps.RoundState.from_trees(
            *(tree_map(lambda t: t.to(where), tr) for tr in trees))
        buf = torch.zeros(d, device=where)
        for kk in range(4):
            steps.accumulate(buf, packed[kk].to(where), norms[kk].to(where),
                             w[kk:kk + 1].to(where), bits=BITS, d=d)
        bp, bn = steps.server_half(
            *st.flat, buf, prng.PRNGKey(9), qcfg=fl.qafel_config(4), d=d,
            chunk_rows=LLM_REDUCED_CHUNK_ROWS,
            sides=steps._sides(st, TreeLayout.of(st.x)))
        out[str(where)] = [t.cpu() for tr in (st.x, st.hidden, st.momentum)
                           for t in tree_leaves(tr)] + [bp.cpu(), bn.cpu()]
    return all(bits_equal(a, b) for a, b in zip(out["cpu"],
                                                 out[str(dev)]))


def _route_card_vs_cpu(dev, cfg, params) -> dict:
    """The first MoE layer's router of ``params`` (CPU) over 512 seeded
    tokens on the CPU and the card: the expert ids equal wherever the k-th
    and (k+1)-th probability differ by more than 1e-6 (the gates and
    probs are sums in other orders)."""
    import torch

    from repro_torch.models import moe

    router = params["layers"]["pos0_attn"]["moe"]["router"][0]
    x = torch.randn((512, cfg.d_model),
                    generator=torch.Generator().manual_seed(7))
    g, ids, probs = moe._route(cfg, router, x)
    cg, cids, cprobs = (t.cpu() for t in moe._route(cfg, router.to(dev),
                                                    x.to(dev)))
    k = cfg.experts_per_token
    top = torch.sort(probs, dim=-1, descending=True).values
    decided = top[:, k - 1] - top[:, k] > 1e-6
    return {"tokens": 512, "decided": int(decided.sum()),
            "decided_ids_equal": bool(torch.equal(ids[decided],
                                                  cids[decided])),
            "ids_equal_share": float((ids == cids).double().mean()),
            "gates_max_abs_err": float((g - cg).abs().max()),
            "probs_max_abs_err": float((probs - cprobs).abs().max())}


def llm_reduced_card_vs_cpu(dev, arch: str = LLM_ARCH,
                            rounds: int = 2) -> dict:
    """The reduced ``arch``'s round (f32) on the card and the CPU from the
    same state, batches and keys, every message in row chunks of
    ``LLM_REDUCED_CHUNK_ROWS``: ``rounds`` rounds, losses within
    ``LLM_REDUCED_LOSS_RTOL`` (the model math's orders differ) and the
    share of x-hat bit-equal; and the server half bit for bit
    (``_server_half_card_vs_cpu``), for a Mamba2 config also on its
    mixed bf16/f32 tree (the config in bf16: ``A_log``, ``D`` and
    ``dt_bias`` f32 beside the bf16 buffers); for an MoE config its
    routing ids on both devices (``_route_card_vs_cpu``)."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.common import prng
    from repro_torch.common.tree import tree_map
    from repro_torch.distributed import steps
    from repro_torch.examples import federated_llm as fl
    from repro_torch.launch.train import round_batch

    cfg = configs.get_reduced(arch)
    qcfg = fl.qafel_config(4)
    base = steps.init_round_state(cfg, 0, "cpu")
    runs = {}
    for where in ("cpu", dev):
        st = steps.RoundState.from_trees(
            *(tree_map(lambda t: t.to(where), tr)
              for tr in (base.x, base.hidden, base.momentum)))
        round_fn = steps.make_qafel_round(
            cfg, qcfg, chunk_rows=LLM_REDUCED_CHUNK_ROWS)
        rng = np.random.default_rng(0)
        losses = []
        for step in range(rounds):
            batch = round_batch(cfg, qcfg, rng, fl.LOCAL_BATCH, LLM_SEQ,
                                where)
            st, met = round_fn(st, batch, torch.ones(4), prng.PRNGKey(step))
            losses.append(float(met["loss"]))
        runs[str(where)] = (st, losses)
    (cpu_st, cpu_l), (card_st, card_l) = runs["cpu"], runs[str(dev)]
    hid_equal = float((cpu_st.flat[1].view(torch.int32)
                       == card_st.flat[1].cpu().view(torch.int32)).double()
                      .mean())
    loss_ok = all(abs(a - b) <= LLM_REDUCED_LOSS_RTOL * abs(a)
                  for a, b in zip(cpu_l, card_l))
    half_equal = _server_half_card_vs_cpu(dev, cfg)
    record = {"phase": "llm_reduced_card_vs_cpu", "arch": cfg.arch_id,
              "d": base.flat[0].numel(),
              "chunk_rows": LLM_REDUCED_CHUNK_ROWS,
              "cpu_losses": cpu_l, "card_losses": card_l,
              "losses_within_rtol": loss_ok,
              "loss_rtol": LLM_REDUCED_LOSS_RTOL,
              "hidden_bit_equal_share": hid_equal,
              "server_half_bit_equal": half_equal}
    if cfg.has_mamba():
        half_equal &= _server_half_card_vs_cpu(dev, cfg.replace(
            param_dtype="bfloat16", dtype="bfloat16"))
        record["mixed_server_half_bit_equal"] = half_equal
    if cfg.n_experts:
        record["routing"] = _route_card_vs_cpu(dev, cfg, base.x)
        half_equal &= record["routing"]["decided_ids_equal"]
    emit(record)
    if not (loss_ok and half_equal):
        raise AssertionError(f"llm_reduced_card_vs_cpu: {record}")
    return record


def llm_streamed_vs_whole(dev) -> dict:
    """gemma2-2b at full width cut to 2 layers (one super-block), bf16:
    one round at ``chunk_rows=None`` and one at the ragged
    ``LLM_STREAM_CHUNK_ROWS`` from the same state, batch, weights and key
    (``RoundState.clone``). x, x-hat, m, the loss, the first client's
    upload codes and norms and the broadcast's must be bit-equal; the peak
    ``max_memory_allocated`` of each round above what was allocated before
    it is recorded (it includes the clones of the two messages). The
    messages are read through the round's ``on_message`` hook."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.common import prng
    from repro_torch.common.tree import tree_leaves
    from repro_torch.distributed import steps
    from repro_torch.examples import federated_llm as fl
    from repro_torch.launch.train import round_batch

    cfg = configs.get_config(LLM_ARCH).replace(n_layers=LLM_STREAM_LAYERS)
    qcfg = fl.qafel_config(4)
    torch.cuda.empty_cache()
    base = steps.init_round_state(cfg, 1, dev)
    d = sum(t.numel() for t in tree_leaves(base.x))
    batch = round_batch(cfg, qcfg, np.random.default_rng(3), fl.LOCAL_BATCH,
                        LLM_SEQ, dev)
    weights = torch.tensor([0.9, 1.0, 0.7, 0.5])
    runs = {}
    for chunk_rows in (None, LLM_STREAM_CHUNK_ROWS):
        seen = {}

        def keep(kind, index, packed, norms):
            if kind == "broadcast" or index == 0:
                seen[kind] = (packed.clone(), norms.clone())

        state = base.clone()
        round_fn = steps.make_qafel_round(cfg, qcfg, chunk_rows=chunk_rows,
                                          on_message=keep)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, met = round_fn(state, batch, weights, prng.PRNGKey(7))
        loss = float(met["loss"])
        ms = 1e3 * (time.perf_counter() - t0)
        runs[chunk_rows] = dict(
            state=state, loss=loss, ms=ms, seen=seen,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            round_peak_gb=(torch.cuda.max_memory_allocated() - before) / 1e9)
    whole, chunked = runs[None], runs[LLM_STREAM_CHUNK_ROWS]
    equal = {
        "x": bits_equal(whole["state"].flat[0], chunked["state"].flat[0]),
        "hidden": bits_equal(whole["state"].flat[1],
                             chunked["state"].flat[1]),
        "momentum": bits_equal(whole["state"].flat[2],
                               chunked["state"].flat[2]),
        "loss": whole["loss"] == chunked["loss"],
        "upload": all(bits_equal(a, b) for a, b in zip(
            whole["seen"]["upload"], chunked["seen"]["upload"])),
        "broadcast": all(bits_equal(a, b) for a, b in zip(
            whole["seen"]["broadcast"], chunked["seen"]["broadcast"]))}
    record = {"phase": "llm_streamed_vs_whole", "arch": cfg.arch_id,
              "n_layers": cfg.n_layers, "d": d, "dtype": cfg.param_dtype,
              "chunk_rows": LLM_STREAM_CHUNK_ROWS,
              "row_chunks": -(-(-(-d // 128)) // LLM_STREAM_CHUNK_ROWS),
              "loss": whole["loss"], "bit_equal": equal,
              **{f"{name}_{key}": r[key]
                 for name, r in (("whole", whole), ("chunked", chunked))
                 for key in ("ms", "peak_gb", "round_peak_gb")}}
    emit(record)
    runs.clear()
    del base, whole, chunked
    torch.cuda.empty_cache()
    if not all(equal.values()):
        raise AssertionError(f"llm_streamed_vs_whole: {record}")
    return record


def llm_round_taps_2layer(dev) -> dict:
    """gemma2-2b at full width cut to 2 layers, bf16: one round with the
    taps off and one with them on from clones of one state, batch, weights
    and key. x, x-hat, m, the loss and every upload and broadcast must be
    bit-equal (taps change no bit of the round), and the seven taps equal
    to ``ref.round_taps`` over the round's materialized f32 vectors: x
    before, the clients' weighted sum remade from their uploads through
    the round's own ``steps.accumulate``, delta_bar, x_new in f32 (before
    its rounding to bf16) and the diff, with the broadcast's codes."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.common import prng
    from repro_torch.common.tree import tree_leaves
    from repro_torch.distributed import steps
    from repro_torch.examples import federated_llm as fl
    from repro_torch.launch.train import round_batch
    from repro_torch.kernels import ref

    cfg = configs.get_config(LLM_ARCH).replace(n_layers=LLM_STREAM_LAYERS)
    qcfg = fl.qafel_config(4)
    torch.cuda.empty_cache()
    base = steps.init_round_state(cfg, 2, dev)
    d = sum(t.numel() for t in tree_leaves(base.x))
    batch = round_batch(cfg, qcfg, np.random.default_rng(4), fl.LOCAL_BATCH,
                        LLM_SEQ, dev)
    weights = torch.tensor([0.9, 1.0, 0.7, 0.5], device=dev)
    runs = {}
    for taps in (False, True):
        seen = []
        round_fn = steps.make_qafel_round(
            cfg, qcfg, chunk_rows=LLM_CHUNK_ROWS, taps=taps,
            on_message=lambda kind, i, p, nm: seen.append(
                (kind, i, p.clone(), nm.clone())))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = round_fn(base.clone(), batch, weights, prng.PRNGKey(5))
        loss = float(met["loss"])
        runs[taps] = dict(state=state, met=met, seen=seen, loss=loss,
                          ms=1e3 * (time.perf_counter() - t0))
    off, on = runs[False], runs[True]
    ms = {"ms_taps_off": off["ms"], "ms_taps_on": on["ms"]}
    equal = {
        "x": bits_equal(off["state"].flat[0], on["state"].flat[0]),
        "hidden": bits_equal(off["state"].flat[1], on["state"].flat[1]),
        "momentum": bits_equal(off["state"].flat[2], on["state"].flat[2]),
        "loss": off["loss"] == on["loss"],
        "messages": len(off["seen"]) == len(on["seen"]) == 5 and all(
            a[:2] == b[:2] and bits_equal(a[2], b[2])
            and bits_equal(a[3], b[3])
            for a, b in zip(off["seen"], on["seen"]))}
    del off
    runs.pop(False)
    on["state"] = None
    torch.cuda.empty_cache()

    # the round's vectors, materialized in f32 from the state before it
    buf = torch.zeros(d, device=dev)
    for kind, i, p, nm in on["seen"][:4]:
        steps.accumulate(buf, p, nm, weights[i:i + 1], bits=BITS, d=d)
    delta = buf * np.float32(1.0 / qcfg.buffer_size)
    del buf
    x_old = base.flat[0].float()
    x_new = torch.empty(d, device=dev)
    step = 1 << 26
    for a in range(0, d, step):
        b = min(d, a + step)
        x_new[a:b] = ref.fma_f32(
            base.flat[2][a:b].float(), float(np.float32(qcfg.server_momentum)),
            delta[a:b]) + x_old[a:b]
    diff = x_new - base.flat[1].float()
    _, _, bp, bn = on["seen"][4]
    want = ref.round_taps(x_old, x_new, delta, diff, bp, bn, BITS, weights)
    got = on["met"]["taps"]
    record = {"phase": "llm_round_taps_2layer", "arch": cfg.arch_id,
              "n_layers": cfg.n_layers, "d": d, "dtype": cfg.param_dtype,
              "taps": got.cpu().tolist(), "plain_taps": want.cpu().tolist(),
              "taps_equal_plain": bits_equal(got, want),
              "taps_off_vs_on_bit_equal": equal, **ms}
    emit(record)
    del base, x_old, x_new, diff, delta, want, on
    runs.clear()
    torch.cuda.empty_cache()
    if not (all(equal.values()) and record["taps_equal_plain"]):
        raise AssertionError(f"llm_round_taps_2layer: {record}")
    return record


# serving (queue A item 14b): launch/serve.py's defaults on the trained
# gemma2-2b, then a prompt past the local layers' 4,096-slot ring
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 64, 32
SERVE_LONG_PROMPT, SERVE_LONG_STEPS, SERVE_LONG_BLOCK = 4160, 64, 520
SERVE_PHASES = ("prefill", "decode")
# decode against the full forward at the last position, bf16 at 26 layers:
# max |logit difference| (measured 0.079 at B = 4 and 0.070 at the
# 4,160-token prompt, with logits up to 7.6 and the greedy tokens equal)
SERVE_BF16_DECODE_VS_FORWARD = 0.25
# the reduced f32 config, card against CPU: the CPU tests' bound
SERVE_REDUCED_RTOL, SERVE_REDUCED_STEPS = 1e-5, 8


def _kv_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for lc in cache["layers"].values()
               for n, t in lc.items() if n in ("k", "v"))


def _decode_vs_forward(cfg, params, prompt: dict, out, block: int,
                       window=None) -> dict:
    """The served tokens through the full-sequence forward (``prompt``
    the served inputs: a VLM's patch embeddings in front, audio's
    codebooks), under the serving's ``window``: the logits at the last
    position against the last decode step's, and the greedy token(s)
    there."""
    import torch

    from repro_torch.models import transformer as T

    seq = dict(prompt, tokens=torch.cat([prompt["tokens"],
                                         out["tokens"][:, :-1]], dim=1))
    with torch.no_grad():
        h, _ = T.forward(cfg, params, seq, remat=False, q_block=block,
                         kv_block=block, window_override=window)
        want = T.logits_fn(cfg, params, h[:, -1:]).float()
    got = out["last_logits"].float()
    return {"max_abs_err": float((got - want).abs().max()),
            "row_max_abs_err": [float((g - w).abs().max())
                                for g, w in zip(got, want)],
            "max_abs_logit": float(want.abs().max()),
            "greedy_equal_share": float(
                (want[:, -1].argmax(-1) == got[:, -1].argmax(-1))
                .double().mean()),
            "finite": bool(torch.isfinite(got).all())}


def serve_gemma2(dev, cfg, params) -> dict:
    """``launch.serve.serve`` on the x of the full-depth round just run
    (gemma2-2b, 26 layers, bf16): B = 4, prompt 64, 32 greedy steps (the
    launcher's defaults), after a warm-up call. Prefill ms, each decode
    step by CUDA events, tokens/s, peak memory, the cache's k and v bytes
    against 26 * 2 * B * w * 4 * 256 * 2; a profiled call: device
    launches per decode step and the device's idle share in the decode
    loop; decode against forward at the last position."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.common.tree import tree_leaves
    from repro_torch.data.synthetic import synthetic_batch_for_config
    from repro_torch.launch.serve import serve

    batch = synthetic_batch_for_config(cfg, np.random.default_rng(0),
                                       SERVE_BATCH, SERVE_PROMPT)
    tokens = {"tokens": torch.from_numpy(batch["tokens"]).to(dev)}
    serve(cfg, params, tokens, decode_steps=2)  # warm-up
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = serve(cfg, params, tokens, decode_steps=SERVE_STEPS)
    peak = torch.cuda.max_memory_allocated()
    w = SERVE_PROMPT + SERVE_STEPS
    kv_want = cfg.n_layers * 2 * SERVE_BATCH * w * cfg.n_kv_heads * cfg.hd * 2
    kv = _kv_bytes(out["cache"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve(cfg, params, tokens, decode_steps=SERVE_STEPS)
    act = phase_activity(prof, ROOT / "build" / "serve_trace.json",
                         SERVE_PHASES)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    check = _decode_vs_forward(cfg, params, tokens, out, w)
    dec = act["decode"]
    record = {
        "phase": "serve_gemma2", "arch": cfg.arch_id,
        "n_layers": cfg.n_layers, "dtype": cfg.param_dtype,
        "weights": "x of the full-depth QAFeL round", "batch": SERVE_BATCH,
        "prompt": SERVE_PROMPT, "decode_steps": SERVE_STEPS,
        "prefill_ms": 1e3 * out["prefill_s"],
        "decode_step_ms_median": statistics.median(out["step_ms"]),
        "decode_step_ms": out["step_ms"], "decode_s": out["decode_s"],
        "tokens_per_s": SERVE_BATCH * SERVE_STEPS / out["decode_s"],
        "device_launches_per_decode_step": dec["launches"] / SERVE_STEPS,
        "decode_device_ms_per_step": dec["ms"] / SERVE_STEPS,
        "decode_idle_share": 1 - dec["ms"] / dec["wall_ms"],
        "prefill_device": act["prefill"],
        "decode_step_bound_ms": 1e3 * (weight_bytes + kv) / HBM_BYTES_PER_S,
        "bound_formula": "(weights + k and v of the cache) / 3.35 TB/s",
        "weight_bytes": weight_bytes, "kv_bytes": kv,
        "kv_bytes_reckoning": kv_want,
        "peak_gb": peak / 1e9, "peak_over_resident_gb": (peak - before) / 1e9,
        "decode_vs_forward": check,
        "decode_vs_forward_bound": SERVE_BF16_DECODE_VS_FORWARD,
        "sample_tokens": out["tokens"][0].cpu().tolist()[:16]}
    checks = {"kv_bytes_exact": kv == kv_want,
              "tokens_shape": tuple(out["tokens"].shape)
              == (SERVE_BATCH, SERVE_STEPS + 1),
              "finite": check["finite"],
              "decode_vs_forward": check["max_abs_err"]
              <= SERVE_BF16_DECODE_VS_FORWARD}
    record["checks"] = checks
    emit(record)
    if not all(checks.values()):
        raise AssertionError(f"serve_gemma2: {checks}")
    return record


def serve_gemma2_long(dev, cfg, params) -> dict:
    """The same served model, B = 1, a prompt of 4,160 (past the local
    layers' 4,096-slot ring, which wraps inside prefill) and 64 greedy
    steps: prefill ms, decode step ms, the cache's bytes (13 local layers
    at 4,096 slots, 13 global at 4,224), every layer's ``slot_pos`` equal
    to the ring law, decode against forward at the last position."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import synthetic_batch_for_config
    from repro_torch.launch.serve import serve

    batch = synthetic_batch_for_config(cfg, np.random.default_rng(1), 1,
                                       SERVE_LONG_PROMPT)
    tokens = {"tokens": torch.from_numpy(batch["tokens"]).to(dev)}
    torch.cuda.reset_peak_memory_stats()
    out = serve(cfg, params, tokens, decode_steps=SERVE_LONG_STEPS,
                q_block=SERVE_LONG_BLOCK, kv_block=SERVE_LONG_BLOCK)
    peak = torch.cuda.max_memory_allocated()
    total = SERVE_LONG_PROMPT + SERVE_LONG_STEPS
    last = total - 1
    law_ok = True
    for key, lc in out["cache"]["layers"].items():
        w = lc["slot_pos"].shape[1]
        if key.endswith("local"):
            slots = torch.arange(w)
            want = last - ((last - slots) % w)
        else:
            want = torch.arange(w)
        law_ok &= bool(torch.equal(lc["slot_pos"].cpu(),
                                   want.to(torch.int32)[None].expand(
                                       lc["slot_pos"].shape)))
    kv = _kv_bytes(out["cache"])
    check = _decode_vs_forward(cfg, params, tokens, out, total // 8)
    record = {
        "phase": "serve_gemma2_long", "batch": 1,
        "prompt": SERVE_LONG_PROMPT, "decode_steps": SERVE_LONG_STEPS,
        "attention_blocks": SERVE_LONG_BLOCK,
        "prefill_ms": 1e3 * out["prefill_s"],
        "decode_step_ms_median": statistics.median(out["step_ms"]),
        "tokens_per_s": SERVE_LONG_STEPS / out["decode_s"],
        "kv_bytes": kv, "kv_bytes_reckoning": 443_023_360,
        "slots": {k: int(v["slot_pos"].shape[1])
                  for k, v in out["cache"]["layers"].items()},
        "peak_gb": peak / 1e9, "decode_vs_forward": check,
        "decode_vs_forward_bound": SERVE_BF16_DECODE_VS_FORWARD}
    checks = {"kv_bytes_exact": kv == 443_023_360, "slot_pos_law": law_ok,
              "finite": check["finite"],
              "decode_vs_forward": check["max_abs_err"]
              <= SERVE_BF16_DECODE_VS_FORWARD}
    record["checks"] = checks
    emit(record)
    if not all(checks.values()):
        raise AssertionError(f"serve_gemma2_long: {checks}")
    return record


def serve_reduced_card_vs_cpu(dev, arch: str = LLM_ARCH) -> dict:
    """The reduced ``arch`` (f32) served on the card and the CPU from the
    same weights and prompts (B = 2, 32 positions: a VLM's 16 patch
    embeddings and 16 tokens; 8 greedy steps, without and with
    ``window_override=16``), deterministic algorithms on the card:
    the prefill's and the last step's logits within ``SERVE_REDUCED_RTOL``
    of the CPU's largest value, the tokens and every ``slot_pos`` equal."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.common.tree import tree_map
    from repro_torch.data.synthetic import synthetic_batch_for_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T

    cfg = configs.get_reduced(arch)
    params = T.init_params(cfg, 0, "cpu")
    card_params = tree_map(lambda t: t.to(dev), params)
    inputs = {k: torch.from_numpy(v) for k, v in synthetic_batch_for_config(
        cfg, np.random.default_rng(2), 2, 32).items() if k != "labels"}
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    record = {"phase": "serve_reduced_card_vs_cpu", "arch": cfg.arch_id,
              "decode_steps": SERVE_REDUCED_STEPS,
              "rtol": SERVE_REDUCED_RTOL, "cases": {}}
    ok = True
    try:
        for window in (None, 16):
            cpu = serve(cfg, params, inputs,
                        decode_steps=SERVE_REDUCED_STEPS, window=window)
            card = serve(cfg, card_params,
                         {k: v.to(dev) for k, v in inputs.items()},
                         decode_steps=SERVE_REDUCED_STEPS, window=window)
            rel = {n: float((card[n].cpu() - cpu[n]).abs().max()
                            / cpu[n].abs().max())
                   for n in ("logits", "last_logits")}
            entries = {(e, k): (lc, cpu["cache"][e][k] if e == "layers"
                                else cpu["cache"][e])
                       for e in card["cache"]
                       for k, lc in (card["cache"][e].items()
                                     if e == "layers"
                                     else (("", card["cache"][e]),))}
            slots = all(torch.equal(lc["slot_pos"].cpu(), want["slot_pos"])
                        for lc, want in entries.values()
                        if "slot_pos" in lc)
            # a mamba position's recurrent state (the f32 SSM state and
            # the conv tail), an MLA layer's latents (deepseek's prefix
            # layers too)
            for (e, k), (lc, want) in entries.items():
                for n in ("ssm", "conv", "ckv", "k_rope"):
                    if n in lc:
                        rel[f"{e}/{k}/{n}"] = float(
                            (lc[n].cpu() - want[n]).abs().max()
                            / want[n].abs().max())
            case = {"rel_err": rel, "tokens_equal": torch.equal(
                card["tokens"].cpu(), cpu["tokens"]),
                "slot_pos_equal": slots}
            ok &= (all(v <= SERVE_REDUCED_RTOL for v in rel.values())
                   and case["tokens_equal"] and slots)
            record["cases"][str(window)] = case
    finally:
        torch.use_deterministic_algorithms(det)
    record["ok"] = ok
    emit(record)
    if not ok:
        raise AssertionError(f"serve_reduced_card_vs_cpu: {record}")
    return record


# the training launcher at its defaults (``launch.train``), and the round
# under the other quantizers at full width and 2 layers
TRAIN_STEPS = 2
TRAIN_TIMED = 3  # rounds timed by CUDA events after the launcher's run
TRAIN_ARGV = ["--arch", LLM_ARCH, "--steps", str(TRAIN_STEPS), "--seq", "128",
              "--global-batch", "32", "--checkpoint-dir",
              str(ROOT / "build" / "train_ckpt")]
# the activations of the launcher's 1,024 tokens a client without remat,
# on top of the round's buffers: 26 layers x ~126 kB a token of saved
# layer activations, and the 256,000-wide logits with their softcap,
# softmax and gradient
TRAIN_ACTIVATION_BYTES = 26 * 126e3 * 1024 + 3.5e9
_PEAKS = {}  # the meshless launcher's peak above its base, read by model_mesh


def _cycle_bytes() -> int:
    """The bytes a full garbage collection frees now: tensors held only by
    reference cycles, which otherwise wait for an uncertain later
    collection."""
    import gc

    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.synchronize()
    return before - torch.cuda.memory_allocated()


def _launcher_base() -> tuple:
    """``(base, cycle_bytes)`` before a launcher's measured run: the bytes
    still allocated after a full garbage collection (``_cycle_bytes``, what
    earlier phases left in cycles), with the peak statistics reset; a
    launcher's own peak is its peak less ``base``."""
    import torch

    cycles = _cycle_bytes()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated(), cycles
QUANT_LAYERS = 2
# one round a pair, cold (2 until model_mesh took their time: the warm
# second round ran within 1% of the first)
QUANT_ROUNDS = 1
QUANT_PAIRS = (("lowrank4g32", "top_k0.1"), ("rand_k0.1", "rand_k0.1"),
               ("identity", "identity"))


def train_launcher(dev) -> dict:
    """``launch.train`` on gemma2-2b as published (26 layers, bf16) at the
    launcher's defaults (seq 128, global batch 32 so local 8, K = 4, P = 1,
    qsgd4 both ways, remat off), ``TRAIN_STEPS`` rounds with the launch
    counters set to 0 just before and read just after: losses, peak
    ``max_memory_allocated`` against the reckoning plus the activations,
    bytes per upload; then the checkpoint of x it wrote (bytes, seconds to
    write and to read) loaded back onto the card and held bit for bit
    against the trained x; then ms per round by CUDA events over
    ``TRAIN_TIMED`` more rounds of the launcher's round function on its
    trained state (each batch built before its start event, as
    ``llm_round`` times its rounds)."""
    import shutil

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.common.tree import tree_leaves
    from repro_torch.core.staleness import staleness_weight
    from repro_torch.distributed.steps import make_qafel_round
    from repro_torch.kernels import launches as kernel_launches
    from repro_torch.kernels import reset_launches
    from repro_torch.launch import train

    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    args = train.parse_args(TRAIN_ARGV)
    base, cycles_before = _launcher_base()
    reset_launches()
    t0 = time.perf_counter()
    out = train.run(args)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    cycles_after = _cycle_bytes()
    _PEAKS["train_launcher"] = peak - base
    state = out["state"]
    d = sum(t.numel() for t in tree_leaves(state.x))
    rows = -(-d // 128)
    chunks = -(-rows // train.CHUNK_ROWS)
    path = Path(out["checkpoint"]) / "state.msgpack"
    ckpt_bytes = path.stat().st_size
    # the seconds to write: the launcher's save, timed again on the trained
    # x (the same bytes), then the read back onto the card
    from repro_torch.checkpoint import save_checkpoint
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    again = save_checkpoint(str(ROOT / "build" / "train_ckpt_again"),
                            TRAIN_STEPS, {"x": state.x}, {"arch": LLM_ARCH})
    write_s = time.perf_counter() - t1
    same_file = (Path(again) / "state.msgpack").read_bytes() == \
        path.read_bytes()
    shutil.rmtree(ROOT / "build" / "train_ckpt_again", ignore_errors=True)
    t2 = time.perf_counter()
    back = load_checkpoint(str(ckpt_dir), TRAIN_STEPS, {"x": state.x})
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t2
    reload_equal = all(
        a.dtype == b.dtype and a.device == b.device and bits_equal(a, b)
        for a, b in zip(tree_leaves(back["x"]), tree_leaves(state.x)))
    del back
    k = args.buffer_k
    local = args.global_batch // (k * args.local_steps)
    cfg = configs.get_config(args.arch)
    qcfg = train.qafel_config(args)
    round_fn = make_qafel_round(cfg, qcfg, remat=False,
                                chunk_rows=train.CHUNK_ROWS)
    weights = staleness_weight(torch.zeros(k)).to(dev)
    rng = np.random.default_rng(args.seed + 1)
    ms, timed_losses = [], []
    for step in range(TRAIN_STEPS, TRAIN_STEPS + TRAIN_TIMED):
        batch = train.round_batch(cfg, qcfg, rng, local, args.seq, dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, met = round_fn(state, batch, weights,
                              train.round_key(args.seed, step))
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        timed_losses.append(float(met["loss"]))
        del batch
    want = {"qsgd_quantize_pack_threefry": TRAIN_STEPS * (k + 1) * chunks,
            "qsgd_unpack_dequantize": TRAIN_STEPS * (k + 1),
            "server_update": TRAIN_STEPS}
    reckoning = llm_peak_reckoning(d)
    prediction = reckoning + TRAIN_ACTIVATION_BYTES
    metrics = out["metrics"]
    record = {
        "phase": "train_launcher", "argv": TRAIN_ARGV, "arch": LLM_ARCH,
        "n_layers": LLM_LAYERS, "d": d, "seq": args.seq,
        "global_batch": args.global_batch, "local_batch": args.global_batch
        // (k * args.local_steps), "K": k, "P": args.local_steps,
        "remat": False, "chunk_rows": train.CHUNK_ROWS, "row_chunks": chunks,
        "losses": out["losses"].tolist(), "ms_rounds": ms,
        "ms_median": statistics.median(ms), "timed_losses": timed_losses,
        "ms_note": "rounds TRAIN_STEPS.. of the launcher's round function "
        "after its run, each batch built before the start event",
        "loop_s": out["seconds"],
        "run_s": total_s, "launches": {n: v for n, v in launches.items()
                                       if v},
        "peak_bytes": peak, "peak_gb": peak / 1e9, "base_bytes": base,
        "cycle_bytes_before": cycles_before,
        "cycle_bytes_after": cycles_after,
        "peak_reckoning_gb": reckoning / 1e9,
        "peak_predicted_gb": prediction / 1e9,
        "upload_bytes": metrics["upload_bytes"],
        "broadcast_bytes": metrics["broadcast_bytes"],
        "checkpoint": str(path.relative_to(ROOT)),
        "checkpoint_bytes": ckpt_bytes, "checkpoint_write_s": write_s,
        "checkpoint_read_s": read_s,
        "checkpoint_write_gb_per_s": ckpt_bytes / write_s / 1e9,
        "checkpoint_read_gb_per_s": ckpt_bytes / read_s / 1e9}
    checks = {
        "losses_finite": all(math.isfinite(v) for v in
                             record["losses"] + timed_losses),
        "rounds": len(out["losses"]) == TRAIN_STEPS
        and state.t == TRAIN_STEPS + TRAIN_TIMED,
        **{f"{n}_launches": launches[n] == v for n, v in want.items()},
        "other_kernels_idle": all(v == 0 for n, v in launches.items()
                                  if n not in want
                                  and n not in MODEL_KERNELS),
        "peak_under_gate": peak < LLM_PEAK_CAP_GB * 1e9,
        "upload_bytes_exact": metrics["upload_bytes"]
        == (4 * d + 32 * rows) / 8,
        "checkpoint_holds_x": ckpt_bytes > 2 * d,
        "same_bytes_written_twice": same_file,
        "reloaded_x_bit_equal": reload_equal}
    record["checks"] = checks
    emit(record)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del out, state
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"train_launcher: {checks}")
    return record


def llm_round_quantizers(dev) -> dict:
    """The round under the other quantizers on gemma2-2b at full width
    and ``QUANT_LAYERS`` layers (d = 745,558,272), bf16, the federated
    example's settings with the quantizers swapped, row chunks of 2^20:
    ``QUANT_ROUNDS`` rounds for each pair of ``QUANT_PAIRS`` from one
    state, the launch counters set to 0 just before and read just after
    (``llm_quantizers`` lines: ms of each round by CUDA events, the first
    cold, peak, metered upload and broadcast bytes,
    launches by kernel name: K1 and K3 only where qsgd codes travel);
    then the reduced config's server half under each non-qsgd server
    kind, on the card and the CPU from the same state and clients' sum,
    bit for bit with the taps (``llm_quantizers_card_vs_cpu``)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.common import prng
    from repro_torch.common.tree import tree_map
    from repro_torch.core.quantizers import make_quantizer
    from repro_torch.distributed import steps
    from repro_torch.examples import federated_llm as fl
    from repro_torch.launch.train import round_batch
    from repro_torch.kernels import launches as kernel_launches
    from repro_torch.kernels import ref, reset_launches
    from repro_torch.kernels.taps import round_taps

    cfg = configs.get_config(LLM_ARCH).replace(n_layers=QUANT_LAYERS)
    base = steps.init_round_state(cfg, 0, dev)
    d = base.flat[0].numel()
    rows = []
    for cq, sq in QUANT_PAIRS:
        qcfg = dataclasses.replace(fl.qafel_config(4), client_quantizer=cq,
                                   server_quantizer=sq)
        state = base.clone()
        round_fn = steps.make_qafel_round(cfg, qcfg, remat=False,
                                          chunk_rows=LLM_CHUNK_ROWS)
        batch = round_batch(cfg, qcfg, np.random.default_rng(0),
                            fl.LOCAL_BATCH, LLM_SEQ, dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        ms = []
        for step in range(QUANT_ROUNDS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, met = round_fn(state, batch, torch.ones(4),
                                  prng.PRNGKey(step))
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        launches = {n: v for n, v in kernel_launches().items() if v}
        peak = torch.cuda.max_memory_allocated()
        cspec, sspec = make_quantizer(cq).spec, make_quantizer(sq).spec
        qsgd_codes = cspec.kind in ("qsgd", "lowrank")
        # the loss's logsumexp: one launch each way a client step (one
        # loss chunk at seq LLM_SEQ)
        want = {"server_update": QUANT_ROUNDS,
                **{n: QUANT_ROUNDS * 4 * qcfg.local_steps
                   for n in LSE_KERNELS}}
        if qsgd_codes:
            n = d if cspec.kind == "qsgd" else cspec.rank(d)
            want["qsgd_quantize_pack_threefry"] = QUANT_ROUNDS * 4 * -(
                -(-(-n // 128)) // LLM_CHUNK_ROWS)
            want["qsgd_unpack_dequantize"] = QUANT_ROUNDS * 4
        row = {"phase": "llm_quantizers", "arch": cfg.arch_id,
               "n_layers": cfg.n_layers, "d": d, "client": cq, "server": sq,
               "ms": ms[-1], "ms_rounds": ms,
               "ms_note": "the first round is cold (first use of the round "
               "function); ms is the last",
               "loss": float(met["loss"]),
               "peak_bytes": peak, "peak_gb": peak / 1e9,
               "upload_bytes": met["upload_bytes"],
               "broadcast_bytes": met["broadcast_bytes"],
               "launches": launches}
        checks = {"loss_finite": math.isfinite(row["loss"]),
                  "launches": launches == want,
                  "state_moved": not torch.equal(state.flat[1],
                                                 base.flat[1])}
        row["checks"] = checks
        emit(row)
        rows.append(row)
        del state, batch, round_fn
        if not all(checks.values()):
            raise AssertionError(f"llm_quantizers {cq}/{sq}: {checks}")
    del base
    torch.cuda.empty_cache()

    # the reduced config's server half on the card and the CPU
    rcfg = configs.get_reduced(LLM_ARCH)
    rstate = steps.init_round_state(rcfg, 0, "cpu")
    rd = rstate.flat[0].numel()
    g = torch.Generator().manual_seed(5)
    hidden = rstate.flat[0] + 2e-3 * torch.randn(rd, generator=g)
    m = 1e-3 * torch.randn(rd, generator=g)
    buf0 = 3e-3 * torch.randn(rd, generator=g)
    w = torch.tensor([0.9, 1.0, 0.7, 0.5])
    equal = {}
    for kind in ("identity", "top_k0.1", "rand_k0.1", "lowrank4g32"):
        qcfg = dataclasses.replace(fl.qafel_config(4), server_quantizer=kind)
        outs = {}
        for where in ("cpu", dev):
            xs, hs, ms_ = (t.clone().to(where) for t in (rstate.flat[0],
                                                          hidden, m))
            buf = buf0.clone().to(where)
            parts = torch.empty((ref.ROUND_TAP_SUMS, ref.tap_windows(rd)),
                                device=where)
            msg = steps.server_half(xs, hs, ms_, buf, prng.PRNGKey(9),
                                    qcfg=qcfg, d=rd, taps=parts)
            taps = round_taps(parts, w.to(where))
            outs[str(where)] = [t.cpu() for t in (xs, hs, ms_, taps, msg[0])]
        equal[kind] = all(bits_equal(a, b) for a, b in
                          zip(outs["cpu"], outs[str(dev)]))
    record = {"phase": "llm_quantizers_card_vs_cpu", "arch": rcfg.arch_id,
              "d": rd, "server_half_bit_equal": equal}
    emit(record)
    if not all(equal.values()):
        raise AssertionError(f"llm_quantizers_card_vs_cpu: {record}")
    return {"rounds": rows, "card_vs_cpu": record}


# the rest of the attention-only pool (queue A items 14c.1, 14c.2):
# musicgen-large and internvl2-1b as published (no cut) through llm_round's
# QAFeL round and settings, each then served; the dense siblings served
POOL_ROUNDS = 1  # timed by CUDA events, after one warm-up round
# the rounds' sequence lengths and the served prompts: internvl2-1b's 256
# patch embeddings and 64 text tokens
POOL_SEQ = {"musicgen-large": LLM_SEQ, "internvl2-1b": 320,
            "mamba2-1.3b": LLM_SEQ, "zamba2-7b": LLM_SEQ,
            "qwen3-moe-235b-a22b": LLM_SEQ}
# element 2**31 starts wire row 2**24: musicgen-large's kernels are held to
# their plain versions on the plain chunk around it and on the last one
ROW_2_31 = 1 << 24
# (arch, layers kept): granite-34b's 94.5 GB of bf16 weights exceed the
# card, so it serves at full width cut to 24 of its 88 layers (26.5 GB)
SIBLINGS = (("codeqwen1.5-7b", None), ("qwen3-14b", None),
            ("granite-34b", 24))
SIBLING_WINDOW = 16  # the reference's windowed decode test's override
POOL_REDUCED = ("codeqwen1.5-7b", "qwen3-14b", "granite-34b",
                "internvl2-1b", "musicgen-large")
# decode against the full forward at the last position, bf16, relative to
# the largest logit there (gemma2-2b's 0.25 of 7.56 is 3.3%)
SERVE_POOL_DECODE_VS_FORWARD = 0.05


def pool_round(dev, arch: str, layers=None, phase=None) -> tuple:
    """``llm_round``'s QAFeL round on ``arch`` as published (``layers``:
    cut to that depth) (bf16, every
    layer, row chunks of ``LLM_CHUNK_ROWS``, remat, qsgd4 both ways, K =
    4, P = 2, local batch 2, ``POOL_SEQ[arch]`` positions): one warm-up
    round, ``POOL_ROUNDS`` rounds timed by CUDA events with the launch
    counters set to 0 just before and read just after (K1, K3 and the
    server update by name; peak memory against the reckoning), one round
    profiled on the device alone (device busy ms, device activities, the
    busiest kernels). Hidden and momentum are then
    freed and the trained x kept for serving. A mixed tree (mamba2's f32
    leaves in a bf16 model) keeps its state in place too: the record
    counts its f32 side coordinates. Returns (record, launches, d, x
    tree); ``phase`` names the record (default ``<arch's first word>_round``);
    an MoE config's record adds the share of token copies dropped at its
    capacity over the measured rounds."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.common import prng
    from repro_torch.common.tree import tree_leaves
    from repro_torch.distributed.steps import (init_round_state,
                                               make_qafel_round)
    from repro_torch.examples import federated_llm as fl
    from repro_torch.kernels import launches as kernel_launches
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.train import round_batch
    from repro_torch.models import moe

    cfg = configs.get_config(arch)
    cut = "none"
    if layers is not None:
        cut = (f"{layers} of {cfg.n_layers} layers: the full round's "
               f"reckoning exceeds {LLM_PEAK_CAP_GB:.0f} GB")
        cfg = cfg.replace(n_layers=layers)
    qcfg = fl.qafel_config(4)
    k, seq = qcfg.buffer_size, POOL_SEQ[arch]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    holder = [init_round_state(cfg, 0, dev)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    d = sum(t.numel() for t in tree_leaves(holder[0].x))
    side = sum(t.numel() for t in tree_leaves(holder[0].x)
               if t.dtype != holder[0].flat[0].dtype)
    rows = -(-d // 128)
    chunks = -(-rows // LLM_CHUNK_ROWS)
    round_fn = make_qafel_round(cfg, qcfg, chunk_rows=LLM_CHUNK_ROWS)
    weights = torch.ones(k)
    rng = np.random.default_rng(0)
    batch_shapes = {}

    def one(step: int) -> dict:
        batch = round_batch(cfg, qcfg, rng, fl.LOCAL_BATCH, seq, dev)
        batch_shapes.update({n: list(v.shape) for n, v in batch.items()})
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        new, met = round_fn(holder[0], batch, weights, prng.PRNGKey(step))
        end.record()
        holder[0] = new
        del batch
        drift = fl.model_drift(new.x, new.hidden)
        torch.cuda.synchronize()
        row = {"round": step, "loss": float(met["loss"]),
               "drift_l1": float(drift), "ms": start.elapsed_time(end),
               "upload_bytes": met["upload_bytes"],
               "broadcast_bytes": met["broadcast_bytes"]}
        emit({"phase": "pool_round_step", "arch": arch, **row})
        return row

    warm = one(0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with _routes() as routes:
        rows_out = [one(step) for step in range(1, 1 + POOL_ROUNDS)]
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled = one(1 + POOL_ROUNDS)
    by_name = kernel_table(prof)
    read_s = time.perf_counter() - t0 - profiled["ms"] / 1e3
    busiest = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    want = {"qsgd_quantize_pack_threefry": (k + 1) * chunks,
            "qsgd_unpack_dequantize": k + 1, "server_update": 1}
    per_round = lambda name: launches[name] / POOL_ROUNDS
    reckoning = llm_peak_reckoning(d)
    upload_want = (4 * d + 32 * rows) / 8
    ms = [r["ms"] for r in rows_out]
    record = {
        "phase": phase or f"{arch.split('-')[0]}_round", "arch": cfg.arch_id,
        "n_layers": cfg.n_layers, "cut": cut, "d": d,
        "side_f32_coordinates": side,
        "d_over_2_31": d / 2 ** 31, "param_count": cfg.param_count(),
        "dtype": cfg.param_dtype, "seq": seq, "batch_shapes": batch_shapes,
        "local_batch": fl.LOCAL_BATCH, "K": k, "P": qcfg.local_steps,
        "chunk_rows": LLM_CHUNK_ROWS, "row_chunks": chunks, "remat": True,
        "init_s": init_s, "warmup_round": warm, "rounds": rows_out,
        "ms_median": statistics.median(ms), "ms_rounds": ms,
        "profiled_round": {
            "ms": profiled["ms"],
            "device_busy_ms": sum(t for _, t in by_name.values()),
            "device_launches": sum(c for c, _ in by_name.values()),
            "silu_device_launches": sum(c for n, (c, _) in by_name.items()
                                        if "silu" in n.lower()),
            "busiest": [{"name": n[:90], "launches": c, "device_ms": t}
                        for n, (c, t) in busiest],
            "profile_overhead_s": read_s},
        "peak_bytes": peak, "peak_gb": peak / 1e9,
        "peak_reckoning_gb": reckoning / 1e9,
        "peak_limit_gb": min(LLM_PEAK_SLACK * reckoning / 1e9,
                             LLM_PEAK_CAP_GB),
        "launches_per_round": {n: per_round(n) for n in want},
        "silu_launches_per_round": {n: per_round(n) for n in launches
                                    if n.startswith("silu")},
        "upload_bytes": rows_out[0]["upload_bytes"]}
    if cfg.n_experts:  # each MoE call routes a client's local batch
        t = fl.LOCAL_BATCH * seq
        record["moe"] = {
            "experts": cfg.n_experts, "top_k": cfg.experts_per_token,
            "capacity_factor": cfg.capacity_factor, "tokens_per_call": t,
            "capacity": moe.capacity(cfg, t, cfg.capacity_factor),
            "calls": len(routes),
            "drop_share": _drop_share(cfg, routes, cfg.capacity_factor)}
    checks = {
        "losses_finite": all(math.isfinite(r["loss"])
                             for r in rows_out + [warm, profiled]),
        "drift_positive": all(r["drift_l1"] > 0 for r in rows_out),
        **{f"{n}_per_round": per_round(n) == v for n, v in want.items()},
        "other_kernels_idle": all(v == 0 for n, v in launches.items()
                                  if n not in want
                                  and n not in MODEL_KERNELS),
        "peak_under_reckoning": peak <= LLM_PEAK_SLACK * reckoning
        and peak < LLM_PEAK_CAP_GB * 1e9,
        "upload_bytes_exact": all(r["upload_bytes"] == upload_want
                                  for r in rows_out),
        "state_in_place": holder[0].flat is not None}
    record["checks"] = checks
    emit(record)
    if not all(checks.values()):
        raise AssertionError(f"{record['phase']}: {checks}")
    x_tree = holder.pop().x
    del round_fn
    torch.cuda.empty_cache()
    return record, launches, d, x_tree


def serve_pool(dev, phase: str, cfg, params, prompt: int, steps: int,
               window=None, **note) -> dict:
    """``launch.serve.serve`` on ``params`` (bf16): B = ``SERVE_BATCH``,
    ``prompt`` positions from the reference's numpy stream (a VLM's
    patch embeddings among them), ``steps`` greedy steps under
    ``window``, after a warm-up call: prefill ms, each decode step by CUDA
    events, tokens/s, peak memory, the cache's k and v bytes against
    layers * 2 * B * slots * KV heads * head_dim * 2, every ``slot_pos``
    on the ring law, decode against forward at the last position
    (``SERVE_POOL_DECODE_VS_FORWARD`` of the largest logit)."""
    import numpy as np
    import torch

    from repro_torch.common.tree import tree_leaves
    from repro_torch.data.synthetic import synthetic_batch_for_config
    from repro_torch.launch.serve import serve

    batch = synthetic_batch_for_config(cfg, np.random.default_rng(0),
                                       SERVE_BATCH, prompt)
    inputs = {n: torch.from_numpy(v).to(dev) for n, v in batch.items()
              if n != "labels"}
    serve(cfg, params, inputs, decode_steps=min(2, steps), window=window)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = serve(cfg, params, inputs, decode_steps=steps, window=window)
    peak = torch.cuda.max_memory_allocated()
    total = prompt + steps
    w = total if window is None else min(window, total)
    kv_want = cfg.n_layers * 2 * SERVE_BATCH * w * cfg.n_kv_heads * cfg.hd * 2
    kv = _kv_bytes(out["cache"])
    last = total - 1  # the last decode step's position
    slots = torch.arange(w, device=dev)
    law = (last - ((last - slots) % w) if window is not None
           else slots).to(torch.int32)
    law_ok = all(bool((lc["slot_pos"] == law).all())
                 for lc in out["cache"]["layers"].values())
    check = _decode_vs_forward(cfg, params, inputs, out, total, window)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    audio = cfg.modality == "audio"
    record = {
        "phase": phase, "arch": cfg.arch_id, "n_layers": cfg.n_layers,
        "dtype": cfg.param_dtype, **note, "batch": SERVE_BATCH,
        "prompt": prompt, "inputs": {n: list(v.shape)
                                     for n, v in inputs.items()},
        "decode_steps": steps, "window": window,
        "prefill_ms": 1e3 * out["prefill_s"],
        "decode_step_ms_median": statistics.median(out["step_ms"]),
        "decode_step_ms": out["step_ms"], "decode_s": out["decode_s"],
        "tokens_per_s": SERVE_BATCH * steps / out["decode_s"],
        "decode_step_bound_ms": 1e3 * (weight_bytes + kv) / HBM_BYTES_PER_S,
        "bound_formula": "(weights + k and v of the cache) / 3.35 TB/s",
        "weight_bytes": weight_bytes, "kv_bytes": kv,
        "kv_bytes_reckoning": kv_want, "peak_gb": peak / 1e9,
        "decode_vs_forward": check,
        "decode_vs_forward_bound": SERVE_POOL_DECODE_VS_FORWARD
        * check["max_abs_logit"],
        "sample_tokens": out["tokens"][0].cpu().tolist()[:8]}
    checks = {"kv_bytes_exact": kv == kv_want, "slot_pos_law": law_ok,
              "tokens_shape": tuple(out["tokens"].shape)
              == (SERVE_BATCH, steps + 1) + ((cfg.audio_codebooks,)
                                             if audio else ()),
              "finite": check["finite"],
              "decode_vs_forward": check["max_abs_err"]
              <= record["decode_vs_forward_bound"]}
    record["checks"] = checks
    emit(record)
    if not all(checks.values()):
        raise AssertionError(f"{phase} {cfg.arch_id}: {checks}")
    return record


def serve_dense_siblings(dev) -> list:
    """codeqwen1.5-7b and qwen3-14b at full size and granite-34b at full
    width cut to 24 of its 88 layers, each with random bf16 weights from
    seed 0, served at the reference launcher's load (``serve_pool``: B =
    4, prompt 64, 32 greedy steps); granite's cut also one step with
    ``window_override = 16`` (a 16-slot ring in every layer). Each model
    is freed before the next is made."""
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as T

    out = []
    for arch, layers in SIBLINGS:
        cfg = configs.get_config(arch)
        note = {"cut": "none"}
        if layers is not None:
            note = {"cut": f"{layers} of {cfg.n_layers} layers: the "
                    f"{cfg.param_count() * 2 / 1e9:.1f} GB of bf16 weights "
                    "exceed the card"}
            cfg = cfg.replace(n_layers=layers)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = T.init_params(cfg, 0, dev)
        torch.cuda.synchronize()
        note["init_s"] = time.perf_counter() - t0
        out.append(serve_pool(dev, "serve_dense_siblings", cfg, params,
                              SERVE_PROMPT, SERVE_STEPS, **note))
        if layers is not None:
            out.append(serve_pool(dev, "serve_dense_siblings", cfg, params,
                                  SERVE_PROMPT, 1, window=SIBLING_WINDOW,
                                  **note))
        del params
    torch.cuda.empty_cache()
    return out


def run_pool(dev, dither_int32: dict, int32_ops_per_s: float) -> tuple:
    """The rest of the attention-only pool: musicgen-large's round, its
    serving and K1, K3 and the server update at its d past 2**31 (against
    their plain versions on the chunk across element 2**31 and the last
    one); internvl2-1b's round and its serving; the dense siblings
    served; the five reduced configs card vs CPU (one round, its server
    half, and serving).
    Returns ({path: launches by kernel}, the kernel cases at musicgen's
    d)."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ref

    paths = {}
    for arch in ("musicgen-large", "internvl2-1b"):
        _, paths[f"{arch.split('-')[0]}_round"], d, x_tree = pool_round(
            dev, arch)
        serve_pool(dev, f"serve_{arch.split('-')[0]}",
                   configs.get_config(arch), x_tree, POOL_SEQ[arch],
                   SERVE_STEPS, weights="x of the full-depth QAFeL round")
        del x_tree
        torch.cuda.empty_cache()
        if arch == "musicgen-large":
            rows = ref.rows_for(d)
            half = LLM_PLAIN_CHUNK_ROWS // 2
            cases = llm_kernels(
                dev, d, dither_int32, int32_ops_per_s, suffix="musicgen",
                check=[(ROW_2_31 - half, ROW_2_31 + half),
                       (rows - LLM_PLAIN_CHUNK_ROWS, rows)], taps=False)
    serve_dense_siblings(dev)
    for arch in POOL_REDUCED:
        llm_reduced_card_vs_cpu(dev, arch, rounds=1)
        serve_reduced_card_vs_cpu(dev, arch)
    return paths, cases


# Mamba2 and the hybrid (queue A item 14c.3): mamba2-1.3b's round as
# published, zamba2-7b's cut to the largest whole number of super-blocks
# whose reckoning stays under ~56 GB (20 of 27: d = 3,554,030,208, 55.79
# GB; the full 81 layers reckon 71.66 GB), each served
ZAMBA_LAYERS = 60
MAMBA_LONG_PROMPT, MAMBA_LONG_STEPS = 4160, 32  # 16 chunks of 256 + 64
# decode against the full forward at the last position, bf16, relative to
# the largest logit: decode's one-step recurrence and prefill's chunked
# scan round the bf16 activations at other points in each of 48 layers
# (measured 3.8-5.2% for mamba2-1.3b, 2.9% for zamba2-7b at 81 layers;
# the attention-only pool's 5% was set at 1.4-2.1%)
SERVE_RECURRENT_DECODE_VS_FORWARD = 0.08


def _recurrent_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for lc in cache["layers"].values()
               for n, t in lc.items() if n in ("ssm", "conv"))


def recurrent_cache_count(cfg, batch: int) -> int:
    """The mamba positions' cache bytes by count: per layer and sequence
    an f32 (H, P, N) state and the (W - 1, C) conv tail in the activation
    dtype; no term in the prompt's length."""
    conv = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    per = (cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 4
           + (cfg.ssm_conv - 1) * conv * 2)
    mamba = cfg.n_super_blocks * sum(k == "mamba" for k in cfg.layer_pattern)
    return mamba * batch * per


def serve_recurrent(dev, phase: str, cfg, params, batch: int, prompt: int,
                    steps: int, seed: int = 0, **note) -> dict:
    """``launch.serve.serve`` of a Mamba2 or hybrid model (bf16) after a
    warm-up call: prefill ms, each decode step by CUDA events, tokens/s,
    peak memory; the recurrent cache's bytes against their count
    (``recurrent_cache_count``: no term in the prompt) and the shared
    block's k and v against layers * 2 * B * slots * heads * head_dim * 2;
    a profiled call of 4 steps: device launches and device ms per decode
    step; decode against forward at the last position
    (``SERVE_RECURRENT_DECODE_VS_FORWARD`` of the largest logit)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.common.tree import tree_leaves
    from repro_torch.data.synthetic import synthetic_batch_for_config
    from repro_torch.launch.serve import serve

    raw = synthetic_batch_for_config(cfg, np.random.default_rng(seed),
                                     batch, prompt)
    tokens = {"tokens": torch.from_numpy(raw["tokens"]).to(dev)}
    serve(cfg, params, tokens, decode_steps=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = serve(cfg, params, tokens, decode_steps=steps)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve(cfg, params, tokens, decode_steps=4)
    act = phase_activity(prof, ROOT / "build" / f"{phase}_trace.json",
                         SERVE_PHASES)
    total = prompt + steps
    rec_bytes = _recurrent_bytes(out["cache"])
    rec_want = recurrent_cache_count(cfg, batch)
    attn = cfg.n_super_blocks * sum(k != "mamba" for k in cfg.layer_pattern)
    kv = _kv_bytes(out["cache"])
    kv_want = attn * 2 * batch * total * cfg.n_kv_heads * cfg.hd * 2
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    check = _decode_vs_forward(cfg, params, tokens, out, total)
    dec = act["decode"]
    record = {
        "phase": phase, "arch": cfg.arch_id, "n_layers": cfg.n_layers,
        "dtype": cfg.param_dtype, **note, "batch": batch, "prompt": prompt,
        "ssm_chunks": -(-prompt // cfg.ssm_chunk),
        "padded_tail": prompt % cfg.ssm_chunk != 0 and prompt > cfg.ssm_chunk,
        "decode_steps": steps, "prefill_ms": 1e3 * out["prefill_s"],
        "decode_step_ms_median": statistics.median(out["step_ms"]),
        "decode_step_ms": out["step_ms"], "decode_s": out["decode_s"],
        "tokens_per_s": batch * steps / out["decode_s"],
        "device_launches_per_decode_step": dec["launches"] / 4,
        "decode_device_ms_per_step": dec["ms"] / 4,
        "decode_idle_share": 1 - dec["ms"] / dec["wall_ms"],
        "decode_step_bound_ms": 1e3 * (weight_bytes + kv + rec_bytes)
        / HBM_BYTES_PER_S,
        "bound_formula": "(weights + the caches) / 3.35 TB/s",
        "weight_bytes": weight_bytes, "recurrent_cache_bytes": rec_bytes,
        "recurrent_cache_count": rec_want, "kv_bytes": kv,
        "kv_bytes_reckoning": kv_want, "peak_gb": peak / 1e9,
        "decode_vs_forward": check,
        "decode_vs_forward_bound": SERVE_RECURRENT_DECODE_VS_FORWARD
        * check["max_abs_logit"],
        "sample_tokens": out["tokens"][0].cpu().tolist()[:8]}
    checks = {"recurrent_bytes_exact": rec_bytes == rec_want,
              "kv_bytes_exact": kv == kv_want,
              "tokens_shape": tuple(out["tokens"].shape)
              == (batch, steps + 1),
              "finite": check["finite"],
              "decode_vs_forward": check["max_abs_err"]
              <= record["decode_vs_forward_bound"]}
    record["checks"] = checks
    emit(record)
    if not all(checks.values()):
        raise AssertionError(f"{phase} {cfg.arch_id}: {checks}")
    return record


def run_mamba(dev, dither_int32: dict, int32_ops_per_s: float) -> tuple:
    """Mamba2 and the hybrid: mamba2-1.3b's round at 48 layers and its x
    served (B = 4 at prompt 64, B = 1 at 4,160), K1, K3 and the server
    update at its d against their plain versions on the first and the
    last plain chunk; zamba2-7b's round at ``ZAMBA_LAYERS`` layers and
    the three kernels at its d on the chunk across element 2^31 and on
    the last one; zamba2-7b served at its 81 layers from fresh weights;
    both reduced configs card against CPU (a round, the server half in f32
    and on the mixed tree, serving). Returns ({path: launches by kernel},
    the kernel cases at mamba2's and zamba2's d)."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ref
    from repro_torch.models import transformer as T

    paths = {}
    cfg = configs.get_config("mamba2-1.3b")
    _, paths["mamba2_round"], dm, x_tree = timed(
        "mamba2_round", pool_round, dev, "mamba2-1.3b")
    note = {"weights": "x of the full-depth QAFeL round"}
    short = timed("serve_mamba2", serve_recurrent, dev, "serve_mamba2", cfg,
                  x_tree, SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS, **note)
    long = timed("serve_mamba2_long", serve_recurrent, dev,
                 "serve_mamba2_long", cfg, x_tree, 1, MAMBA_LONG_PROMPT,
                 MAMBA_LONG_STEPS, seed=1, **note)
    per_row = (short["recurrent_cache_bytes"] / SERVE_BATCH,
               long["recurrent_cache_bytes"])
    emit({"phase": "serve_mamba2_cache", "bytes_per_sequence": per_row,
          "prompts": [SERVE_PROMPT, MAMBA_LONG_PROMPT],
          "constant_in_prompt": per_row[0] == per_row[1]})
    if per_row[0] != per_row[1]:
        raise AssertionError(f"serve_mamba2: cache bytes {per_row}")
    del x_tree
    torch.cuda.empty_cache()
    rows = ref.rows_for(dm)
    cases = timed("mamba2_kernels", llm_kernels, dev, dm, dither_int32,
                  int32_ops_per_s, suffix="mamba2",
                  check=[(0, LLM_PLAIN_CHUNK_ROWS),
                         (rows - LLM_PLAIN_CHUNK_ROWS, rows)], taps=False)
    torch.cuda.empty_cache()
    _, paths["zamba2_round"], d, x_tree = timed(
        "zamba2_round", pool_round, dev, "zamba2-7b", ZAMBA_LAYERS)
    del x_tree
    torch.cuda.empty_cache()
    rows = ref.rows_for(d)
    half = LLM_PLAIN_CHUNK_ROWS // 2
    cases.update(timed("zamba2_kernels", llm_kernels, dev, d, dither_int32,
                       int32_ops_per_s, suffix="zamba2",
                       check=[(ROW_2_31 - half, ROW_2_31 + half),
                              (rows - LLM_PLAIN_CHUNK_ROWS, rows)],
                       taps=False))
    torch.cuda.empty_cache()
    zcfg = configs.get_config("zamba2-7b")
    t0 = time.perf_counter()
    params = T.init_params(zcfg, 0, dev)
    torch.cuda.synchronize()
    timed("serve_zamba2", serve_recurrent, dev, "serve_zamba2", zcfg,
          params, SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS, cut="none",
          init_s=time.perf_counter() - t0, weights="fresh, seed 0")
    del params
    torch.cuda.empty_cache()
    for arch in ("mamba2-1.3b", "zamba2-7b"):
        timed(f"reduced_{arch}", llm_reduced_card_vs_cpu, dev, arch,
              rounds=1)
        timed(f"serve_reduced_{arch}", serve_reduced_card_vs_cpu, dev, arch)
    return paths, cases


# MoE and MLA (queue A item 14c.4): qwen3-moe-235b-a22b's round at full
# width cut to 1 of its 94 layers (2 layers reckon 94.54 GB, the whole
# model 3.4 TB), its x served; deepseek-v3-671b served at full width from
# fresh weights with n_layers = 1: its 3 dense-FFN prefix layers and 1
# routed layer (31.39 GB of bf16 weights; its round reckons 232 GB even so)
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 1
MLA_ARCH, MLA_LAYERS = "deepseek-v3-671b", 1
MLA_LONG_STEPS = 32


def _block_for(n: int, most: int = 600) -> int:
    """The largest divisor of n not above ``most``: the attention blocks
    of a forward over n positions."""
    return max(b for b in range(1, min(n, most) + 1) if n % b == 0)


def _cache_entries(cache) -> list:
    """Every layer cache of a serving cache: the stack's positions and
    deepseek's ``"prefix"``."""
    return list(cache["layers"].values()) + (
        [cache["prefix"]] if "prefix" in cache else [])


def _drop_share(cfg, routes: list, capacity_factor: float) -> float:
    """The share of routed token copies that the capacity at
    ``capacity_factor`` drops, over recorded routings (``_routes``)."""
    import torch

    from repro_torch.models import moe

    kept = routed = 0
    for ids, _ in routes:
        cap = moe.capacity(cfg, ids.shape[0], capacity_factor)
        disp = moe.dispatch(torch.sort(ids, dim=-1).values, cfg.n_experts,
                            cap)
        kept += int(disp["keep"].sum())
        routed += ids.numel()
    return 1.0 - kept / routed if routed else 0.0


@contextlib.contextmanager
def _routes():
    """Inside it, every MoE call's routing (``moe._route``: the (T, k)
    expert ids and the (T, E) probs) is appended to the yielded list."""
    from repro_torch.models import moe

    log, route = [], moe._route

    def recorded(cfg, router_w, x2d):
        out = route(cfg, router_w, x2d)
        log.append((out[1], out[2].detach()))
        return out

    moe._route = recorded
    try:
        yield log
    finally:
        moe._route = route


def _moe_decode_vs_forward(cfg, params, tokens: dict, out, block: int,
                           decode_routes: list, bound: float) -> dict:
    """``_decode_vs_forward`` of an MoE model, row by row with the routing
    of the last decode step (``decode_routes``, one (ids, probs) per MoE
    layer) against the forward's at the last position: a row routed alike
    in every MoE layer holds its logits within ``bound`` of the forward's;
    a row that bf16 rounding routes elsewhere (an expert near the top-k
    boundary: the forward's k-th and (k+1)-th probability closer than
    twice the largest probability difference between the two paths) is
    counted and its error reported; any other routing difference fails."""
    import torch

    n = len(decode_routes)
    k = cfg.experts_per_token
    with _routes() as fw:
        check = _decode_vs_forward(cfg, params, tokens, out, block)
    b = tokens["tokens"].shape[0]
    rows = []
    for r in range(b):
        row = {"max_abs_err": check["row_max_abs_err"][r], "layers": []}
        for (d_ids, d_p), (f_ids, f_p) in zip(decode_routes, fw[-n:]):
            f_ids, f_p = (t.reshape(b, -1, t.shape[-1])[r, -1]
                          for t in (f_ids, f_p))
            top = torch.sort(f_p, descending=True).values
            diff = float((d_p[r] - f_p).abs().max())
            row["layers"].append({
                "alike": bool(torch.equal(torch.sort(d_ids[r]).values,
                                          torch.sort(f_ids).values)),
                "margin": float(top[k - 1] - top[k]), "probs_diff": diff})
        row["alike"] = all(lay["alike"] for lay in row["layers"])
        row["ok"] = (row["max_abs_err"] <= bound if row["alike"] else all(
            lay["alike"] or lay["margin"] <= 2 * lay["probs_diff"]
            for lay in row["layers"]))
        rows.append(row)
    check["rows"] = rows
    check["rows_routed_alike"] = sum(r["alike"] for r in rows)
    check["alike_max_abs_err"] = max(
        [r["max_abs_err"] for r in rows if r["alike"]], default=None)
    check["ok"] = all(r["ok"] for r in rows)
    return check


def serve_moe(dev, phase: str, cfg, params, batch: int, prompt: int,
              steps: int, block=None, seed: int = 0, **note) -> dict:
    """``launch.serve.serve`` of an MoE model (bf16) after a warm-up call,
    at its published capacity factors (training 1.25, decode 2.0: at B = 4
    one slot an expert, so a token copy drops where two tokens pick one
    expert, the reference's own semantics): prefill ms, each decode step
    by CUDA events, tokens/s, peak memory, the share of token copies
    dropped in the decode steps (``_drop_share``); a profiled call of
    4 steps: device launches and device ms a decode step, the idle share;
    the cache's bytes against their count (MLA: (kv_lora_rank + rope) * 2
    B a token and layer, the prefix layers included; else k and v) and
    every ``slot_pos`` on its law; then the same served on the no-drop
    ``replace`` (both factors ``n_experts / experts_per_token``) and its
    decode against the forward at the last position, row by row
    (``_moe_decode_vs_forward``, ``SERVE_POOL_DECODE_VS_FORWARD`` of the
    largest logit)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.common.tree import tree_leaves
    from repro_torch.data.synthetic import synthetic_batch_for_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import moe

    raw = synthetic_batch_for_config(cfg, np.random.default_rng(seed),
                                     batch, prompt)
    tokens = {"tokens": torch.from_numpy(raw["tokens"]).to(dev)}
    blk = {"q_block": block or 512, "kv_block": block or 512}
    serve(cfg, params, tokens, decode_steps=2, **blk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _routes() as routes:
        out = serve(cfg, params, tokens, decode_steps=steps, **blk)
    peak = torch.cuda.max_memory_allocated()
    k, e = cfg.experts_per_token, cfg.n_experts
    decode = [r for r in routes if r[0].shape[0] == batch]
    prefill = [r for r in routes if r[0].shape[0] == batch * prompt]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve(cfg, params, tokens, decode_steps=4, **blk)
    act = phase_activity(prof, ROOT / "build" / f"{phase}_trace.json",
                         SERVE_PHASES)
    total = prompt + steps
    layers = cfg.n_layers + cfg.n_dense_layers
    names = ("ckv", "k_rope") if cfg.use_mla else ("k", "v")
    per_token = ((cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2
                 if cfg.use_mla else 2 * cfg.n_kv_heads * cfg.hd * 2)
    cache_bytes = sum(t.numel() * t.element_size()
                      for lc in _cache_entries(out["cache"])
                      for n, t in lc.items() if n in names)
    cache_want = layers * batch * total * per_token
    slots = torch.arange(total, dtype=torch.int32, device=dev)
    law_ok = all(bool((lc["slot_pos"] == slots).all())
                 for lc in _cache_entries(out["cache"]))
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    expert_bytes = 3 * cfg.d_model * cfg.d_ff_expert * 2
    read_bytes = weight_bytes - cfg.n_layers * max(
        0, e - batch * k) * expert_bytes
    nd = cfg.replace(capacity_factor=e / k, decode_capacity_factor=e / k)
    with _routes() as nd_routes:
        nd_out = serve(nd, params, tokens, decode_steps=steps, **blk)
    nd_drops = _drop_share(nd, nd_routes, e / k)
    bound = SERVE_POOL_DECODE_VS_FORWARD * float(
        nd_out["last_logits"].float().abs().max())
    check = _moe_decode_vs_forward(nd, params, tokens, nd_out,
                                   _block_for(total),
                                   nd_routes[-cfg.n_layers:], bound)
    dec = act["decode"]
    record = {
        "phase": phase, "arch": cfg.arch_id, "n_layers": cfg.n_layers,
        "prefix_layers": cfg.n_dense_layers, "dtype": cfg.param_dtype,
        **note, "batch": batch, "prompt": prompt, "decode_steps": steps,
        "attention_blocks": blk["q_block"],
        "prefill_ms": 1e3 * out["prefill_s"],
        "decode_step_ms_median": statistics.median(out["step_ms"]),
        "decode_step_ms": out["step_ms"], "decode_s": out["decode_s"],
        "tokens_per_s": batch * steps / out["decode_s"],
        "device_launches_per_decode_step": dec["launches"] / 4,
        "decode_device_ms_per_step": dec["ms"] / 4,
        "decode_idle_share": 1 - dec["ms"] / dec["wall_ms"],
        "decode_capacity": moe.capacity(cfg, batch,
                                        cfg.decode_capacity_factor),
        "decode_drop_share": _drop_share(cfg, decode,
                                         cfg.decode_capacity_factor),
        "prefill_capacity": moe.capacity(cfg, batch * prompt,
                                         cfg.capacity_factor),
        "prefill_drop_share": _drop_share(cfg, prefill,
                                          cfg.capacity_factor),
        "decode_step_bound_ms": 1e3 * (read_bytes + cache_bytes)
        / HBM_BYTES_PER_S,
        "bound_formula": "(the weights less the experts no token of the "
                         "step routes to + the cache) / 3.35 TB/s",
        "weight_bytes": weight_bytes, "cache_names": names,
        "cache_bytes": cache_bytes, "cache_bytes_count": cache_want,
        "cache_bytes_per_token_layer": per_token,
        "expanded_kv_bytes_per_token_layer": (
            cfg.n_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                           + cfg.v_head_dim) * 2 if cfg.use_mla else None),
        "peak_gb": peak / 1e9,
        "no_drop": {"capacity_factor": e / k,
                    "drop_share": nd_drops,
                    "decode_step_ms_median": statistics.median(
                        nd_out["step_ms"]),
                    "prefill_ms": 1e3 * nd_out["prefill_s"]},
        "decode_vs_forward": check,
        "decode_vs_forward_note": "on the no-drop replace (at the "
                                  "published decode factor the decode "
                                  "drops copies that the forward keeps), "
                                  "row by row: a row whose last token "
                                  "bf16 routes to another expert near the "
                                  "top-k boundary is reported, not held",
        "decode_vs_forward_bound": bound,
        "sample_tokens": out["tokens"][0].cpu().tolist()[:8]}
    checks = {"cache_bytes_exact": cache_bytes == cache_want,
              "slot_pos_law": law_ok,
              "tokens_shape": tuple(out["tokens"].shape)
              == (batch, steps + 1),
              "finite": check["finite"] and bool(
                  torch.isfinite(out["last_logits"]).all()),
              "no_drop_drops_nothing": nd_drops == 0.0,
              "decode_vs_forward": check["ok"]}
    record["checks"] = checks
    emit(record)
    if not all(checks.values()):
        raise AssertionError(f"{phase} {cfg.arch_id}: {checks}")
    return record


def moe_layer_split(dev, name: str, cfg, params, tokens: int,
                    capacity_factor: float, grad: bool,
                    reps: int = 5) -> dict:
    """Where one MoE layer's time goes at one shape: ``moe_forward`` on
    (1, ``tokens``, D) bf16 inputs (with ``grad`` and its backward to the
    input and every weight, as local SGD takes it) by CUDA events, median
    of ``reps``, against the expert FFN alone on its (E, capacity, D)
    buffer (``moe._expert_ffn``: the three batched products over every
    expert) and the shared expert's MLP; the rest (router, top-k,
    dispatch, gathers, combine, aux) by difference; device launches of one
    call; the byte bounds of reading every expert's weights and the routed
    experts' alone."""
    import torch

    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.models import moe
    from repro_torch.models.layers import gated_mlp

    gen = torch.Generator(device=dev).manual_seed(3)
    p = tree_map(lambda t: t.detach().requires_grad_(grad), params)
    x = torch.randn((1, tokens, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16).requires_grad_(grad)
    cap = moe.capacity(cfg, tokens, capacity_factor)
    xe = torch.randn((cfg.n_experts, cap, cfg.d_model), generator=gen,
                     device=dev, dtype=torch.bfloat16).requires_grad_(grad)
    experts = [p[n] for n in ("w_gate", "w_up", "w_down")]
    parts = {"moe_forward": (lambda: moe.moe_forward(
        cfg, p, x, capacity_factor=capacity_factor)[0],
        [x] + tree_leaves(p)),
        "expert_ffn": (lambda: moe._expert_ffn(p, xe, 0, cfg.n_experts),
                       [xe] + experts)}
    if cfg.n_shared_experts:
        parts["shared_mlp"] = (lambda: gated_mlp(p["shared"], x, cfg.mlp_act),
                               [x] + tree_leaves(p["shared"]))

    def call(fn, inputs):
        with torch.set_grad_enabled(grad):
            out = fn()
            if grad:
                torch.autograd.grad(out.float().sum(), inputs,
                                    allow_unused=True)

    ms = {}
    for part, (fn, inputs) in parts.items():
        call(fn, inputs)
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call(fn, inputs)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms[part] = statistics.median(times)
    launches = _profiled_launches(lambda: call(*parts["moe_forward"]))
    expert = 3 * cfg.d_model * cfg.d_ff_expert * 2
    routed = min(cfg.n_experts, tokens * cfg.experts_per_token)
    record = {"phase": "moe_layer", "name": name, "arch": cfg.arch_id,
              "tokens": tokens, "capacity_factor": capacity_factor,
              "capacity": cap, "backward": grad, "ms": ms,
              "rest_ms": ms["moe_forward"] - ms["expert_ffn"]
              - ms.get("shared_mlp", 0.0),
              "device_launches": launches,
              "expert_bytes_bound_ms": 1e3 * cfg.n_experts * expert
              / HBM_BYTES_PER_S,
              "routed_expert_bytes_bound_ms": 1e3 * routed * expert
              / HBM_BYTES_PER_S,
              "note": "rest = router, top-k, dispatch, gathers, combine, "
                      "aux (moe_forward - expert FFN - shared MLP)"}
    emit(record)
    return record


def run_moe(dev, dither_int32: dict, int32_ops_per_s: float) -> tuple:
    """MoE and MLA: qwen3-moe-235b-a22b's round at full width and
    ``MOE_LAYERS`` layer (d past 2^31), its x served, K1, K3 and the
    server update at its d against their plain versions on the chunk
    across element 2^31 and on the last one; deepseek-v3-671b at full
    width with ``MLA_LAYERS`` routed layer and its 3 prefix layers,
    served at B = 4 (prompt 64) and B = 1 (prompt 4,160); both reduced
    configs card against CPU (a round with MLA, the prefix and the MTP
    term for deepseek, the server half, the routing, serving). Returns
    ({path: launches by kernel}, the kernel cases at qwen3-moe's d)."""
    import torch

    from repro_torch import configs
    from repro_torch.common.tree import tree_map
    from repro_torch.kernels import ref
    from repro_torch.models import transformer as T

    paths = {}
    cfg = configs.get_config(MOE_ARCH)
    note = {"cut": f"{MOE_LAYERS} of {cfg.n_layers} layers (the round at 2 "
            "reckons 94.54 GB)"}
    _, paths["qwen3_moe_round"], d, x_tree = timed(
        "qwen3_moe_round", pool_round, dev, MOE_ARCH, MOE_LAYERS,
        phase="qwen3_moe_round")
    layer = tree_map(lambda t: t[0], x_tree["layers"]["pos0_attn"]["moe"])
    moe_layer_split(dev, "qwen3_moe_round_client", cfg, layer,
                    2 * POOL_SEQ[MOE_ARCH], cfg.capacity_factor, grad=True)
    moe_layer_split(dev, "qwen3_moe_decode", cfg, layer, SERVE_BATCH,
                    cfg.decode_capacity_factor, grad=False)
    del layer
    timed("serve_qwen3_moe", serve_moe, dev, "serve_qwen3_moe",
          cfg.replace(n_layers=MOE_LAYERS), x_tree, SERVE_BATCH,
          SERVE_PROMPT, SERVE_STEPS, weights="x of the QAFeL round", **note)
    del x_tree
    torch.cuda.empty_cache()
    rows = ref.rows_for(d)
    half = LLM_PLAIN_CHUNK_ROWS // 2
    cases = timed("qwen3_moe_kernels", llm_kernels, dev, d, dither_int32,
                  int32_ops_per_s, suffix="qwen3moe",
                  check=[(ROW_2_31 - half, ROW_2_31 + half),
                         (rows - LLM_PLAIN_CHUNK_ROWS, rows)], taps=False)
    torch.cuda.empty_cache()
    dcfg = configs.get_config(MLA_ARCH).replace(n_layers=MLA_LAYERS)
    t0 = time.perf_counter()
    params = T.init_params(dcfg, 0, dev)
    torch.cuda.synchronize()
    note = {"cut": f"{MLA_LAYERS} routed layer of 61 and the 3 dense "
            "prefix layers", "init_s": time.perf_counter() - t0,
            "weights": "fresh, seed 0"}
    timed("serve_deepseek", serve_moe, dev, "serve_deepseek", dcfg, params,
          SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS, **note)
    timed("serve_deepseek_long", serve_moe, dev, "serve_deepseek_long",
          dcfg, params, 1, SERVE_LONG_PROMPT, MLA_LONG_STEPS,
          block=SERVE_LONG_BLOCK, seed=1, **note)
    layer = tree_map(lambda t: t[0], params["layers"]["pos0_attn"]["moe"])
    moe_layer_split(dev, "deepseek_decode", dcfg, layer, SERVE_BATCH,
                    dcfg.decode_capacity_factor, grad=False)
    del layer
    del params
    torch.cuda.empty_cache()
    for arch in (MOE_ARCH, MLA_ARCH):
        timed(f"reduced_{arch}", llm_reduced_card_vs_cpu, dev, arch,
              rounds=1)
        timed(f"serve_reduced_{arch}", serve_reduced_card_vs_cpu, dev, arch)
    return paths, cases


def run_llm(dev, dither_int32: dict, int32_ops_per_s: float) -> tuple:
    """The LLM round phase, serving the model it trained, then the
    kernels at its d, the training launcher, the round under the other
    quantizers, the rest of the attention-only pool (``run_pool``),
    Mamba2 and the hybrid (``run_mamba``) and MoE and MLA (``run_moe``);
    returns (round record, its launches, the kernel cases at gemma2-2b's,
    musicgen-large's, mamba2-1.3b's, zamba2-7b's and qwen3-moe's d, the
    launches by kernel of the launcher, the quantizer rounds and the
    musicgen-large, internvl2-1b, mamba2-1.3b, zamba2-7b and
    qwen3-moe-235b-a22b rounds)."""
    from repro_torch import configs

    record, launches, d, x_tree, _ = timed("llm_round", llm_round, dev)
    cfg = configs.get_config(LLM_ARCH)
    timed("serve_gemma2", serve_gemma2, dev, cfg, x_tree)
    timed("serve_gemma2_long", serve_gemma2_long, dev, cfg, x_tree)
    del x_tree
    import torch
    torch.cuda.empty_cache()
    cases = timed("llm_kernels", llm_kernels, dev, d, dither_int32,
                  int32_ops_per_s)
    timed("llm_round_taps_2layer", llm_round_taps_2layer, dev)
    timed("llm_streamed_vs_whole", llm_streamed_vs_whole, dev)
    timed("llm_reduced_card_vs_cpu", llm_reduced_card_vs_cpu, dev)
    timed("serve_reduced_card_vs_cpu", serve_reduced_card_vs_cpu, dev)
    train = timed("train_launcher", train_launcher, dev)
    quant = timed("llm_quantizers", llm_round_quantizers, dev)
    # the two new paths' launches of the round's kernels
    extra = {"train_launcher": train["launches"],
             "llm_quantizers": {}}
    for row in quant["rounds"]:
        for name, v in row["launches"].items():
            extra["llm_quantizers"][name] = extra["llm_quantizers"].get(
                name, 0) + v
    pool_paths, pool_cases = timed("pool", run_pool, dev, dither_int32,
                                   int32_ops_per_s)
    extra.update(pool_paths)
    mamba_paths, mamba_cases = run_mamba(dev, dither_int32, int32_ops_per_s)
    extra.update(mamba_paths)
    moe_paths, moe_cases = run_moe(dev, dither_int32, int32_ops_per_s)
    extra.update(moe_paths)
    return record, launches, {**cases, **pool_cases, **mamba_cases,
                              **moe_cases}, extra


# the streamed uplink: uploads, bytes per upload (quad, CNN) and the chunk
# sizes in wire rows (the quad's 2,048 values are 16 rows, the CNN's 624)
STREAM_QUAD_UPLOADS, STREAM_QUAD_CHUNK = 12, 5
STREAM_CNN_UPLOADS, STREAM_CNN_CHUNK = 8, 100


def _stream_pair(make, uploads: int, chunk_rows: int, batches_of, dev):
    """Two servers from ``make(device)``: A takes ``run_client`` uploads,
    B the same uploads as ``run_client_stream`` chunks, delivered last
    chunk first; the same batches and keys. Returns (A, B, every upload's
    codes equal, every broadcast equal, K1 launches per streamed upload on
    the card)."""
    import torch

    from repro_torch.common import prng
    from repro_torch.kernels import launches as kernel_launches

    a, b = make(dev), make(dev)
    key = prng.PRNGKey(21)
    codes_equal = broadcasts_equal = True
    k1 = []
    for u in range(uploads):
        key, k2, k3 = prng.split(key, 3)
        batches = batches_of(u, dev)
        ma, _ = a.run_client(batches, k2)
        before = kernel_launches()["qsgd_quantize_pack_threefry"]
        msgs, _ = b.run_client_stream(batches, k2, chunk_rows=chunk_rows)
        k1.append(kernel_launches()["qsgd_quantize_pack_threefry"] - before)
        codes_equal &= bits_equal(
            torch.cat([m.payload["packed"] for m in msgs]),
            ma.payload["packed"]) and bits_equal(
            torch.cat([m.payload["norms"] for m in msgs]),
            ma.payload["norms"])
        ra = a.receive(ma, k3)
        rb = [b.receive(m, k3) for m in msgs[::-1]][-1]
        if (ra is None) != (rb is None):
            broadcasts_equal = False
        elif ra is not None:
            broadcasts_equal &= (bits_equal(ra.payload["packed"],
                                            rb.payload["packed"])
                                 and ra.wire_bytes == rb.wire_bytes)
    return a, b, codes_equal, broadcasts_equal, k1


def _same_server(a, b) -> bool:
    return a.state.t == b.state.t and all(
        bits_equal(getattr(a.state, f).cpu(), getattr(b.state, f).cpu())
        for f in ("x_flat", "hidden_flat", "momentum_flat"))


def streamed_uplink(dev) -> dict:
    """The streamed uplink (``QAFeL.run_client_stream``, then ``receive``
    chunk by chunk) against ``run_client`` on the sequential engine: the
    quickstart's quad (K = 4, 12 uploads, chunks of 5 of its 16 rows) on
    the card and on the CPU, and the paper's CNN at full width (K = 4, 8
    uploads, chunks of 100 of its 624 rows) on the card with cuDNN's
    deterministic algorithms. Streamed and whole must agree bit for bit on
    every upload's codes, every broadcast, the state and the meters; the
    quad's streamed server on the card must equal the CPU's; a streamed
    upload is ceil(rows / chunk) K1 launches."""
    import numpy as np
    import torch

    from repro_torch.core import QAFeL
    from repro_torch.examples import cohort_scenarios, quickstart

    def quad(where):
        return QAFeL(quickstart.CONFIG, quickstart.loss_fn,
                     {"w": torch.zeros(quickstart.D)}, device=where)

    def quad_batches(u, where):
        noise = np.random.default_rng(u).standard_normal(
            (2, quickstart.D)).astype(np.float32)
        return {"target": torch.from_numpy(quickstart.TARGET
                                           + 0.1 * noise).to(where)}

    out = {}
    for where in ("cpu", dev):
        out[str(where)] = _stream_pair(quad, STREAM_QUAD_UPLOADS,
                                       STREAM_QUAD_CHUNK, quad_batches, where)
    qa, qb, q_codes, q_bcast, q_k1 = out[str(dev)]
    ca, cb = out["cpu"][:2]
    quad_rows = -(-quickstart.D // 128)

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        task = cohort_scenarios.cnn_task(dev)
        qcfg = cohort_scenarios.qafel_config(4)
        cnn_batches = [task.client_batches(u, None)
                       for u in range(STREAM_CNN_UPLOADS)]
        na, nb, n_codes, n_bcast, n_k1 = _stream_pair(
            lambda where: QAFeL(qcfg, task.loss_fn, task.params0,
                                device=where),
            STREAM_CNN_UPLOADS, STREAM_CNN_CHUNK,
            lambda u, where: cnn_batches[u], dev)
    finally:
        torch.backends.cudnn.deterministic = det
    cnn_rows = -(-na.state.n // 128)
    checks = {
        "quad_codes_equal": q_codes and out["cpu"][2],
        "quad_broadcasts_equal": q_bcast and out["cpu"][3],
        "quad_state_equal": _same_server(qa, qb) and _same_server(ca, cb),
        "quad_meters_equal": qa.meter.summary() == qb.meter.summary()
        == ca.meter.summary() == cb.meter.summary(),
        "quad_card_equals_cpu": _same_server(qb, cb),
        "quad_k1_per_upload": set(q_k1) == {-(-quad_rows
                                              // STREAM_QUAD_CHUNK)},
        "cnn_codes_equal": n_codes, "cnn_broadcasts_equal": n_bcast,
        "cnn_state_equal": _same_server(na, nb),
        "cnn_meters_equal": na.meter.summary() == nb.meter.summary(),
        "cnn_k1_per_upload": set(n_k1) == {-(-cnn_rows // STREAM_CNN_CHUNK)},
        "cnn_upload_bytes": nb.meter.upload_bytes
        == STREAM_CNN_UPLOADS * 42_417}
    record = {"phase": "streamed_uplink",
              "quad": {"uploads": STREAM_QUAD_UPLOADS, "rows": quad_rows,
                       "chunk_rows": STREAM_QUAD_CHUNK, "server_steps":
                       qb.state.t, "k1_per_upload": q_k1[0]},
              "cnn": {"uploads": STREAM_CNN_UPLOADS, "rows": cnn_rows,
                      "chunk_rows": STREAM_CNN_CHUNK, "server_steps":
                      nb.state.t, "k1_per_upload": n_k1[0],
                      "meter": nb.meter.summary()},
              "checks": checks}
    emit(record)
    if not all(checks.values()):
        raise AssertionError(f"streamed_uplink: {checks}")
    return record


# silu by the reference's law (csrc/silu.cu): a sweep of 2^24 values over
# [-100, 100], the tail [-88.8, -87.3] where XLA:CPU flushes s to zero in
# 2^20 steps, and the special values; the length is not a multiple of 4,
# and the same inputs run again from a start one float off the 16-byte
# boundary
SILU_SWEEP, SILU_TAIL = 1 << 24, 1 << 20
SILU_SPECIAL = (0.0, -0.0, 1e-40, -1e-40, 1.4e-45, -1.4e-45, 1.1e-38,
                -1.1e-38, 1.2e-38, 2e-38, -2e-38, float("inf"),
                float("-inf"), float("nan"), 87.5, 88.5, 89.0, -87.5,
                -88.5, -89.0, 3.4e38, -3.4e38, 1e-30)
# per value: the backward recomputes s (the forward's 40 operations)
SILU_FLOPS = {"silu_forward": 40, "silu_backward": 48}
# the models' own kernels (silu and the loss's logsumexp), launched by
# every round on a model that has them, beside the wire path's (the
# logsumexp's sum-only and log-only modes run only on a "model" axis of
# more than one rank, so on one card they stay idle)
MODEL_KERNELS = ("silu_forward", "silu_backward", "logsumexp_max",
                 "logsumexp_forward", "logsumexp_backward")
LSE_KERNELS = ("logsumexp_max", "logsumexp_forward", "logsumexp_backward")
SILU_BYTES = {"silu_forward": 8, "silu_backward": 12}  # per value
SILU_SOURCE = "src/repro_torch/kernels/csrc/silu.cu"
SILU_SHAPE_ARCH = "mamba2-1.3b"  # its conv output and gate in each layer
# the loss's logsumexp (csrc/logsumexp.cu): the timed chunk (64 positions
# of gemma2-2b's 256,000 classes), one loss chunk of the LLM round (local
# batch 2 x seq 64 = 128 rows) at each pool vocabulary a round path runs
# (internvl2-1b's 151,655 is off the 16-byte grid), and a misaligned view
LSE_TIMED = (64, 256_000)
LSE_ARCHS = ("gemma2-2b", "mamba2-1.3b", "zamba2-7b", "qwen3-moe-235b-a22b",
             "deepseek-v3-671b", "internvl2-1b")
LSE_SOURCE = "src/repro_torch/kernels/csrc/logsumexp.cu"
# operations a value: the row max's compare; the subtraction, exp (about
# 25) and the add of the forward pass; the subtraction, exp and the
# product backward
LSE_FLOPS = {"logsumexp_max": 1, "logsumexp_forward": 27,
             "logsumexp_backward": 27}


def _same_or_nan(a, b) -> bool:
    """The same bit patterns, a nan standing for any nan."""
    import torch

    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


def _max_abs_err(pairs) -> float:
    import torch

    return max(float(torch.nan_to_num((a.double() - b.double()).abs(),
                                      nan=0.0, posinf=0.0).max())
               for a, b in pairs)


def _bound(nbytes: float, flops: float) -> dict:
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / F32_OPS_PER_S
    return {"bound_ms": 1e3 * max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s >= ops_s else "operations"}


def silu_cases(dev, build_dir: Path) -> dict:
    """``kernels.silu``'s two launches against the plain version
    (``xla_math.silu_fwd`` / ``silu_bwd``) on the card, bit for bit (a
    nan as a nan), over the sweep, the tail and the special values, from
    an aligned and from a misaligned start (1 / d by ``__frcp_rn``); one
    launch each way by the counters; median device ms of the kernel, the
    plain version, and ``F.silu`` / ``aten.silu_backward`` on the same
    tensor as the library time; the byte bound; each kernel's registers
    and blocks an SM; then the same at mamba2-1.3b's round shapes
    (``silu_round_shapes``). Returns {"silu_forward": case,
    "silu_backward": case}."""
    import torch

    from repro_torch.kernels import launches as kernel_launches
    from repro_torch.kernels import reset_launches, silu, xla_math

    gen = torch.Generator(device=dev).manual_seed(11)
    sweep = torch.linspace(-100.0, 100.0, SILU_SWEEP, device=dev)
    tail = torch.linspace(-88.8, -87.3, SILU_TAIL, device=dev)
    special = torch.tensor(SILU_SPECIAL, device=dev)
    x = torch.cat([sweep, tail, special, torch.zeros(1, device=dev)])
    n = x.numel() - 1  # one spare float in front of the misaligned view
    g = torch.randn(n + 1, generator=gen, device=dev)
    g[::7] = 1e-40  # subnormal cotangents read as zero
    g[3::11] = 1e-30  # tiny ones whose products flush
    cases = {}
    for start in (0, 1):
        xs, gs = x[start:start + n], g[start:start + n]
        reset_launches()
        y = silu.silu_forward(xs)
        gx = silu.silu_backward(gs, xs)
        counts = kernel_launches()
        py, pg = xla_math.silu_fwd(xs), xla_math.silu_bwd(gs, xs)
        torch.cuda.synchronize()
        ok = {"y": _same_or_nan(y, py), "gx": _same_or_nan(gx, pg),
              "one_launch_each": counts["silu_forward"] == 1
              and counts["silu_backward"] == 1}
        if not all(ok.values()):
            raise AssertionError(f"silu from offset {start}: {ok}")
        cases[start] = {"checks": ok,
                        "max_abs_err": _max_abs_err(((y, py), (gx, pg)))}
    del y, gx, py, pg
    xs, gs = x[:n], g[:n]
    out = {}
    fns = {
        "silu_forward": (lambda: silu.silu_forward(xs),
                         lambda: xla_math.silu_fwd(xs),
                         lambda: torch.nn.functional.silu(xs)),
        "silu_backward": (lambda: silu.silu_backward(gs, xs),
                          lambda: xla_math.silu_bwd(gs, xs),
                          lambda: torch.ops.aten.silu_backward(gs, xs))}
    lib = build_dir / "libsilu.so"
    for name, (kernel, plain, library) in fns.items():
        out[name] = {
            "source": SILU_SOURCE, "replaces": None, "n": n, "equal": True,
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "ms": device_ms(kernel, 20), "plain_ms": device_ms(plain, 3),
            "library_ms": device_ms(library, 20),
            "library_call": "torch.nn.functional.silu" if "forward" in name
            else "torch.ops.aten.silu_backward",
            **_bound(SILU_BYTES[name] * n, SILU_FLOPS[name] * n),
            "bytes_formula": f"{SILU_BYTES[name]} B a value / 3.35 TB/s",
            "resources": kernel_resources(
                lib, "silu_fwd_kernel" if "forward" in name
                else "silu_bwd_kernel", 256),
            "checked": {"sweep": [SILU_SWEEP, -100.0, 100.0],
                        "tail": [SILU_TAIL, -88.8, -87.3],
                        "special": list(map(str, SILU_SPECIAL)),
                        "offsets_floats": [0, 1], "length": n,
                        "reciprocal": "__frcp_rn"}}
        case = out[name]
        case["bound_share"] = case["bound_ms"] / case["ms"]
        case["library_bound_share"] = case["bound_ms"] / case["library_ms"]
        case["target_met"] = case["ms"] <= case["library_ms"]
    del x, g, xs, gs
    torch.cuda.empty_cache()
    shapes = silu_round_shapes(dev)
    for name in fns:
        out[name]["round_shapes"] = {k: v[name] for k, v in shapes.items()}
        emit({"phase": "silu_kernel", "name": name, **out[name],
              "offset_checks": cases})
    return out


def silu_round_shapes(dev) -> dict:
    """silu at mamba2-1.3b's round shapes: its conv output (d_inner + 2 x
    groups x state channels) and its gate (d_inner), at the LLM round's
    local batch and seq and at ``train_4k``'s: the kernel each way bit
    for bit against the plain version at the round's seq (the plain
    version's temporaries at ``train_4k`` would take gigabytes), median
    device ms of the kernel and the library call, and the byte bound."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.examples import federated_llm as fl
    from repro_torch.kernels import silu, xla_math

    cfg = get_config(SILU_SHAPE_ARCH)
    conv = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    runs = {"seq64": (fl.LOCAL_BATCH, LLM_SEQ),
            "train_4k": (SHAPE_TRAIN_LOCAL[SILU_SHAPE_ARCH], 4096)}
    gen = torch.Generator(device=dev).manual_seed(17)
    out = {}
    for run, (b, s) in runs.items():
        for what, width in (("conv", conv), ("gate", cfg.d_inner)):
            shape = (b, s, width)
            x = 4.0 * torch.randn(shape, generator=gen, device=dev)
            g = torch.randn(shape, generator=gen, device=dev)
            n = x.numel()
            row = {"shape": list(shape), "n": n}
            if run == "seq64":
                row["equal"] = (
                    _same_or_nan(silu.silu_forward(x), xla_math.silu_fwd(x))
                    and _same_or_nan(silu.silu_backward(g, x),
                                     xla_math.silu_bwd(g, x)))
                if not row["equal"]:
                    raise AssertionError(f"silu at {shape} differs from its "
                                         "plain version")
            cells = {
                "silu_forward": (lambda: silu.silu_forward(x),
                                 lambda: torch.nn.functional.silu(x)),
                "silu_backward": (lambda: silu.silu_backward(g, x),
                                  lambda: torch.ops.aten.silu_backward(g,
                                                                       x))}
            key = f"{what}_{run}"
            out[key] = {}
            for name, (kernel, library) in cells.items():
                c = {**row, "ms": device_ms(kernel, 20),
                     "library_ms": device_ms(library, 20),
                     **_bound(SILU_BYTES[name] * n, SILU_FLOPS[name] * n)}
                c["bound_share"] = c["bound_ms"] / c["ms"]
                out[key][name] = c
            del x, g
    torch.cuda.empty_cache()
    return out


def _lse_logits(rows: int, cols: int, dev, seed: int, offset: int = 0):
    """(rows, cols) f32 logits of N(0, 64) on the card, ``offset`` floats
    into their storage, with the special rows: silu's special values in
    row 0, row 1 all -inf, a run whose exp flushes (a - m in [-88.8,
    -86.5]) in row 2, a maximum 87.5 over the rest in row 3."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    buf = 8.0 * torch.randn(rows * cols + offset, generator=gen, device=dev)
    a = buf[offset:].view(rows, cols)
    sp = torch.tensor(SILU_SPECIAL, device=dev)[:cols]
    a[0, :sp.numel()] = sp
    a[1] = -torch.inf
    k = min(cols, 4096)
    a[2, :k] = a[2].amax() - torch.linspace(86.5, 88.8, k, device=dev)
    a[3, 7 % cols] = a[3].amax() + 87.5
    return a


def _lse_check(dev, rows: int, cols: int, seed: int, offset: int = 0,
               profile: bool = False) -> dict:
    """The loss kernel at one shape against its plain version, bit for bit
    (a nan as a nan): the forward's lse, m and sum, the sum-only and
    log-only modes, the backward (a subnormal quotient in the last row);
    one launch each by the counters and, with ``profile``, the device
    launches of the forward (the row max and the pass: 2) and the backward
    (1) by the profiler."""
    import torch

    from repro_torch.kernels import launches as kernel_launches
    from repro_torch.kernels import logsumexp as klse
    from repro_torch.kernels import reset_launches

    a = _lse_logits(rows, cols, dev, seed, offset)
    g = torch.randn(rows, generator=torch.Generator(device=dev)
                    .manual_seed(seed + 1), device=dev)
    g[-1] = 1e-37
    reset_launches()
    got = klse.forward(a)
    m2, t2 = klse.sum_exp(a, a.amax(-1, keepdim=True))
    lse2 = klse.log_plus(t2, m2)
    da = klse.backward(g, a, got[1], got[2])
    counts = kernel_launches()
    want = klse.plain_forward(a)
    want_da = klse.plain_backward(g, a, want[1], want[2])
    checks = {
        "lse": _same_or_nan(got[0], want[0]), "m": _same_or_nan(got[1],
                                                               want[1]),
        "sum": _same_or_nan(got[2], want[2]),
        "sum_only": _same_or_nan(t2, want[2]) and _same_or_nan(m2, want[1]),
        "log_only": _same_or_nan(lse2, want[0]),
        "grad": _same_or_nan(da, want_da),
        "one_launch_each": all(counts[f"logsumexp_{k}"] == 1 for k in (
            "max", "forward", "sum", "log", "backward"))}
    out = {"shape": [rows, cols], "offset_floats": offset,
           "max_abs_err": _max_abs_err(zip(got + (da,),
                                           want + (want_da,)))}
    if profile:
        fwd = device_launches(lambda: klse.forward(a))
        bwd = device_launches(lambda: klse.backward(g, a, got[1], got[2]))
        out["forward_device_launches"] = sum(c for _, c in fwd)
        out["backward_device_launches"] = sum(c for _, c in bwd)
        out["forward_kinds"] = [n[:60] for n, _ in fwd]
        checks["forward_two_launches"] = out["forward_device_launches"] == 2
        checks["backward_one_launch"] = out["backward_device_launches"] == 1
    out["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"logsumexp at {rows} x {cols}: {checks}")
    return out


def logsumexp_cases(dev, build_dir: Path) -> dict:
    """``kernels.logsumexp`` against its plain version (``plain_forward``,
    ``plain_backward``) on the card at the timed chunk, one loss chunk of
    each pool vocabulary (``LSE_ARCHS``) and a view one float off the
    16-byte boundary; then median device ms of each kernel (the row max,
    the forward pass, the backward), of the forward whole (both), of the
    plain versions, of ``torch.amax``, ``torch.logsumexp`` and
    ``torch.exp`` of the same tensor (the library times: the forward
    whole against ``torch.logsumexp``, the row max against ``torch.amax``,
    the backward against ``torch.exp``, which moves its bytes), and the
    byte bounds, at the timed chunk and at gemma2-2b's and mamba2-1.3b's
    loss chunks; each kernel's registers and blocks an SM. Returns
    {name: case} for ``LSE_KERNELS``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.examples import federated_llm as fl
    from repro_torch.kernels import logsumexp as klse
    from repro_torch.kernels import taps

    chunk = fl.LOCAL_BATCH * LLM_SEQ
    checked = {"timed": _lse_check(dev, *LSE_TIMED, 21, profile=True),
               "misaligned": _lse_check(dev, 8, LSE_TIMED[1], 22, offset=1)}
    for i, arch in enumerate(LSE_ARCHS):
        checked[arch] = _lse_check(dev, chunk, get_config(arch).vocab,
                                   30 + i, profile=arch == LLM_ARCH)
    torch.cuda.empty_cache()
    timings = {}
    for label, (rows, cols) in (
            ("timed", LSE_TIMED),
            ("gemma2-2b_chunk", (chunk, get_config("gemma2-2b").vocab)),
            ("mamba2-1.3b_chunk", (chunk, get_config("mamba2-1.3b").vocab))):
        a = _lse_logits(rows, cols, dev, 40)
        g = torch.randn(rows, generator=torch.Generator(device=dev)
                        .manual_seed(41), device=dev)
        lse, m, total = klse.forward(a)
        scratch = klse._scratch(a, rows)
        n = a.numel()

        def row_max(a=a, scratch=scratch, rows=rows, cols=cols):
            klse._launch(klse._MAX, a=a, scratch=scratch, rows=rows, n=cols)

        row_max()

        def forward_pass(a=a, m=m, total=total, lse=lse, scratch=scratch,
                         rows=rows, cols=cols):
            klse._launch(klse._FORWARD, a=a, m=m, total=total, lse=lse,
                         scratch=scratch, rows=rows, n=cols)

        cells = {
            "logsumexp_max": {
                "ms": device_ms(row_max, 20),
                "plain_ms": device_ms(lambda: a.amax(-1, keepdim=True), 20),
                "library_ms": device_ms(lambda: torch.amax(a, -1), 20),
                **_bound(4 * n + 4 * rows * klse.MAX_PARTS,
                         LSE_FLOPS["logsumexp_max"] * n)},
            "logsumexp_forward": {
                "ms": device_ms(forward_pass, 20),
                "whole_ms": device_ms(lambda: klse.forward(a), 20),
                "plain_ms": device_ms(lambda: klse.plain_forward(a), 3),
                "library_ms": device_ms(lambda: torch.logsumexp(a, -1), 20),
                **_bound(4 * n + 12 * rows,
                         LSE_FLOPS["logsumexp_forward"] * n)},
            "logsumexp_backward": {
                "ms": device_ms(lambda: klse.backward(g, a, m, total), 20),
                "plain_ms": device_ms(
                    lambda: klse.plain_backward(g, a, m, total), 3),
                "library_ms": device_ms(lambda: torch.exp(a), 20),
                **_bound(8 * n + 12 * rows,
                         LSE_FLOPS["logsumexp_backward"] * n)}}
        for c in cells.values():
            c["bound_share"] = c["bound_ms"] / c["ms"]
        fwd = cells["logsumexp_forward"]
        # the function's bound: a read once, whatever the kernels re-read
        fwd["whole_bound_share"] = fwd["bound_ms"] / fwd["whole_ms"]
        fwd["target_met"] = fwd["whole_ms"] <= fwd["library_ms"]
        cells["logsumexp_max"]["target_met"] = (
            cells["logsumexp_max"]["ms"] <= cells["logsumexp_max"]
            ["library_ms"])
        bwd = cells["logsumexp_backward"]
        bwd["target_met"] = bwd["ms"] <= bwd["library_ms"]
        timings[label] = {"shape": [rows, cols], **cells}
        del a, g, lse, m, total, scratch, cells
    torch.cuda.empty_cache()
    lib = build_dir / "liblogsumexp.so"
    resources = {
        "logsumexp_max": kernel_resources(lib, "row_max_kernel", 256),
        "logsumexp_forward": kernel_resources(
            lib, "lse_forward_kernel", taps.THREADS,
            taps._smem_bytes(1, 1)),
        "logsumexp_backward": kernel_resources(lib, "lse_backward_kernel",
                                               256)}
    err = max(c["max_abs_err"] for c in checked.values())
    out = {}
    for name, call, formula in (
            ("logsumexp_max", "torch.amax",
             "4 B a value + 256 B a row / 3.35 TB/s"),
            ("logsumexp_forward", "torch.logsumexp",
             "4 B a value + 12 B a row / 3.35 TB/s"),
            ("logsumexp_backward", "torch.exp",
             "8 B a value + 12 B a row / 3.35 TB/s")):
        t = timings["timed"][name]
        out[name] = {
            "source": LSE_SOURCE, "replaces": None, "shape": list(LSE_TIMED),
            "equal": True, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
            "library_call": call, "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "bytes_formula": formula,
            "resources": resources[name], "timings": {
                k: v[name] for k, v in timings.items()},
            "checked": {k: {"shape": v["shape"], "offset": v["offset_floats"]}
                        for k, v in checked.items()}}
        emit({"phase": "logsumexp_kernel", "name": name, **out[name],
              "checks": {k: v["checks"] for k, v in checked.items()},
              "profiled": {k: {key: v[key] for key in (
                  "forward_device_launches", "backward_device_launches",
                  "forward_kinds")}
                  for k, v in checked.items()
                  if "forward_device_launches" in v}})
    return out


# the flat mesh (launch.mesh, sharding.rules, QAFeL(mesh=)): a one-rank NCCL
# group on the CNN, then the per-segment flush at d = 1e8 for the segments
# of a (4,) and a (2, 2) mesh run one after another on this card
MESH_CNN_FLUSHES = 10
MESH_D, MESH_K, MESH_SEGMENTS = 10**8, 10, 4
MESH_CHUNK_ROWS = 1 << 16
MESH_FOLDS = {"4": (("data",), (4,)), "2x2": (("data", "model"), (2, 2))}


def mesh_one_rank(dev) -> dict:
    """A one-rank NCCL group (a ``FileStore`` in a temporary directory),
    ``make_sim_mesh(1)`` and ``QAFeL(mesh=)`` driven by the sequential
    simulator on the paper's CNN for ``MESH_CNN_FLUSHES`` flushes, against
    the same run with no mesh (run twice before it, the first warming the
    card): x, x-hat, momentum, the accuracy trace and the meters bit for
    bit (cuDNN's deterministic algorithms), and both runs' wall seconds;
    the group is destroyed after."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.core import QAFeL
    from repro_torch.examples import federated_celeba as fc
    from repro_torch.launch.mesh import make_sim_mesh
    from repro_torch.models.cnn import init_cnn
    from repro_torch.sim import AsyncFLSimulator, SimConfig

    qcfg = fc.qafel_config()
    uploads = MESH_CNN_FLUSHES * qcfg.buffer_size

    def run(mesh):
        task = fc.celeba_task(dev)
        algo = QAFeL(qcfg, task.loss_fn, init_cnn(0, device=dev),
                     device=dev, mesh=mesh)
        sim = AsyncFLSimulator(algo, SimConfig(
            concurrency=CONCURRENCY, max_uploads=uploads,
            eval_every_steps=5), task.client_batches, task.eval_fn)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = sim.run()
        torch.cuda.synchronize()
        return algo, res, time.perf_counter() - t0, kernels.launches()

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    try:
        plain, pres, pwall, _ = run(None)  # warms the card up for the next
        plain, pres, pwall, _ = run(None)
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(Path(tmp) / "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = make_sim_mesh(1)
            algo, res, wall, launches = run(mesh)
            backend = dist.get_backend()
            full = {name: algo.state.full(name).clone()
                    for name in ("x_flat", "hidden_flat", "momentum_flat")}
        finally:
            dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = det
    checks = {
        "backend_nccl": backend == "nccl",
        "flushes": res.server_steps == pres.server_steps == MESH_CNN_FLUSHES,
        "state": all(bits_equal(v, getattr(plain.state, name))
                     for name, v in full.items()),
        "segment_padded": algo.state.x_flat.numel() == CNN_ROWS * 128,
        "accuracy_trace": [tuple(p) for p in res.accuracy_trace]
        == [tuple(p) for p in pres.accuracy_trace],
        "meters": algo.meter.summary() == plain.meter.summary(),
        "replicas_in_sync": bool(res.metrics["replicas_in_sync"]),
        "K4_per_flush": launches["buffer_aggregate"] == res.server_steps,
        "K2_per_flush": launches["qsgd_quantize_pack_batch"]
        == res.server_steps}
    record = {"phase": "flat_mesh", "part": "one_rank_nccl_cnn",
              "uploads": res.uploads, "flushes": res.server_steps,
              "wall_s": wall, "meshless_wall_s": pwall,
              "launches": launches, "checks": checks}
    emit(record)
    if not all(checks.values()):
        raise AssertionError(f"flat_mesh one-rank checks failed: {checks}")
    return record


def mesh_segments(dev, smi: str) -> dict:
    """``kernels.ops.flush_segment`` at d = 1e8, K = 10, qsgd4 both ways,
    for each segment of a (4,) and of a (2, 2) mesh (the segment index
    folded from each rank's coordinates by ``sharding.rules``), one after
    another on this card and with no group, whole and in row chunks of
    ``MESH_CHUNK_ROWS``: the segments concatenated against the unsharded
    ``server_flush_step`` bit for bit (x, x-hat, m, codes, norms), and the
    flush taps of the gathered parts against the unsharded flush's; the
    kernel launches of one segment; median device ms of one segment's
    flush and of the unsharded flush."""
    from types import SimpleNamespace

    import torch

    from repro_torch import kernels
    from repro_torch.common import prng
    from repro_torch.core.qafel import place_flat_on_mesh, segment_rows
    from repro_torch.kernels import ops
    from repro_torch.kernels import taps as ktaps
    from repro_torch.sharding.rules import (flat_segment_index,
                                            mesh_flat_extent)

    n, k = MESH_D, MESH_K
    rows = ops.rows_for(n)
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(n, generator=gen, device=dev)
    h = x + 0.01 * torch.randn(n, generator=gen, device=dev)
    m = 0.02 * torch.randn(n, generator=gen, device=dev)
    stack = torch.empty((k, rows, 64), dtype=torch.uint8, device=dev)
    norms = torch.empty((k, rows), device=dev)
    for i in range(k):
        delta = 0.05 * torch.randn((1, n), generator=gen, device=dev)
        p, nm = ops.qsgd_quantize_batch(delta, prng.PRNGKey(100 + i)[None],
                                        BITS)
        stack[i], norms[i] = p[0], nm[0]
    del delta
    w = torch.tensor([0.1 + 0.01 * i for i in range(k)], device=dev)
    key2d = prng.PRNGKey(7)[None]
    kw = dict(bits=BITS, sbits=BITS, lr=1.2, beta=0.3)
    want = ops.server_flush_step(x, h, m, stack, norms, w, None, key2d,
                                 n=n, taps=True, **kw)
    checks, per_segment = {}, None
    for fold, (names, shape) in MESH_FOLDS.items():
        for chunk in (None, MESH_CHUNK_ROWS):
            parts = {name: [] for name in ("x", "h", "m", "p", "nm", "delta",
                                           "diff", "q")}
            segs = []
            for coord in (list(c) for c in
                          __import__("itertools").product(
                              *(range(e) for e in shape))):
                mesh = SimpleNamespace(mesh_dim_names=names, shape=shape,
                                       get_coordinate=lambda c=coord: c)
                seg, nseg = flat_segment_index(mesh), mesh_flat_extent(mesh)
                segs.append(seg)
                xl, hl, ml = (place_flat_on_mesh(v, mesh, n)
                              for v in (x, h, m))
                rows_l = xl.shape[0] // 128
                r0 = seg * rows_l
                args = (xl, hl, ml, segment_rows(stack, r0, rows_l),
                        segment_rows(norms, r0, rows_l), w, None, key2d)
                kernels.reset_launches()
                out = ops.flush_segment(*args, seg=seg, nseg=nseg, n=n,
                                        chunk_rows=chunk, with_parts=True,
                                        **kw)
                launches = kernels.launches()
                if fold == "4" and chunk is None and seg == 0:
                    per_segment = {
                        "launches": {name: c for name, c in launches.items()
                                     if c},
                        "ms": device_ms(lambda: ops.flush_segment(
                            *args, seg=seg, nseg=nseg, n=n, **kw), 10)}
                for name, v in zip(("x", "h", "m"), out[:3]):
                    parts[name].append(v)
                parts["p"].append(out[3][0])
                parts["nm"].append(out[3][1])
                for name, v in zip(("delta", "diff", "q"), out[4]):
                    parts[name].append(v)
                del xl, hl, ml, args, out
            cat = {name: torch.cat(v) for name, v in parts.items()}
            del parts
            tap = ktaps.flush_taps(x, cat["x"][:n], cat["delta"][:n],
                                   cat["diff"][:n], cat["q"][:n], w)
            tag = f"{fold}_{'chunks' if chunk else 'whole'}"
            checks[tag] = {
                "segments": sorted(segs) == list(range(MESH_SEGMENTS)),
                "x": bits_equal(cat["x"][:n], want[0]),
                "hidden": bits_equal(cat["h"][:n], want[1]),
                "momentum": bits_equal(cat["m"][:n], want[2]),
                "codes": bits_equal(cat["p"][:rows], want[3][0]),
                "norms": bits_equal(cat["nm"][:rows], want[3][1]),
                "taps": bits_equal(tap, want[4]),
                "padding_zero": bool((cat["x"][n:] == 0).all()
                                     and (cat["p"][rows:] == 0).all())}
            del cat
            torch.cuda.empty_cache()
    whole_ms = device_ms(lambda: ops.server_flush_step(
        x, h, m, stack, norms, w, None, key2d, n=n, **kw), 10)
    record = {"phase": "flat_mesh", "part": "segments_d1e8", "d": n, "k": k,
              "segments": MESH_SEGMENTS, "chunk_rows": MESH_CHUNK_ROWS,
              "segment_ms": per_segment["ms"], "unsharded_ms": whole_ms,
              "segment_launches": per_segment["launches"],
              "nvidia_smi": smi, "checks": checks}
    emit(record)
    failed = [f"{tag}.{name}" for tag, c in checks.items()
              for name, ok in c.items() if not ok]
    if failed:
        raise AssertionError(f"flat_mesh segment checks failed: {failed}")
    del x, h, m, stack, norms, want
    torch.cuda.empty_cache()
    return record


def run_flat_mesh(dev, smi: str) -> dict:
    """The flat mesh phase: ``mesh_one_rank`` then ``mesh_segments``."""
    return {"one_rank": mesh_one_rank(dev),
            "segments": mesh_segments(dev, smi)}


# the LLM round on a ("data", "model") mesh: a one-rank NCCL group on a
# (1, 1) mesh; gemma2-2b at full width cut to 2 layers (the quantizer
# rounds' cut, d = 745,558,272), mesh vs meshless from the same seeds, the
# second round with taps; then the launcher at full depth under the group
MODEL_MESH_LAYERS, MODEL_MESH_ROUNDS = 2, 2
MODEL_MESH_ARGV = TRAIN_ARGV[:TRAIN_ARGV.index("--checkpoint-dir")]
MODEL_MESH_PEAK_RATIO = 1.05  # the mesh launcher's peak over the meshless
# the meshes reckoned per rank for the later four-card call
RECKON_MESHES = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1),
                 "16x16": (16, 16)}


def _model_mesh_pair(dev, mesh) -> dict:
    """gemma2-2b at full width and ``MODEL_MESH_LAYERS`` layers: the mesh
    round and the meshless round from the same seeds, state and batches,
    ``MODEL_MESH_ROUNDS`` rounds (remat, row chunks of ``LLM_CHUNK_ROWS``,
    the LLM round's K, P, batch and seq; the last with taps), compared
    after each on host copies: x, x-hat, m, the loss, the wire bytes and
    the taps bit for bit; each round's ms by CUDA events."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.common import prng
    from repro_torch.distributed.steps import (init_round_state,
                                               make_qafel_round)
    from repro_torch.examples import federated_llm as fl
    from repro_torch.launch.train import round_batch

    cfg = configs.get_config(LLM_ARCH).replace(n_layers=MODEL_MESH_LAYERS)
    qcfg = fl.qafel_config(4)
    states = {"meshless": init_round_state(cfg, 0, dev),
              "mesh": init_round_state(cfg, 0, dev, mesh=mesh)}
    fns = {(name, taps): make_qafel_round(
        cfg, qcfg, chunk_rows=LLM_CHUNK_ROWS, taps=taps,
        mesh=mesh if name == "mesh" else None)
        for name in states for taps in (False, True)}
    d = fns[("mesh", False)].plan.d
    rng = np.random.default_rng(0)
    weights = torch.ones(qcfg.buffer_size)
    rounds = []
    for step in range(MODEL_MESH_ROUNDS):
        taps = step == MODEL_MESH_ROUNDS - 1
        batch = round_batch(cfg, qcfg, rng, fl.LOCAL_BATCH, LLM_SEQ, dev)
        met, ms = {}, {}
        for name in states:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            states[name], met[name] = fns[(name, taps)](
                states[name], batch, weights, prng.PRNGKey(step))
            end.record()
            torch.cuda.synchronize()
            ms[name] = start.elapsed_time(end)
        host = {name: [f.cpu() for f in st.flat]
                for name, st in states.items()}
        checks = {
            n: bits_equal(a, b[:a.numel()]) for n, a, b in zip(
                ("x", "hidden", "momentum"), host["meshless"],
                host["mesh"])}
        del host
        a, b = met["meshless"], met["mesh"]
        checks.update(
            loss=bits_equal(a["loss"].cpu(), b["loss"].cpu()),
            upload_bytes=a["upload_bytes"] == b["upload_bytes"],
            broadcast_bytes=a["broadcast_bytes"] == b["broadcast_bytes"])
        if taps:
            checks["taps"] = bits_equal(a["taps"].cpu(), b["taps"].cpu())
        rounds.append({"step": step, "taps": taps, "ms": ms,
                       "loss": float(b["loss"]), "checks": checks})
        del batch, met
    del states, fns
    torch.cuda.empty_cache()
    return {"d": d, "layers": MODEL_MESH_LAYERS, "rounds": rounds}


def _model_mesh_launcher(dev) -> dict:
    """``launch.train.run`` at the train_launcher phase's settings (no
    checkpoint) for its ``TRAIN_STEPS`` rounds under the one-rank group,
    which takes the reference's host mesh: peak ``max_memory_allocated``
    above its base (``_launcher_base``) against the meshless launcher's
    in this call, K1 / K3 / update
    launches by counters set to 0 just before and read just after, then
    one more round of its round function profiled (ms by CUDA events,
    device launches, idle share)."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core.staleness import staleness_weight
    from repro_torch.distributed.steps import make_qafel_round
    from repro_torch.kernels import launches as kernel_launches
    from repro_torch.kernels import reset_launches
    from repro_torch.launch import train

    args = train.parse_args(MODEL_MESH_ARGV)
    base, cycles_before = _launcher_base()
    reset_launches()
    out = train.run(args)
    torch.cuda.synchronize()
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    cycles_after = _cycle_bytes()
    mesh, state = out["mesh"], out["state"]
    cfg = configs.get_config(args.arch)
    qcfg = train.qafel_config(args)
    round_fn = make_qafel_round(cfg, qcfg, remat=False,
                                chunk_rows=train.CHUNK_ROWS, mesh=mesh)
    d = round_fn.plan.d
    rows = -(-d // 128)
    chunks = -(-rows // train.CHUNK_ROWS)
    k = args.buffer_k
    local = args.global_batch // (k * args.local_steps)
    batch = train.round_batch(cfg, qcfg, np.random.default_rng(args.seed + 1),
                              local, args.seq, dev)
    weights = staleness_weight(torch.zeros(k)).to(dev)
    (state, met), prof = _profiled(lambda: round_fn(
        state, batch, weights, train.round_key(args.seed, TRAIN_STEPS)))
    want = {"qsgd_quantize_pack_threefry": TRAIN_STEPS * (k + 1) * chunks,
            "qsgd_unpack_dequantize": TRAIN_STEPS * (k + 1),
            "server_update": TRAIN_STEPS}
    meshless = _PEAKS.get("train_launcher")
    record = {"argv": MODEL_MESH_ARGV, "d": d, "mesh": list(mesh.shape),
              "segment": state.flat[0].numel(),
              "losses": out["losses"].tolist(), "loop_s": out["seconds"],
              "profiled_round": prof, "ms": prof["wall_ms"],
              "loss_profiled_round": float(met["loss"]),
              "launches": {n: v for n, v in launches.items() if v},
              "peak_bytes": peak, "peak_gb": peak / 1e9,
              "base_bytes": base, "own_peak_gb": (peak - base) / 1e9,
              "cycle_bytes_before": cycles_before,
              "cycle_bytes_after": cycles_after,
              "meshless_own_peak_gb": None if meshless is None
              else meshless / 1e9,
              "peak_ratio": None if meshless is None
              else (peak - base) / meshless}
    record["checks"] = {
        "losses_finite": all(math.isfinite(v) for v in record["losses"]),
        **{f"{n}_launches": launches[n] == v for n, v in want.items()},
        "other_kernels_idle": all(v == 0 for n, v in launches.items()
                                  if n not in want
                                  and n not in MODEL_KERNELS),
        "peak_within_5pct": meshless is not None
        and peak - base <= MODEL_MESH_PEAK_RATIO * meshless}
    del out, state, batch, round_fn
    torch.cuda.empty_cache()
    return record


def mesh_reckoning() -> list:
    """For each arch of the registry, at the LLM round's settings and at
    ``train_4k``, on each of ``RECKON_MESHES``: the reference's per-rank
    state bytes (``sharding.rules.sharded_bytes`` of ``state_pspecs``,
    the launcher's rules, FSDP off), and the port's per-rank round by the
    count of its buffers on its layout: the three flat segments in the
    state's dtype, the f32 ``buf`` segment and one segment message's codes
    and norms over ``padded d / n``; the client's shards and their
    gradients (and, with more than one segment, its working copy of
    x-hat's shards); with more than one "model" rank the f32 segment
    delta and the largest leaf in f32 in flight, else the chunk
    transients; ``LLM_TRANSIENT_BYTES``' activations; and whether that
    fits the 60 GB gate. Nothing is allocated (``meta``)."""
    from types import SimpleNamespace

    from repro_torch import configs
    from repro_torch.common.tree import tree_leaves
    from repro_torch.distributed.steps import abstract_round_state
    from repro_torch.launch.shapes import input_specs
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules as R

    rows_out = []
    for arch in sorted(configs.list_archs()):
        cfg = configs.get_config(arch)
        params = T.abstract_params(cfg)
        leaves = tree_leaves(params)
        d = sum(t.numel() for t in leaves)
        base = max(set(t.dtype for t in leaves),
                   key=lambda dt: sum(t.numel() for t in leaves
                                      if t.dtype == dt))
        item = leaves[0].new_empty((), dtype=base).element_size()
        big = max(t.numel() for t in leaves)
        for settings in ("llm_round", "train_4k"):
            state = (abstract_round_state(cfg) if settings == "llm_round"
                     else input_specs(cfg, "train_4k")["state"])
            for name, (nd, nm) in RECKON_MESHES.items():
                mesh = SimpleNamespace(mesh_dim_names=("data", "model"),
                                       shape=(nd, nm))
                rules = R.ShardingRules(mesh=mesh)
                ref_state = R.sharded_bytes(
                    state, R.state_pspecs(rules, cfg, state), mesh)
                n = nd * nm
                seg = R.flat_padded_len(d, n) // n
                local = sum(t.numel() // R.shard_extent(mesh, sp)
                            for t, sp in zip(leaves, R.spec_leaves(
                                R.param_pspecs(rules, cfg, params))))
                parts = {
                    "segments": 3 * item * seg, "buf": 4 * seg,
                    "message": seg // 2 + 4 * -(-seg // 128),
                    "client": 2 * item * local
                    + (item * local if n > 1 else 0),
                    "in_flight": (4 * seg + 4 * big if nm > 1
                                  else 4 * 4 * 128 * LLM_CHUNK_ROWS),
                    "activations": LLM_TRANSIENT_BYTES
                    - 4 * 4 * 128 * LLM_CHUNK_ROWS}
                total = sum(parts.values())
                rows_out.append({
                    "phase": "mesh_reckoning", "arch": arch,
                    "settings": settings, "mesh": name, "d": d,
                    "ref_state_bytes_per_rank": ref_state,
                    "port_round_bytes_per_rank": total,
                    "port_round_gb": total / 1e9, "parts": parts,
                    "fits_60gb": total < LLM_PEAK_CAP_GB * 1e9,
                    "round_ported": cfg.family == "dense"
                    and cfg.modality == "text" and not cfg.n_experts
                    and not cfg.use_mla})
    for row in rows_out:
        emit(row)
    return rows_out


def model_mesh(dev, smi: str) -> dict:
    """The LLM round on a ("data", "model") mesh on this card: a one-rank
    NCCL group (a ``FileStore`` under ``build/``) on a (1, 1) mesh,
    ``_model_mesh_pair`` then ``_model_mesh_launcher``; the group is
    destroyed after; then ``mesh_reckoning``. Returns the launches of the
    launcher's rounds by kernel."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_sim_mesh2d

    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(Path(tmp) / "store"), 1), rank=0,
        world_size=1)
    try:
        backend = dist.get_backend()
        pair = _model_mesh_pair(dev, make_sim_mesh2d((1, 1)))
        launcher = _model_mesh_launcher(dev)
    finally:
        dist.destroy_process_group()
    reckoning = mesh_reckoning()
    checks = {"backend_nccl": backend == "nccl",
              **{f"round{r['step']}_{k}": ok for r in pair["rounds"]
                 for k, ok in r["checks"].items()},
              **{f"launcher_{k}": ok for k, ok in launcher["checks"].items()},
              "reckoning_lines": len(reckoning)
              == 2 * len(RECKON_MESHES) * 10}
    record = {"phase": "model_mesh", "nvidia_smi": smi, "pair": pair,
              "launcher": launcher, "checks": checks}
    emit(record)
    if not all(checks.values()):
        raise AssertionError(f"model_mesh checks failed: "
                             f"{[k for k, ok in checks.items() if not ok]}")
    return launcher["launches"]


# the assigned shapes (launch/shapes.py) on one card: gemma2-2b (26 layers,
# local/global windows) and mamba2-1.3b (48 layers, recurrent cache) at full
# width through make_qafel_round, transformer.prefill and decode_step
SHAPE_ARCHS = ("gemma2-2b", "mamba2-1.3b")
SHAPE_GATE_GB = LLM_PEAK_CAP_GB  # the card's 60 GB gate
# cuts of the published global batch (train: the local batch of K = 8, P =
# 1 clients), each the largest the reckoning and the phase's time allow
SHAPE_TRAIN_LOCAL = {"gemma2-2b": 2, "mamba2-1.3b": 4}
SHAPE_PREFILL_BATCH = {"gemma2-2b": 4, "mamba2-1.3b": 3}
SHAPE_DECODE_BATCH = {"gemma2-2b": 22, "mamba2-1.3b": 128}
SHAPE_DECODE_STEPS, SHAPE_LONG_STEPS = 8, 32
SHAPE_LONG_START = 524_272  # 32 steps cross the rings' wrap at 524,288
SHAPE_PROFILED_STEPS = 4
# super-blocks of the prefill profiled apart (None: the whole prefill is
# profiled): gemma2-2b's whole prefill makes ~855,000 device activities,
# which take ~40 s to read back from the profiler
SHAPE_PREFILL_PROFILE_BLOCKS = {"gemma2-2b": 1, "mamba2-1.3b": None}
# decode at the prompt's last position against prefill's logits there (bf16)
SHAPE_DECODE_VS_PREFILL = {"gemma2-2b": SERVE_BF16_DECODE_VS_FORWARD}


def _tree_bytes(tree) -> int:
    from repro_torch.common.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def shapes_reckoning() -> dict:
    """Every arch of ``configs.list_archs()`` x the four assigned shapes,
    from ``launch.shapes.input_specs`` on ``meta`` (nothing allocated): the
    bytes of the parameters, the round state, the cache and the inputs;
    for ``train_4k`` also ``llm_peak_reckoning`` of the round (its state,
    sums, messages and a seq-64 transient; the seq-4,096 activations are
    measured in the shape phases); whether the pair fits one card under
    the 60 GB gate, and if not, the largest global batch that does (the
    cache and inputs scale with the batch; a train state does not, so a
    train state over the gate fits at no batch)."""
    from repro_torch import configs
    from repro_torch.common.tree import tree_leaves
    from repro_torch.launch.shapes import SHAPES, input_specs
    from repro_torch.models import transformer as T

    gate = SHAPE_GATE_GB * 1e9
    rows = []
    for arch in configs.list_archs():
        cfg = configs.get_config(arch)
        for name, shape in SHAPES.items():
            spec = input_specs(cfg, name)
            b = shape.global_batch
            row = {"arch": arch, "shape": name, "seq": shape.seq,
                   "global_batch": b,
                   "window_override": spec["window_override"]}
            if spec["kind"] == "train":
                st = spec["state"]
                d = sum(t.numel() for t in tree_leaves(st.x))
                row.update(d=d, state_bytes=sum(
                    _tree_bytes(getattr(st, n))
                    for n in ("x", "hidden", "momentum")),
                    input_bytes=_tree_bytes({n: spec[n] for n in (
                        "batch", "weights", "key_data")}),
                    llm_peak_reckoning=llm_peak_reckoning(d))
                total = row["llm_peak_reckoning"] + row["input_bytes"]
                row.update(bytes=total, fits=total <= gate,
                           largest_global_batch=b if total <= gate else 0)
            else:
                params = _tree_bytes(spec["params"])
                cache = (_tree_bytes(spec["cache"]) if "cache" in spec else
                         _tree_bytes(T.abstract_cache(
                             cfg, b, shape.seq, spec["window_override"])))
                inputs = _tree_bytes(spec["inputs"])
                total = params + cache + inputs
                per_row = (cache + inputs) / b
                row.update(param_bytes=params, cache_bytes=cache,
                           input_bytes=inputs, bytes=total,
                           fits=total <= gate,
                           largest_global_batch=min(b, max(0, int(
                               (gate - params) // per_row))))
            rows.append(row)
    record = {"phase": "shapes_reckoning", "gate_gb": SHAPE_GATE_GB,
              "rows": rows,
              "fit": sorted(f"{r['arch']}:{r['shape']}" for r in rows
                            if r["fits"])}
    emit(record)
    return record


def _profiled(fn):
    """``fn()`` under ``torch.profiler`` (device activities only), its
    wall ms by CUDA events: returns (fn's result, {"wall_ms",
    "device_busy_ms", "device_launches", "idle_share"})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    by_name = kernel_table(prof)
    busy = sum(t for _, t in by_name.values())
    return out, {"wall_ms": wall, "device_busy_ms": busy,
                 "device_launches": sum(c for c, _ in by_name.values()),
                 "idle_share": 1 - busy / wall,
                 "silu_device_launches": sum(
                     c for n, (c, _) in by_name.items()
                     if "silu" in n.lower())}


def shape_train(dev, arch: str) -> tuple:
    """``train_4k`` on ``arch`` as published: ``make_qafel_round`` at
    ``TRAIN_K`` clients of ``TRAIN_P`` step, sequence 4,096, qsgd4 both
    ways, remat, row chunks of 2^20, the batch's shape from
    ``input_specs`` with the local batch cut to ``SHAPE_TRAIN_LOCAL``; one
    round, profiled on the device and timed by CUDA events, the launch
    counters set to 0 just before and read just after. Returns (record,
    launches)."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.common import prng
    from repro_torch.common.tree import tree_leaves
    from repro_torch.core.qafel import QAFeLConfig
    from repro_torch.distributed.steps import (init_round_state,
                                               make_qafel_round)
    from repro_torch.examples import federated_llm as fl
    from repro_torch.kernels import launches as kernel_launches
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.shapes import SHAPES, TRAIN_K, TRAIN_P, input_specs
    from repro_torch.launch.train import round_batch

    cfg = configs.get_config(arch)
    shape = SHAPES["train_4k"]
    base = fl.qafel_config(TRAIN_K)
    qcfg = QAFeLConfig(client_lr=base.client_lr, server_lr=base.server_lr,
                       server_momentum=base.server_momentum,
                       buffer_size=TRAIN_K, local_steps=TRAIN_P,
                       client_quantizer="qsgd4", server_quantizer="qsgd4")
    spec = input_specs(cfg, "train_4k", qcfg)
    k, p, local_pub = tuple(spec["batch"]["tokens"].shape)[:3]
    local = SHAPE_TRAIN_LOCAL[arch]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    holder = [init_round_state(cfg, 0, dev)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    d = sum(t.numel() for t in tree_leaves(holder[0].x))
    chunks = -(-(-(-d // 128)) // LLM_CHUNK_ROWS)
    round_fn = make_qafel_round(cfg, qcfg, chunk_rows=LLM_CHUNK_ROWS,
                                window_override=spec["window_override"])
    batch = round_batch(cfg, qcfg, np.random.default_rng(0), local,
                        shape.seq, dev)
    weights = torch.ones(k)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    (new, met), prof = _profiled(lambda: round_fn(
        holder[0], batch, weights, prng.PRNGKey(0)))
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    loss = float(met["loss"])
    holder[0] = new
    tokens = k * p * local * shape.seq
    reckoning = llm_peak_reckoning(d)
    want = {"qsgd_quantize_pack_threefry": (k + 1) * chunks,
            "qsgd_unpack_dequantize": k + 1, "server_update": 1}
    record = {
        "phase": "shape_train_4k", "arch": arch, "n_layers": cfg.n_layers,
        "published": {"seq": shape.seq, "global_batch": shape.global_batch,
                      "K": k, "P": p, "local_batch": local_pub},
        "cut": {"local_batch": local, "global_batch": k * p * local,
                "why": "the activations of a client's local batch at "
                       "4,096 positions beside the round's state under the "
                       "60 GB gate"},
        "d": d, "batch_shape": list(batch["tokens"].shape), "remat": True,
        "init_s": init_s, "ms": prof["wall_ms"],
        "tokens_per_s": tokens / (prof["wall_ms"] / 1e3), "loss": loss,
        "peak_gb": peak / 1e9, "peak_reckoning_gb": reckoning / 1e9,
        "activations_over_reckoning_gb": (peak - reckoning) / 1e9,
        "device": prof, "launches": {n: v for n, v in launches.items()
                                     if v},
        "upload_bytes": met["upload_bytes"]}
    checks = {"loss_finite": math.isfinite(loss),
              **{f"{n}_launches": launches[n] == v for n, v in want.items()},
              "peak_under_gate": peak < SHAPE_GATE_GB * 1e9}
    record["checks"] = checks
    emit(record)
    del holder, new, batch, round_fn
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"shape_train_4k {arch}: {checks}")
    return record, launches


def _fill_(cache, gen, skip_rows: int = 0) -> None:
    """Every k, v, SSM state and conv tail of ``cache`` from ``gen``
    (N(0, 0.25)), in place, rows from ``skip_rows`` on (dim 1 is the
    batch); ``slot_pos`` untouched."""
    for lc in cache["layers"].values():
        for name, t in lc.items():
            if name != "slot_pos":
                for sb in range(t.shape[0]):
                    t[sb, skip_rows:].normal_(0.0, 0.5, generator=gen)


def _ring_law_(cache, last: int) -> None:
    """Each attention layer's ``slot_pos`` as after positions 0..``last``:
    slot i of a ring of w holds last - ((last - i) mod w), a linear cache
    (w > last) positions 0..last."""
    import torch

    for lc in cache["layers"].values():
        if "slot_pos" in lc:
            w = lc["slot_pos"].shape[-1]
            i = torch.arange(w, device=lc["slot_pos"].device)
            sp = last - torch.remainder(last - i, w)
            lc["slot_pos"].copy_(torch.where(sp >= 0, sp, -1).to(
                torch.int32).expand_as(lc["slot_pos"]))


def _timed_steps(dev, steps):
    """Run the callables ``steps`` in order, each timed by CUDA events;
    returns (their results, ms each)."""
    import torch

    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in steps]
    out = []
    torch.cuda.synchronize()
    for (a, b), fn in zip(ev, steps):
        a.record()
        out.append(fn())
        b.record()
    torch.cuda.synchronize()
    return out, [a.elapsed_time(b) for a, b in ev]


def shape_prefill(dev, arch: str, params) -> tuple:
    """``prefill_32k`` on ``arch``: ``transformer.prefill`` of B =
    ``SHAPE_PREFILL_BATCH`` prompts of 32,768 tokens (the inputs' shape
    from ``input_specs``, the caches sized for its ``max_len``), timed by
    CUDA events, the launch counters set to 0 just before and read just
    after; its device launches and idle share from a profile of the whole
    prefill, or with ``SHAPE_PREFILL_PROFILE_BLOCKS`` of the same prefill
    cut to that many super-blocks, run apart. Returns (record, prompt row
    0, its last logits, row 0's cache as one sequence's cache,
    launches)."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.common.tree import tree_map
    from repro_torch.data.synthetic import synthetic_batch_for_config
    from repro_torch.kernels import launches as kernel_launches
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.shapes import SHAPES, input_specs
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import _masked_out

    cfg = configs.get_config(arch)
    shape = SHAPES["prefill_32k"]
    spec = input_specs(cfg, "prefill_32k")
    bsz = SHAPE_PREFILL_BATCH[arch]
    raw = synthetic_batch_for_config(cfg, np.random.default_rng(2), bsz,
                                     shape.seq)
    inputs = {"tokens": torch.from_numpy(raw["tokens"]).to(dev)}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    run = lambda c, p: T.prefill(c, p, inputs, max_len=spec["max_len"],
                                 window_override=spec["window_override"])
    blocks = SHAPE_PREFILL_PROFILE_BLOCKS[arch]
    reset_launches()
    if blocks is None:
        (logits, cache), prof = _profiled(lambda: run(cfg, params))
    else:
        outs, ms = _timed_steps(dev, [lambda: run(cfg, params)])
        logits, cache = outs[0]
        del outs
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    if blocks is not None:
        cut = cfg.replace(n_layers=blocks * len(cfg.layer_pattern))
        part = dict(params, layers=tree_map(lambda t: t[:blocks],
                                            params["layers"]))
        _, part_prof = _profiled(lambda: run(cut, part))
        del part
        prof = {"wall_ms": ms[0], "profiled_apart": dict(
            part_prof, super_blocks=blocks, of=cfg.n_super_blocks),
            "idle_share": part_prof["idle_share"],
            "silu_device_launches": part_prof["silu_device_launches"]}
    cache_bytes = _tree_bytes(cache)
    reck = _tree_bytes(spec["params"]) + cache_bytes + 4 * bsz * shape.seq
    nb = shape.seq // 512  # the attention layers' block pairs run
    pairs = cfg.n_super_blocks * sum(
        not _masked_out(i, j, 512, 512, T._window_for(cfg, kind, None))
        for kind in cfg.layer_pattern if kind != "mamba"
        for i in range(nb) for j in range(nb))
    record = {
        "phase": "shape_prefill_32k", "arch": arch,
        "n_layers": cfg.n_layers,
        "published": {"seq": shape.seq, "global_batch": shape.global_batch},
        "cut": {"batch": bsz, "why": "the cache at 32,768 positions and the "
                "prefill's activations beside the weights under the 60 GB "
                "gate, and the phase's time"},
        "ms": prof["wall_ms"],
        "tokens_per_s": bsz * shape.seq / (prof["wall_ms"] / 1e3),
        "attention_block_pairs": pairs, "device": prof,
        "peak_gb": peak / 1e9, "reckoning_gb": reck / 1e9,
        "resident_before_gb": resident / 1e9, "cache_bytes": cache_bytes,
        "silu_launches": {n: v for n, v in launches.items()
                          if n.startswith("silu")},
        "logits_finite": bool(torch.isfinite(logits).all())}
    checks = {"logits_finite": record["logits_finite"],
              "logits_shape": tuple(logits.shape)[:2] == (bsz, 1),
              "peak_under_gate": peak < SHAPE_GATE_GB * 1e9}
    record["checks"] = checks
    emit(record)
    if not all(checks.values()):
        raise AssertionError(f"shape_prefill_32k {arch}: {checks}")
    row_cache = tree_map(lambda t: t[:, :1].clone() if t.dim() > 2
                         else t.clone(), cache)
    last = logits[:1].float().clone()
    del cache, logits
    torch.cuda.empty_cache()
    return record, inputs["tokens"][:1].clone(), last, row_cache, launches


def _decode_record(dev, name, arch, cfg, params, cache, tokens, positions,
                   window, **extra) -> dict:
    """Decode ``tokens`` (one (B, 1) tensor per step, or None: greedy from
    the last logits) at ``positions`` through ``transformer.decode_step``,
    each step timed by CUDA events, then ``SHAPE_PROFILED_STEPS`` more at
    the last position profiled on the device. Returns the record's
    measurements and the logits of every step."""
    import torch

    from repro_torch.kernels import launches as kernel_launches
    from repro_torch.kernels import reset_launches
    from repro_torch.models import transformer as T

    state = {"tok": tokens[0]}
    logits_all = []

    def step(pos, tok):
        def run():
            t = state["tok"] if tok is None else tok
            logits, _ = T.decode_step(cfg, params, cache, {"tokens": t}, pos,
                                      window_override=window)
            state["tok"] = torch.argmax(logits[:, -1], -1).to(
                torch.int32)[:, None]
            logits_all.append(logits)
            return logits
        return run

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    steps = [step(p, t) for p, t in zip(positions, tokens)]
    _, ms = _timed_steps(dev, steps)
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    _, prof = _profiled(lambda: [step(positions[-1], tokens[-1])()
                                 for _ in range(SHAPE_PROFILED_STEPS)])
    bsz = tokens[0].shape[0]
    cache_bytes = _tree_bytes(cache)
    weights = _tree_bytes(params)
    return {
        "phase": name, "arch": arch, "n_layers": cfg.n_layers,
        "batch": bsz, "positions": [positions[0], positions[-1]],
        "steps": len(steps), "step_ms": ms,
        "step_ms_median": statistics.median(ms),
        "tokens_per_s": bsz * len(ms) / (sum(ms) / 1e3),
        "device_launches_per_step": prof["device_launches"]
        / SHAPE_PROFILED_STEPS,
        "device_ms_per_step": prof["device_busy_ms"] / SHAPE_PROFILED_STEPS,
        "idle_share": prof["idle_share"],
        "step_bound_ms": 1e3 * (weights + cache_bytes) / HBM_BYTES_PER_S,
        "bound_formula": "(weights + the cache) / 3.35 TB/s",
        "cache_bytes": cache_bytes, "weight_bytes": weights,
        "peak_gb": peak / 1e9, "reckoning_gb": (weights + cache_bytes) / 1e9,
        "launches": launches,
        "logits_finite": all(bool(torch.isfinite(x).all())
                             for x in logits_all), **extra}, logits_all


def shape_decode_32k(dev, arch: str, params, prompt, last_logits,
                     row_cache) -> dict:
    """``decode_32k`` on ``arch``: B = ``SHAPE_DECODE_BATCH`` rows against a
    cache of 32,768 positions (``input_specs``' shapes, the batch cut);
    row 0 holds the prefill phase's first prompt, the other rows values
    drawn from a seed, and each step decodes position 32,767 again. Row 0
    is held against the prefill's logits at that position: an attention
    model re-decodes the prompt's last token over the cache prefill wrote
    (its slot rewritten with the same token); mamba2 decodes it from the
    state a prefill of the first 32,767 tokens left."""
    import torch

    from repro_torch import configs
    from repro_torch.launch.shapes import SHAPES, input_specs
    from repro_torch.models import transformer as T

    cfg = configs.get_config(arch)
    shape = SHAPES["decode_32k"]
    spec = input_specs(cfg, "decode_32k")
    bsz = SHAPE_DECODE_BATCH[arch]
    wo = spec["window_override"]
    pos = shape.seq - 1
    if cfg.family == "ssm":  # the state after the first 32,767 tokens
        _, row_cache = T.prefill(cfg, params, {"tokens": prompt[:, :pos]},
                                 max_len=shape.seq, window_override=wo)
    torch.cuda.empty_cache()
    cache = T.init_cache(cfg, bsz, shape.seq, wo, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    _fill_(cache, gen, skip_rows=1)
    for key, lc in cache["layers"].items():
        for name, t in lc.items():
            if name == "slot_pos":
                t.copy_(row_cache["layers"][key][name])
            else:
                t[:, :1].copy_(row_cache["layers"][key][name])
    del row_cache
    torch.cuda.empty_cache()
    toks = torch.randint(0, cfg.vocab, (bsz, 1), generator=gen, device=dev,
                         dtype=torch.int32)
    toks[0, 0] = prompt[0, pos]
    rec, logits = _decode_record(
        dev, "shape_decode_32k", arch, cfg, params, cache,
        [toks] * SHAPE_DECODE_STEPS, [pos] * SHAPE_DECODE_STEPS, wo,
        published={"seq": shape.seq, "global_batch": shape.global_batch},
        cut={"batch": bsz, "why": "none" if bsz == shape.global_batch else
             "the cache of 32,768 positions a row beside the weights under "
             "the 60 GB gate"})
    got = logits[0][:1].float()
    err = float((got - last_logits).abs().max())
    scale = float(last_logits.abs().max())
    bound = SHAPE_DECODE_VS_PREFILL.get(
        arch, SERVE_RECURRENT_DECODE_VS_FORWARD * scale)
    rec["row0_vs_prefill"] = {"max_abs_err": err, "max_abs_logit": scale,
                              "bound": bound, "greedy_equal": bool(
                                  got.argmax(-1).eq(
                                      last_logits.argmax(-1)).all())}
    checks = {"logits_finite": rec["logits_finite"],
              "row0_vs_prefill": err <= bound,
              "peak_under_gate": rec["peak_gb"] < SHAPE_GATE_GB}
    rec["checks"] = checks
    emit(rec)
    del cache, logits
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"shape_decode_32k {arch}: {checks}")
    return rec


def shape_long_500k(dev, arch: str, params) -> dict:
    """``long_500k`` on ``arch``: B = 1, the cache of ``input_specs`` (rings
    of 8,192 slots on gemma2-2b's global layers, 4,096 on its local ones;
    mamba2-1.3b's fixed state) filled from a seed with ``slot_pos`` on the
    ring law, then ``SHAPE_LONG_STEPS`` greedy decode steps from position
    524,272, across the rings' wrap at 524,288, each timed by CUDA events.
    One more step, at 524,304, is held against the same decode recomputed
    from a copy of the cache: an attention model over its window's 8,192
    positions laid out in position order in a linear cache (no window,
    the local rings as they are), mamba2 at position 0 (its recurrence
    reads no position: bit for bit)."""
    import torch

    from repro_torch import configs
    from repro_torch.common.tree import tree_map
    from repro_torch.launch.shapes import LONG_WINDOW, SHAPES, input_specs
    from repro_torch.models import transformer as T

    cfg = configs.get_config(arch)
    shape = SHAPES["long_500k"]
    spec = input_specs(cfg, "long_500k")
    wo = spec["window_override"]
    torch.cuda.empty_cache()
    cache = T.init_cache(cfg, 1, shape.seq, wo, dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    _fill_(cache, gen)
    _ring_law_(cache, SHAPE_LONG_START - 1)
    positions = list(range(SHAPE_LONG_START,
                           SHAPE_LONG_START + SHAPE_LONG_STEPS))
    first = torch.full((1, 1), 17, dtype=torch.int32, device=dev)
    rec, logits = _decode_record(
        dev, "shape_long_500k", arch, cfg, params, cache,
        [first] + [None] * (SHAPE_LONG_STEPS - 1), positions, wo,
        published={"seq": shape.seq, "global_batch": 1},
        cut={"batch": 1, "why": "none; the cache filled from a seed instead "
             "of a prefill of 524,288 tokens"})
    tok = torch.argmax(logits[-1][:, -1], -1).to(torch.int32)[:, None]
    pos = positions[-1] + 1
    other = tree_map(torch.clone, cache)
    if cfg.family == "ssm":
        recompute, at, window = other, 0, wo
    else:  # the global rings in position order, one free slot at the end
        recompute, at, window = other, pos, None
        for key, lc in other["layers"].items():
            if T._window_for(cfg, key.split("_", 1)[1], wo) != LONG_WINDOW:
                continue
            w = lc["slot_pos"].shape[-1]
            order = torch.arange(pos - w + 1, pos, device=dev)
            idx = torch.remainder(order, w)
            for name in ("k", "v"):
                lin = torch.zeros_like(lc[name])
                lin[:, :, :w - 1] = lc[name][:, :, idx]
                lc[name] = lin
            sp = torch.full_like(lc["slot_pos"], -1)
            sp[:, :w - 1] = order.to(torch.int32)
            lc["slot_pos"] = sp
    got, _ = T.decode_step(cfg, params, cache, {"tokens": tok}, pos,
                           window_override=wo)
    want, _ = T.decode_step(cfg, params, recompute, {"tokens": tok}, at,
                            window_override=window)
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    wrapped = {}
    for key, lc in cache["layers"].items():
        if "slot_pos" in lc:
            w = lc["slot_pos"].shape[-1]
            i = torch.arange(w, device=dev)
            law = pos - torch.remainder(pos - i, w)
            wrapped[key] = {"slots": w, "law": bool(torch.equal(
                lc["slot_pos"][0].long(), law)),
                "slot0": int(lc["slot_pos"][0, 0])}
    exact = cfg.family == "ssm"
    bound = 0.0 if exact else SERVE_BF16_DECODE_VS_FORWARD
    rec["vs_recomputed"] = {"position": pos, "max_abs_err": err,
                            "max_abs_logit": scale, "bound": bound,
                            "how": "position 0, same state" if exact else
                            "the window's 8,192 positions in a linear cache"}
    rec["rings"] = wrapped
    checks = {"logits_finite": rec["logits_finite"]
              and bool(torch.isfinite(got).all()),
              "vs_recomputed": err <= bound,
              "ring_law_after_wrap": all(r["law"] for r in wrapped.values()),
              "peak_under_gate": rec["peak_gb"] < SHAPE_GATE_GB}
    rec["checks"] = checks
    emit(rec)
    del cache, other, logits
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"shape_long_500k {arch}: {checks}")
    return rec


def run_shapes(dev) -> dict:
    """The reckoning of every arch x shape, then the eight cells: per arch
    of ``SHAPE_ARCHS``, ``train_4k`` (fresh round state), then fresh bf16
    weights (seed 0) for ``prefill_32k``, ``decode_32k`` (its row 0 from
    the prefill) and ``long_500k``. Returns {cell: launches by kernel}."""
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as T

    timed("shapes_reckoning", shapes_reckoning)
    paths = {}
    for arch in SHAPE_ARCHS:
        short = arch.split("-")[0]
        _, paths[f"{short}_train_4k"] = timed(f"{short}_train_4k",
                                              shape_train, dev, arch)
        params = T.init_params(configs.get_config(arch), 0, dev)
        _, prompt, last, row_cache, paths[f"{short}_prefill_32k"] = timed(
            f"{short}_prefill_32k", shape_prefill, dev, arch, params)
        paths[f"{short}_decode_32k"] = timed(
            f"{short}_decode_32k", shape_decode_32k, dev, arch, params,
            prompt, last, row_cache)["launches"]
        del row_cache
        paths[f"{short}_long_500k"] = timed(
            f"{short}_long_500k", shape_long_500k, dev, arch, params)[
                "launches"]
        del params
        torch.cuda.empty_cache()
    return paths

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.common.device import resolve_device
    from repro_torch.kernels import _build

    (ROOT / "build").mkdir(exist_ok=True)
    _LOG.append(open(ROOT / "build" / "chip_smoke.jsonl", "w"))

    def query(fields: str) -> str:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]

    smi = query("name,power.limit")
    print(smi, flush=True)
    dev = resolve_device("cuda")
    max_sm_mhz = float(query("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32_ops_per_s = sms * INT32_LANES_PER_SM * max_sm_mhz * 1e6
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0), "sms": sms,
          "max_sm_mhz": max_sm_mhz, "int32_ops_per_s": int32_ops_per_s})

    t0 = time.perf_counter()
    build_dir = _build.build_all(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "dir": str(build_dir.relative_to(ROOT))})
    dither_int32 = dither_ops(build_dir)
    hash_int32 = batch_encode_ops(build_dir)

    cnn = timed("kernels_cnn", check_kernels, CNN_ROWS, CNN_K, dev, 50, 10,
                dither_int32, hash_int32, int32_ops_per_s)
    big = timed("kernels_d1e8", check_kernels, BIG_ROWS, CNN_K, dev, 10, 3,
                dither_int32, hash_int32, int32_ops_per_s)
    torch.cuda.empty_cache()
    timed("upload_before_after", upload_before_after, dev)
    silu_kernel = timed("kernels_silu", silu_cases, dev, build_dir)
    lse_kernel = timed("kernels_logsumexp", logsumexp_cases, dev, build_dir)

    cohort_cases = timed("cohort_kernels", check_cohort_kernels, dev,
                         hash_int32, int32_ops_per_s)

    steps = upload_launches(dev)
    broadcast_encode_launches(dev)
    record, launches = timed("main_path", run_main_path, dev,
                             steps["client_step_device_launches"])
    main_profile = profile_window(dev)
    _, cohort_launches = timed(
        "cohort_path", run_cohort_path, dev, main_profile,
        steps["client_step_device_launches"])
    profile_window(dev, uploads=COHORT_UPLOADS, cohort_size=COHORT_SIZE)
    timed("check_against_cpu", check_against_cpu, dev)
    taps, taps_main, taps_cohort = timed("telemetry", run_telemetry, dev)
    family_cases, family_launches, _ = timed("quantizer_family",
                                             run_quantizer_family, dev)
    _, population_launches = timed("population", run_population, dev,
                                   hash_int32)
    _, llm_launches, llm_cases, new_paths = run_llm(dev, dither_int32,
                                                     int32_ops_per_s)
    shape_paths = run_shapes(dev)
    timed("streamed_uplink", streamed_uplink, dev)
    flat_mesh = timed("flat_mesh", run_flat_mesh, dev, smi)
    mesh_launches = flat_mesh["segments"]["segment_launches"]
    model_mesh_launches = timed("model_mesh", model_mesh, dev, smi)

    case_keys = ("d", "ms", "plain_ms", "bound_ms", "bound_by",
                 "bound_share", "equal", "max_abs_err", "bytes_formula")
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
            "ops_formula": m["ops_formula"],
            "cohort_launches": cohort_launches[name],
            "d1e8": {"ms": b["ms"], "plain_ms": b["plain_ms"],
                     "bound_ms": b["bound_ms"], "equal": b["equal"],
                     "max_abs_err": b["max_abs_err"]}})
        kernels_line[-1]["family_launches"] = family_launches[name]
        kernels_line[-1]["population_launches"] = population_launches[name]
        kernels_line[-1]["llm_round_launches"] = llm_launches[name]
        for path, counts in new_paths.items():
            kernels_line[-1][f"{path}_launches"] = counts.get(name, 0)
        llm = {"qsgd_quantize_pack_threefry": ("K1_threefry_llm",
                                               "K1_row_offset_llm"),
               "qsgd_unpack_dequantize": ("K3_llm",
                                          "K3_accum_inplace_llm",
                                          "K3_apply_inplace_bf16_llm",
                                          "K3_apply_taps_bf16_llm")}
        if name in llm:
            kernels_line[-1]["llm_cases"] = {
                case: {key: llm_cases[case][key] for key in case_keys}
                for case in llm[name]}
            for model in ("musicgen", "mamba2", "zamba2", "qwen3moe"):
                kernels_line[-1][f"{model}_cases"] = {
                    case: {key: llm_cases[case][key] for key in case_keys
                           + ("plain_rows",)}
                    for case in (c.replace("_llm", f"_{model}")
                                 for c in llm[name] if "taps" not in c)}
        prefix = {"qsgd_quantize_pack_threefry": "K1_",
                  "qsgd_quantize_pack_batch": "K2_",
                  "qsgd_unpack_dequantize": "K3_"}.get(name)
        if prefix:
            kernels_line[-1]["cohort_cases"] = {
                case: {key: c[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "equal",
                    "max_abs_err", "bytes_formula")}
                for case, c in {**cohort_cases, **family_cases}.items()
                if case.startswith(prefix)}
    for name, shape in (("flush_taps", "flush_taps_cnn"),
                        ("upload_taps", "upload_taps_b1_qsgd4_cnn")):
        m = taps[shape]
        kernels_line.append({
            "name": name, "route": "cuda", "source": m["source"],
            "replaces": None, "launches": taps_main[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
            "equal": m["equal"], "bytes_formula": m["bytes_formula"],
            "launches_note": "taps-on main path (telemetry phase); every "
                             "other path runs with taps off",
            "cohort_launches": taps_cohort[name],
            "family_launches": family_launches[name],
            "population_launches": population_launches[name],
            "llm_round_launches": llm_launches[name],
            "library_note": "no single PyTorch call computes it: the sums "
                            "of squares run in XLA:CPU's order, and the "
                            "upload's error fuses the decode's product",
            "cases": {case: {key: c[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "bound_share",
                "over_floor_ms", "equal", "max_abs_err", "bytes")}
                for case, c in taps.items()
                if case.startswith(name) and "ms" in c},
            "checked_lengths": sorted(
                case for case, c in taps.items()
                if case.startswith(name) and "ms" not in c)})
    m = llm_cases["server_update_llm"]
    kernels_line.append({
        "name": "server_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/server_update.cu",
        "replaces": None, "launches": llm_launches["server_update"],
        "llm_round_launches": llm_launches["server_update"],
        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": None, "equal": m["equal"],
        "bytes_formula": m["bytes_formula"], "d": m["d"],
        "launches_note": "the LLM round's 2 measured rounds (one a round); "
                         "the launcher's rounds and the quantizer rounds "
                         "below",
        **{f"{path}_launches": counts.get("server_update", 0)
           for path, counts in new_paths.items()},
        "llm_cases": {case: {key: llm_cases[case][key] for key in case_keys}
                      for case in ("server_update_llm",
                                   "server_update_taps_llm")},
        **{f"{model}_cases": {f"server_update_{model}": {
            key: llm_cases[f"server_update_{model}"][key]
            for key in case_keys + ("plain_rows",)}}
           for model in ("musicgen", "mamba2", "zamba2", "qwen3moe")}})
    m = llm_cases["round_taps_llm"]
    kernels_line.append({
        "name": "round_taps", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/round_taps.cu",
        "replaces": None, "launches": llm_launches["round_taps"],
        "llm_round_launches": llm_launches["round_taps"],
        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": None, "equal": m["equal"],
        "bytes_formula": m["bytes_formula"], "d": m["d"],
        "launches_note": "the full-depth round with the taps on (one a "
                         "round); every other path runs with taps off"})
    for name in ("silu_forward", "silu_backward"):
        m = silu_kernel[name]
        kernels_line.append({
            "name": name, "route": "cuda", "source": m["source"],
            "replaces": None,
            "launches": new_paths["mamba2_round"][name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "library_call": m["library_call"], "equal": m["equal"],
            "bytes_formula": m["bytes_formula"], "n": m["n"],
            "target_met": m["target_met"],
            "round_shapes": {k: {key: c[key] for key in (
                "shape", "ms", "library_ms", "bound_ms", "bound_share")}
                for k, c in m["round_shapes"].items()},
            "launches_note": "mamba2-1.3b's round (its conv and gate in "
                             "each of 48 layers); zamba2-7b's, qwen3-moe's "
                             "(its experts) and the other paths below",
            **{f"{path}_launches": counts.get(name, 0)
               for path, counts in new_paths.items()}})
    for name in LSE_KERNELS:
        m = lse_kernel[name]
        kernels_line.append({
            "name": name, "route": "cuda", "source": m["source"],
            "replaces": None, "launches": llm_launches[name],
            "llm_round_launches": llm_launches[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "library_call": m["library_call"], "equal": m["equal"],
            "bytes_formula": m["bytes_formula"], "shape": m["shape"],
            "target_met": m["timings"]["timed"]["target_met"],
            "chunk_timings": {k: {key: c[key] for key in (
                "ms", "library_ms", "bound_ms", "bound_share")}
                for k, c in m["timings"].items()},
            "launches_note": "gemma2-2b's round (one a loss chunk and "
                             "client step); the other rounds below",
            **{f"{path}_launches": counts.get(name, 0)
               for path, counts in new_paths.items()}})
    for entry in kernels_line:
        entry["shapes_launches"] = {cell: counts.get(entry["name"], 0)
                                    for cell, counts in shape_paths.items()}
        entry["flat_mesh_segment_launches"] = mesh_launches.get(
            entry["name"], 0)
        entry["model_mesh_launches"] = model_mesh_launches.get(
            entry["name"], 0)
    if not all(e["launches"] and e["zamba2_round_launches"]
               for e in kernels_line[-5:]):
        raise AssertionError("silu.cu was not launched on mamba2-1.3b's "
                             "and zamba2-7b's rounds, or logsumexp.cu on "
                             "the LLM rounds' loss")
    for name, seconds in _PHASE_SECONDS:
        emit({"phase_seconds": name, "seconds": seconds})
    print(smi, flush=True)
    emit({"kernels": kernels_line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
