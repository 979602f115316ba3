"""The ranks of tests/test_torch_mesh.py: one gloo group of ``WORLD``
processes on the CPU runs the port's flat mesh (``launch.mesh``,
``QAFeL(mesh=)``, the sharded flush, the cohort step and engine, the
checkpoint reshard) and the LLM round on ("data", "model") meshes
(``make_qafel_round(mesh=)``, ``LLM_CASES``), and rank 0 writes what they
made under ``OUT`` as ``.npz`` and ``.json`` files, which the test holds
against the reference's paths. Not a test; imports neither jax nor the
JAX package:

    PYTHONPATH=src:tests python tests/mesh_ranks.py OUT [--llm]

The inputs come from seeds (``flush_inputs``, ``TARGETS``, ``llm_batch``),
so the test builds the same ones; the LLM round's states and messages are
the test's (``OUT/llm_in.npz``: the reference's initial and round-1
states, the port's meshless round's messages), which with ``--llm`` the
ranks wait for after their flat mesh; without it the LLM cases are not
run.
"""
from __future__ import annotations

import json
import os
import socket
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves

from repro_torch import configs as TC
from repro_torch.common import prng
from repro_torch.core import QAFeL, QAFeLConfig, make_quantizer
from repro_torch.core import save_checkpoint
from repro_torch.core.protocol import (CLIENT_UPDATE, decode_message_flat,
                                       frame_cohort_messages)
from repro_torch.core.qafel import (client_update_flat, place_flat_on_mesh,
                                    segment_rows)
from repro_torch.core.quantizers import TreeLayout
from repro_torch.distributed import steps as TS
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (gather_segments, make_host_mesh,
                                     make_production_mesh, make_sim_mesh,
                                     make_sim_mesh2d)
from repro_torch.launch.train import round_batch
from repro_torch.models import transformer as T
from repro_torch.obs import RunTracer
from repro_torch.sharding.rules import flat_segment_index

WORLD = 4
W, B = 300, 7  # the quad's two leaves: d = 307, the reference's odd edge
N = W + B
TARGETS = np.random.default_rng(0).standard_normal((40, 2, N)).astype(
    np.float32) + 3.0
UPLOADS = 10  # three flushes of K = 3 and one upload into the fourth
# the flush variants driven through QAFeL, each on (4,) and (2, 2)
VARIANTS = {
    "qsgd4": {},
    "identity_no_momentum": dict(cq="identity", sq="identity",
                                 server_momentum=0.0),
    "top_k_server": dict(sq="top_k0.2"),
    "lowrank_window": dict(cq="lowrank4g32"),
    "chunk_rows": dict(chunk_rows=1),
    "taps": dict(taps=True),
}
MESHES = {"4": lambda: make_sim_mesh(4),
          "2x2": lambda: make_sim_mesh2d((2, 2))}
COHORT_B = 5  # members of the cohort step, over 4 (and 2) data ranks
SIM = dict(concurrency=8, max_uploads=40, eval_every_steps=1, seed=0)


# the LLM round on a ("data", "model") mesh: reduced configs, K = 2, P = 1,
# a local batch of 2 (which 4 data ranks do not divide: replicated) at
# seq 32; case: (arch, mesh shape, rounds, remat)
LLM_Q = dict(client_lr=3e-2, server_lr=1.0, server_momentum=0.3,
             buffer_size=2, local_steps=1, client_quantizer="qsgd4",
             server_quantizer="qsgd4")
LLM_LOCAL, LLM_SEQ = 2, 32
LLM_WEIGHTS = np.array([0.9, 0.7], np.float32)
LLM_CASES = {
    "gemma2-2b_4x1": ("gemma2-2b", (4, 1), 1, False),
    "gemma2-2b_2x2": ("gemma2-2b", (2, 2), 2, False),
    "gemma2-2b_2x2_remat": ("gemma2-2b", (2, 2), 1, True),
    "gemma2-2b_1x4": ("gemma2-2b", (1, 4), 1, False),
    "granite-34b_1x4": ("granite-34b", (1, 4), 1, False),
    # the qkv biases and the qk-norm, from the port's seed-0 state
    "codeqwen1.5-7b_2x2": ("codeqwen1.5-7b", (2, 2), 1, False),
    "qwen3-14b_1x4": ("qwen3-14b", (1, 4), 1, False),
}
SEEDED = ("codeqwen1.5-7b", "qwen3-14b")  # states from init_round_state
# the production meshes, reckoned by their shapes alone
PRODUCTION_MESHES = {"16x16": {"data": 16, "model": 16},
                     "2x16x16": {"pod": 2, "data": 16, "model": 16}}
LLM_TAPS = "gemma2-2b_4x1"  # the case run with taps on
LLM_WATCHED = "gemma2-2b_1x4"  # the case whose allocations rank 0 records
STATE = ("x", "hidden", "momentum")


def qcfg(**kw) -> dict:
    return dict(dict(client_lr=0.1, server_lr=1.2, server_momentum=0.3,
                     buffer_size=3, local_steps=2, client_quantizer="qsgd4",
                     server_quantizer="qsgd4"), **kw)


def variant_config(name: str) -> dict:
    """QAFeLConfig keywords of a variant (its ``cq`` / ``sq`` named as
    the quantizers)."""
    kw = {k: v for k, v in VARIANTS[name].items()
          if k not in ("cq", "sq", "chunk_rows", "taps")}
    if "cq" in VARIANTS[name]:
        kw["client_quantizer"] = VARIANTS[name]["cq"]
    if "sq" in VARIANTS[name]:
        kw["server_quantizer"] = VARIANTS[name]["sq"]
    return qcfg(**kw)


def tloss(params, batch, key):
    del key
    t = batch["target"]
    return (torch.sum((params["w"] - t[:W]) ** 2)
            + torch.sum((params["b"] - t[W:]) ** 2))


def params0():
    return {"w": torch.zeros(W), "b": torch.ones(B)}


def tier(i: int) -> bool:
    """Every third upload comes from a qsgd2 tier (a qsgd client only)."""
    return i % 3 == 1


def drive(algo, lo: int, hi: int, seed: int = 4, record=None):
    """Uploads lo..hi-1 of one key stream into ``algo``; ``record(algo,
    broadcast)`` after each flush."""
    key = prng.PRNGKey(seed)
    q2 = make_quantizer("qsgd2")
    for i in range(hi):
        key, k2, k3 = prng.split(key, 3)
        if i < lo:
            continue
        batches = {"target": torch.from_numpy(TARGETS[i])}
        if tier(i) and algo.cq.spec.kind == "qsgd":
            st = algo.state
            kt, ke = prng.split(k2)
            out = client_update_flat(
                algo.loss_fn, algo.qcfg, q2.spec, st.layout,
                st.full("hidden_flat"), batches, kt, ke, b=1)
            msg = frame_cohort_messages(CLIENT_UPDATE, q2, out, st.layout,
                                        version=st.t)[0]
        else:
            msg, _ = algo.run_client(batches, k2)
        bmsg = algo.receive(msg, k3)
        if bmsg is not None and record is not None:
            record(algo, bmsg)
    return algo


def state_arrays(algo, prefix: str = "") -> dict:
    """x, x-hat and m at the true length (gathered under a mesh)."""
    return {prefix + n: algo.state.full(n + "_flat").numpy().copy()
            for n in ("x", "hidden", "momentum")}


def flush_inputs() -> dict:
    """A flush's inputs at d = 307 (3 wire rows, the last ragged): x,
    x-hat and m, K = 3 qsgd4 uploads encoded from seeded deltas (their
    ragged tails zero), the weights and the broadcast key."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(N).astype(np.float32)
    deltas = (0.05 * rng.standard_normal((3, N))).astype(np.float32)
    packed, norms = ops.qsgd_quantize_batch(
        torch.from_numpy(deltas), torch.from_numpy(
            rng.integers(0, 2 ** 32, (3, 2))), 4)
    return dict(x=x, hidden=(x + 0.01 * rng.standard_normal(N)).astype(
                    np.float32),
                momentum=(0.02 * rng.standard_normal(N)).astype(np.float32),
                stack=packed.numpy(), norms=norms.numpy(),
                weights=np.array([0.5, 0.3, 0.2], np.float32),
                key2d=rng.integers(0, 2 ** 32, (1, 2)).astype(np.uint32))


def run_flush(mesh) -> dict:
    """The sharded flush on ``flush_inputs`` in row chunks of 1 with taps:
    every output gathered to its true length."""
    f = flush_inputs()
    t = {k: torch.from_numpy(v) for k, v in f.items() if k != "key2d"}
    seg = [place_flat_on_mesh(t[k], mesh, N)
           for k in ("x", "hidden", "momentum")]
    rows_l = seg[0].shape[0] // 128
    r0 = flat_segment_index(mesh) * rows_l
    out = ops.server_flush_step_sharded(
        *seg, segment_rows(t["stack"], r0, rows_l),
        segment_rows(t["norms"], r0, rows_l),
        t["weights"], None, torch.from_numpy(f["key2d"].astype(np.int64)),
        bits=4, sbits=4, lr=1.2, beta=0.3, mesh=mesh, n=N, taps=True,
        chunk_rows=1)
    rows = ops.rows_for(N)
    return dict(x=gather_segments(out[0], mesh)[:N].numpy(),
                hidden=gather_segments(out[1], mesh)[:N].numpy(),
                momentum=gather_segments(out[2], mesh)[:N].numpy(),
                packed=gather_segments(out[3][0], mesh)[:rows].numpy(),
                norms=gather_segments(out[3][1], mesh)[:rows].numpy(),
                taps=out[4].numpy())


def run_variant(name: str, mesh) -> tuple:
    """``UPLOADS`` uploads of a variant through ``QAFeL(mesh=)``: after
    each flush x, x-hat and m, the decoded broadcast and its bytes; the
    flush taps of the taps variant."""
    v = VARIANTS[name]
    tracer = RunTracer(taps=True) if v.get("taps") else None
    algo = QAFeL(QAFeLConfig(**variant_config(name)), tloss, params0(),
                 device="cpu", mesh=mesh, telemetry=tracer,
                 chunk_rows=v.get("chunk_rows"))
    arrays, info = {}, {"wire_bytes": []}

    def record(a, bmsg):
        i = a.state.t
        arrays.update(state_arrays(a, f"{i}_"))
        arrays[f"{i}_q"] = decode_message_flat(a.sq, bmsg).numpy()
        info["wire_bytes"].append(bmsg.wire_bytes)
    drive(algo, 0, UPLOADS, record=record)
    info["meter"] = algo.meter.summary()
    info["drift"] = algo.hidden_drift()
    if tracer is not None:
        info["taps"] = [e.data["taps"] for e in tracer.events("flush")]
    return arrays, info


def run_cohort_step(mesh) -> dict:
    """``client_update_flat`` at b = 5 with taps on ``mesh``."""
    rng = np.random.default_rng(3)
    hidden = torch.from_numpy((3.0 + rng.standard_normal(N)).astype(
        np.float32))
    k_train = prng.split(prng.PRNGKey(11), COHORT_B)
    k_enc = prng.split(prng.PRNGKey(12), COHORT_B)
    spec = make_quantizer("qsgd4").spec
    algo = QAFeL(QAFeLConfig(**qcfg()), tloss, params0(), device="cpu")
    out = client_update_flat(
        tloss, algo.qcfg, spec, algo.state.layout, hidden,
        {"target": torch.from_numpy(TARGETS[:COHORT_B])}, k_train, k_enc,
        b=COHORT_B, taps=True, mesh=mesh)
    return dict(packed=out["packed"].numpy(), norms=out["norms"].numpy(),
                taps=out["taps"].numpy(), hidden=hidden.numpy(),
                k_train=k_train.numpy(), k_enc=k_enc.numpy())


def run_sim(mesh) -> dict:
    """The cohort engine on the quad (``tiered_bits``, cohorts of 5):
    the result's accuracy trace, meters, staleness and replicas."""
    from repro_torch.examples.cohort_scenarios import quad_task
    from repro_torch.sim import CohortAsyncFLSimulator, SimConfig

    task = quad_task("cpu")
    algo = QAFeL(QAFeLConfig(client_lr=0.05, server_lr=1.0,
                             server_momentum=0.3, buffer_size=4,
                             local_steps=2), task.loss_fn, task.params0,
                 device="cpu", mesh=mesh)
    res = CohortAsyncFLSimulator(algo, SimConfig(**SIM), task.client_batches,
                                 task.eval_fn, scenario="tiered_bits",
                                 cohort_size=COHORT_B).run()
    return dict(trace=[list(p) for p in res.accuracy_trace],
                metrics=res.metrics, uploads=res.uploads,
                server_steps=res.server_steps,
                x=algo.state.full("x_flat").numpy().tolist())


def run_reshard(out: Path) -> dict:
    """One run through archives on 4 ranks, then 2, then 1 (rank 0 alone,
    no mesh), then 4 again: uploads 0-7 on (4,), 7-11 on (2,), 11-14 on
    none, 14-18 on (4,); each stage saves, the next loads."""
    rank = dist.get_rank()
    ck = [out / f"reshard_{i}.npz" for i in range(3)]
    res = {}
    m4 = make_sim_mesh(4)
    m2 = make_sim_mesh(2)  # ranks 2 and 3 are outside it
    a = drive(QAFeL(QAFeLConfig(**qcfg()), tloss, params0(), device="cpu",
                    mesh=m4), 0, 7)
    save_checkpoint(ck[0], a)
    res.update(state_arrays(a, "stage0_"))
    if m2.get_coordinate() is not None:
        a = QAFeL(QAFeLConfig(**qcfg()), tloss, params0(), device="cpu",
                  mesh=m2).load_checkpoint(ck[0])
        drive(a, 7, 11)
        save_checkpoint(ck[1], a)
        res.update(state_arrays(a, "stage1_"))
    dist.barrier()
    if rank == 0:
        a = QAFeL(QAFeLConfig(**qcfg()), tloss, params0(),
                  device="cpu").load_checkpoint(ck[1])
        drive(a, 11, 14)
        save_checkpoint(ck[2], a)
        res.update(state_arrays(a, "stage2_"))
    dist.barrier()
    a = QAFeL(QAFeLConfig(**qcfg()), tloss, params0(), device="cpu",
              mesh=m4).load_checkpoint(ck[2])
    drive(a, 14, 18)
    res.update(state_arrays(a, "stage3_"))
    res["t"] = np.array([a.state.t])
    return res


def mesh_api() -> dict:
    """What the mesh constructors give on this rank of the 4-rank group:
    the refusals of meshes larger than the group, the host mesh's
    coordinate, a 2-rank sub-mesh's."""
    out = {}
    for name, fn in (("sim8", lambda: make_sim_mesh(8)),
                     ("sim2d_4x2", lambda: make_sim_mesh2d((4, 2))),
                     ("production", make_production_mesh)):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    out["host"] = make_host_mesh().get_coordinate()
    sub = make_sim_mesh(2)
    out["sub2"] = sub.get_coordinate()
    out["default"] = list(make_sim_mesh().shape)
    return out


def llm_batch(cfg, step: int) -> dict:
    """Round ``step``'s batch (K, P, local, seq) from the numpy stream of
    seed 0, as the launcher draws it."""
    rng = np.random.default_rng(0)
    q = QAFeLConfig(**LLM_Q)
    for _ in range(step + 1):
        batch = round_batch(cfg, q, rng, LLM_LOCAL, LLM_SEQ, "cpu")
    return batch


def llm_state(inputs, arch: str, r: int, mesh):
    """The reference's state before round ``r + 1`` (``llm_in.npz``) on
    ``mesh``'s segments; a ``SEEDED`` arch's the port's seed-0 state."""
    if arch in SEEDED:
        return TS.init_round_state(TC.get_reduced(arch), 0, "cpu", mesh)
    layout = TreeLayout.of(T.abstract_params(TC.get_reduced(arch)))
    trees = [layout.unflatten(torch.from_numpy(
        inputs[f"{arch}/r{r}/{n}"].copy())) for n in STATE]
    return TS.RoundState.on_mesh(*trees, mesh,
                                 t=int(inputs[f"{arch}/r{r}/t"]))


class _Largest(TorchDispatchMode):
    """Records the largest floating tensor an op makes, but this rank's
    shards (``shapes``, their gradients too) and the client's working copy
    (``numels``)."""

    def __init__(self, shapes, numels):
        super().__init__()
        self.shapes, self.numels = set(shapes), set(numels)
        self.numel, self.shape = 0, None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.numel() > self.numel
                    and tuple(t.shape) not in self.shapes
                    and t.numel() not in self.numels):
                self.numel, self.shape = t.numel(), list(t.shape)
        return out


def launcher_argv(ckpt) -> list:
    """``launch.train``'s command line of the launcher case: reduced
    gemma2-2b, 2 rounds, a checkpoint under ``ckpt``."""
    return ["--arch", "gemma2-2b", "--reduced", "--steps", "2", "--seq",
            str(LLM_SEQ), "--global-batch", "8", "--device", "cpu",
            "--checkpoint-dir", str(ckpt)]


def run_launcher(out: Path) -> dict:
    """``launch.train.run`` under the 4-rank group: the reference's host
    mesh, (1, 1) on rank 0 (the other ranks are outside it and return at
    once). Returns what this rank ran: its mesh coordinate, the losses,
    x's f32 bits as a list and the checkpoint's path."""
    from repro_torch.launch import train

    res = train.run(train.parse_args(launcher_argv(out / "ckpt_mesh")))
    state = res["state"]
    return {"coordinate": res["mesh"].get_coordinate(),
            "losses": res["losses"].tolist(),
            "x": None if state is None else
            state.flat[0].view(torch.int32).tolist(),
            "checkpoint": res["checkpoint"]}


def run_llm(inputs, out: Path) -> tuple:
    """Every ``LLM_CASES`` round from the reference's states, and on (2, 2)
    the server half fed the meshless round's messages: x, x-hat and m
    gathered to d, the losses, the wire bytes and the taps."""
    arrays, info = {}, {}
    for case, (arch, shape, rounds, remat) in LLM_CASES.items():
        cfg = TC.get_reduced(arch)
        mesh = make_sim_mesh2d(shape)
        fn = TS.make_qafel_round(cfg, QAFeLConfig(**LLM_Q), remat=remat,
                                 mesh=mesh, taps=case == LLM_TAPS)
        plan = fn.plan
        for r in range(rounds):
            state = llm_state(inputs, arch, r, mesh)
            watch = (case == LLM_WATCHED and r == 0
                     and dist.get_rank() == 0)
            mode = _Largest(plan.local_layout.shapes,
                            [plan.local_layout.total_size])
            args = (state, llm_batch(cfg, r), torch.from_numpy(LLM_WEIGHTS),
                    prng.PRNGKey(r))
            if watch:
                with mode:
                    state, met = fn(*args)
                info["largest"] = {
                    "numel": mode.numel, "shape": mode.shape,
                    "segment": plan.n_l, "leaf": max(plan.layout.sizes)}
            else:
                state, met = fn(*args)
            for name, f in zip(STATE, state.flat):
                arrays[f"{case}_{r + 1}_{name}"] = \
                    plan.gather(f)[:plan.d].numpy()
            info[f"{case}_{r + 1}"] = {
                "loss": float(met["loss"]), "t": state.t,
                "upload_bytes": met["upload_bytes"],
                "broadcast_bytes": met["broadcast_bytes"]}
            if "taps" in met:
                arrays[f"{case}_{r + 1}_taps"] = met["taps"].numpy()
    info["launcher"] = run_launcher(out)
    cfg = TC.get_reduced("gemma2-2b")
    mesh = make_sim_mesh2d((2, 2))
    plan = TS.MeshPlan(cfg, mesh)
    state = llm_state(inputs, "gemma2-2b", 0, mesh)
    uploads = [(torch.from_numpy(inputs[f"msg/upload{k}_packed"]),
                torch.from_numpy(inputs[f"msg/upload{k}_norms"]))
               for k in range(LLM_Q["buffer_size"])]
    (packed, norms), tap = TS.mesh_server_half(
        plan, state, uploads, torch.from_numpy(LLM_WEIGHTS),
        prng.split(prng.PRNGKey(0))[1], qcfg=QAFeLConfig(**LLM_Q),
        taps=True)
    for name, f in zip(STATE, state.flat):
        arrays[f"half_{name}"] = plan.gather(f)[:plan.d].numpy()
    arrays.update(half_packed=packed.numpy(), half_norms=norms.numpy(),
                  half_taps=tap.numpy())
    return arrays, info


def write_npz(path: Path, arrays: dict) -> None:
    """``np.savez`` to ``path``, which appears whole (written beside it,
    then renamed)."""
    tmp = path.with_name(path.name + ".part")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def wait_for(path, timeout: float = 600.0):
    """``path`` once it exists (the test writes ``llm_in.npz`` while the
    ranks run their flat mesh)."""
    t0 = time.time()
    while not Path(path).exists():
        if time.time() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.2)
    return path


def _rank(rank: int, world: int, port: int, out: str, llm: bool) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    out = Path(out)
    arrays, info = {}, {}
    try:
        info["mesh_api"] = [None] * world
        dist.all_gather_object(info["mesh_api"], mesh_api())
        for mname, make in MESHES.items():
            mesh = make()
            for k, v in run_flush(mesh).items():
                arrays[f"flush_{mname}_{k}"] = v
            for name in VARIANTS:
                a, i = run_variant(name, mesh)
                arrays.update({f"{name}_{mname}_{k}": v
                               for k, v in a.items()})
                info[f"{name}_{mname}"] = i
            arrays.update({f"cohort_{mname}_{k}": v
                           for k, v in run_cohort_step(mesh).items()})
            info[f"sim_{mname}"] = run_sim(mesh)
        arrays.update(run_reshard(out))
        if llm:
            with np.load(wait_for(out / "llm_in.npz")) as inputs:
                a, i = run_llm(inputs, out)
            arrays.update({f"llm_{k}": v for k, v in a.items()})
            info["llm"] = i
        if rank == 0:
            np.savez(out / "ranks.npz", **arrays)
            (out / "ranks.json").write_text(json.dumps(info))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    out = Path(argv[0])
    out.mkdir(parents=True, exist_ok=True)
    torch.multiprocessing.spawn(
        _rank, args=(WORLD, _free_port(), str(out), "--llm" in argv[1:]),
        nprocs=WORLD)


if __name__ == "__main__":
    main()
