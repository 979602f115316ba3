"""Prints how close the port's reduced QAFeL rounds come to the
reference's jitted round, with remat on (``torch.autograd.grad``) and off
(``torch.func.grad``): each round's share of x-hat bit-equal and x's
change and the momentum's L2 errors, as the round tests measure them
(their ``_rounds`` helpers: two rounds, one at a time from equal inputs,
``test_torch_llm_round.compare_rounds``; the MoE configs from the
reference's jitted init, as in tests/test_torch_moe_round.py). A
measurement for ROADMAP queue C, not a test; on the CPU, one torch
thread:

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/round_shares.py \
        [--silu port|F] [--seeds 0,1,2] [--local-sgd] [--self] [ARCH ...]

ARCH among qwen3-moe-235b-a22b, deepseek-v3-671b, qwen3-14b,
mamba2-1.3b, zamba2-7b (default: all five; the state-space models in
f32 and bf16). ``--silu`` picks the port's silu call sites: ``port`` as
they are (the reference's law, ``models.layers.silu``, at every site),
``F`` ``torch.nn.functional.silu`` at every site (the port before), for
comparison.
``--seeds`` runs the text configs' two rounds chained, each side's round
2 from its own round-1 state (the comparison the tests dropped), from
each batch seed instead (remat on) and prints both rounds' figures;
``--local-sgd``
prints, per seed, how far one client's local steps from the initial
state land from the reference's (``local_sgd_scan``, jitted): the share
of the parameters bit-equal and the L2 error relative to the reference's
change; ``--self`` runs the reference against itself from a state whose x and
x-hat differ in the last bit on 1% of the coordinates (batch seed 0),
the same figures: what the two-round comparison makes of such a
difference with no port in it."""
import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import qafel as JQ
from repro.distributed import steps as JS
from repro.models import transformer as JT
from repro_torch.common.tree import tree_leaves
from repro_torch.convert import params_from_jax
from repro_torch.core import qafel as TQ
from repro_torch.distributed import steps as TS
from repro_torch.models import layers, moe
from repro_torch.models import transformer as TT

import test_torch_archs_round as A
import test_torch_mamba2_round
from test_torch_llm_round import _flat_bits, round_figures

MOE = ("qwen3-moe-235b-a22b", "deepseek-v3-671b")
ALL = MOE + ("qwen3-14b", "mamba2-1.3b", "zamba2-7b")


def _use_f_silu() -> None:
    """The port's silu call sites on ``F.silu`` (the law before)."""
    f = torch.nn.functional.silu
    act = layers._act
    layers._act = lambda name: f if name == "silu" else act(name)
    moe.silu = f
    import repro_torch.models.mamba2 as mamba2
    mamba2.silu = f


def _stats(js, ts, jx0) -> dict:
    jh, th = _flat_bits(js.hidden), _flat_bits(ts.hidden)
    row = {"hidden_equal": float(np.mean(jh.view(np.int32)
                                         == th.view(np.int32)))}
    for name, base in (("x", jx0), ("momentum", 0.0)):
        a = _flat_bits(getattr(js, name)) - base
        b = _flat_bits(getattr(ts, name)) - base
        row[name] = float(np.linalg.norm(b.astype(np.float64) - a)
                          / np.linalg.norm(a))
    return row


def _line(s: dict) -> str:
    return (f"x-hat bit-equal {s['hidden_equal']:.4f}, x {s['x']:.3e}, "
            f"m {s['momentum']:.3e} (L2)")


def rounds_from_seed(arch: str, seed: int) -> list:
    """``test_torch_archs_round._rounds`` from batch seed ``seed``: each
    round's figures."""
    jc, tc = A.JC.get_reduced(arch), A.TC.get_reduced(arch)
    jq, tq = A.JConfig(**A.QCFG), A.QAFeLConfig(**A.QCFG)
    jround = jax.jit(JS.make_qafel_round(jc, jq, remat=False))
    tround = TS.make_qafel_round(tc, tq)
    jstate = JS.init_round_state(jc, jax.random.PRNGKey(0))
    tstate = A.round_state_from_jax(jax.device_get(jstate), device="cpu")
    jx0 = _flat_bits(jax.device_get(jstate.x))
    weights = np.array([0.9, 1.0, 0.7, 0.5], np.float32)
    rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
    k, p = A.QCFG["buffer_size"], A.QCFG["local_steps"]
    out = []
    for step in range(2):
        raw = A.jbatch(jc, rng_j, k * p * A.LOCAL, A.SEQ)
        jb = {n: jnp.asarray(v).reshape((k, p, A.LOCAL) + v.shape[1:])
              for n, v in raw.items()}
        jstate, _ = jround(jstate, jb, jnp.asarray(weights),
                           jax.random.PRNGKey(step))
        tb = A.train.round_batch(tc, tq, rng_t, A.LOCAL, A.SEQ, "cpu")
        tstate, _ = tround(tstate, tb, torch.from_numpy(weights),
                           A.prng.PRNGKey(step))
        out.append(_stats(jax.device_get(jstate), tstate, jx0))
    return out


def local_sgd_closeness(arch: str, seed: int) -> tuple:
    """One client's P local steps from the reference's initial parameters
    on a batch from ``seed``, both packages: (share bit-equal, L2 error
    over the reference's change)."""
    jc, tc = A.JC.get_reduced(arch), A.TC.get_reduced(arch)
    jp = JT.init_params(jc, jax.random.PRNGKey(0))
    lr, p = A.QCFG["client_lr"], A.QCFG["local_steps"]
    raw = A.jbatch(jc, np.random.default_rng(seed), p * A.LOCAL, A.SEQ)
    jb = {n: jnp.asarray(v).reshape((p, A.LOCAL) + v.shape[1:])
          for n, v in raw.items()}
    keys = jax.random.split(jax.random.PRNGKey(seed), p)
    jy, _ = jax.jit(lambda y, b, k: JQ.local_sgd_scan(
        lambda q, bb, kk: JT.loss_fn(jc, q, bb, remat=False)[0], lr, y, b,
        k))(jp, jb, keys)
    ref = np.concatenate([np.asarray(a).reshape(-1)
                          for a in jax.tree.leaves(jy)])
    y0 = np.concatenate([np.asarray(a).reshape(-1)
                         for a in jax.tree.leaves(jp)])
    ty, _ = TQ.local_sgd_scan(
        lambda q, bb, kk: TT.loss_fn(tc, q, bb, remat=False)[0], lr,
        params_from_jax(jax.device_get(jp), device="cpu"),
        {n: torch.from_numpy(np.asarray(v)) for n, v in jb.items()},
        torch.from_numpy(np.asarray(keys)))
    got = np.concatenate([t.detach().numpy().reshape(-1)
                          for t in tree_leaves(ty)])
    return (float(np.mean(got.view(np.int32) == ref.view(np.int32))),
            float(np.linalg.norm(got.astype(np.float64) - ref)
                  / np.linalg.norm(ref.astype(np.float64) - y0)))


def reference_against_itself(arch: str) -> list:
    """Two rounds of the reference's jitted round from its initial state
    and from that state with x and x-hat moved one ulp (away from 0) on a
    random 1% of the coordinates, on the same batches and keys: each
    round's figures, the perturbed run in the port's place."""
    jc = A.JC.get_reduced(arch)
    jround = jax.jit(JS.make_qafel_round(jc, A.JConfig(**A.QCFG),
                                         remat=False))
    state = JS.init_round_state(jc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)

    def nudge(a):
        a = np.asarray(a)
        flip = rng.random(a.shape) < 0.01
        return jnp.asarray(np.where(flip, np.nextafter(a, np.inf * np.sign(
            a + (a == 0))), a).astype(a.dtype))

    px = jax.tree.map(nudge, state.x)  # x-hat starts equal to x
    moved = state._replace(x=px, hidden=px)
    jx0 = _flat_bits(jax.device_get(state.x))
    weights = jnp.asarray(np.array([0.9, 1.0, 0.7, 0.5], np.float32))
    batches = np.random.default_rng(0)
    k, p = A.QCFG["buffer_size"], A.QCFG["local_steps"]
    out = []
    for step in range(2):
        raw = A.jbatch(jc, batches, k * p * A.LOCAL, A.SEQ)
        jb = {n: jnp.asarray(v).reshape((k, p, A.LOCAL) + v.shape[1:])
              for n, v in raw.items()}
        key = jax.random.PRNGKey(step)
        state, _ = jround(state, jb, weights, key)
        moved, _ = jround(moved, jb, weights, key)
        out.append(_stats(jax.device_get(state), jax.device_get(moved), jx0))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*", default=list(ALL))
    ap.add_argument("--silu", choices=("port", "F"), default="port")
    ap.add_argument("--seeds", type=lambda s: [int(v) for v in s.split(",")])
    ap.add_argument("--local-sgd", action="store_true")
    ap.add_argument("--self", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    if args.silu == "F":
        _use_f_silu()
    make = TS.make_qafel_round
    init_params, init_state = JT.init_params, JS.init_round_state
    for arch in args.archs:
        if arch in MOE:
            JT.init_params = jax.jit(init_params, static_argnums=0)
            JS.init_round_state = jax.jit(init_state, static_argnums=0)
        tag = f"{arch} silu={args.silu}"
        if args.self:
            for r, st in enumerate(reference_against_itself(arch), 1):
                print(f"{arch} reference against itself, round {r}: "
                      f"{_line(st)}", flush=True)
        elif args.seeds is not None:
            for seed in args.seeds:
                if args.local_sgd:
                    eq, rel = local_sgd_closeness(arch, seed)
                    print(f"{tag} seed {seed}: local steps bit-equal "
                          f"{eq:.4f}, L2 {rel:.3e}", flush=True)
                    continue
                for r, s in enumerate(rounds_from_seed(arch, seed), 1):
                    print(f"{tag} seed {seed} round {r}: {_line(s)}",
                          flush=True)
        else:
            for remat in (True, False):
                TS.make_qafel_round = functools.partial(make, remat=remat)
                if arch.startswith(("mamba2", "zamba2")):
                    runs = {dt: test_torch_mamba2_round._rounds(arch, dt)
                            for dt in ("float32", "bfloat16")}
                else:
                    runs = {"float32": A._rounds(arch)}
                for dtype, out in runs.items():
                    for r, rec in enumerate(out["rounds"], 1):
                        s = round_figures(rec)
                        s["hidden_equal"] = s.pop("hidden")
                        print(f"{tag} {dtype} remat={remat} round {r}: "
                              f"{_line(s)}", flush=True)
            TS.make_qafel_round = make
        JT.init_params, JS.init_round_state = init_params, init_state


if __name__ == "__main__":
    main()
