"""Device-resident client population: the lifecycle state machine.

Counterpart of ``repro/kernels/population.py``. Every simulated client in
a slot is one row of a set of device tensors, and the event loop of the
async timeline — find the next completion, admit the next cohort, draw its
latencies, dropouts and tiers, update the deadline wheel and the staleness
bookkeeping — is one call per macro step (``kernels.ops.population_advance``)
that rewrites those tensors in place. This module holds its pieces:

* ``CompiledScenario`` — the frozen image of a ``sim.scenarios
  .ScenarioConfig`` at one concurrency (latency family and parameters,
  arrival process and calibrated rate, dropout, straggler and tier
  fractions).
* ``scenario_draws`` — the counter-hash draw law. Every random quantity of
  client ``cid`` is a function of ``(run seed, cid, channel)`` through the
  hash of the batched wire dither (``ref.counter_uniform``), so a client's
  draws do not depend on admission batching, concurrency or tiling. The
  transforms are XLA:CPU's f32 functions spelled in correctly rounded
  operations (``kernels.xla_math``), so the draws have the same bits on
  the card and the CPU, and the reference's jitted bits for every preset.
  Where XLA contracts the duration's last constant product into the
  deadline's add, so does ``advance`` (``_draws``' ``last``). Off the
  presets, poisson arrivals with a ``latency_scale`` other than 1 or with
  stragglers make XLA contract ``arrival + interarrival`` as well in some
  fusions, which the port does not follow (1 ulp on ``next_arrival``).
* ``advance`` — the macro-step body: EITHER admit one cohort of ``b``
  clients (when the arrival process has reached the next pending
  completion) OR pop up to ``d`` completions in deadline order (every
  wheel entry strictly earlier than the next un-admitted arrival).

**The branch is the host's.** The reference selects it on the device
(``lax.cond``). Here the host passes it in: the previous step's packed
output carries ``will_admit``, which is exactly this step's ``do_admit``
(and in the error case, a wanted admission without room, the reference
takes the deliver branch, which ``will_admit`` gives too); a fresh
population admits first. The device still computes ``admitted`` (its own
``do_admit``), ``will_admit`` and ``error`` as the reference does, and
the engines check that the branch taken equals ``admitted``.

**State machine** (int8 per slot): ``IDLE`` (0, free), ``WORKING`` (1,
training toward its deadline), ``OFFLINE`` (2, a dropout: the upload never
arrives, the slot is held until its nominal finish and then reaped without
a delivery), ``DROPPED`` (3, a reaped dropout's slot awaiting reuse). Slots
are recycled through a free stack.

**Deadline wheel**: a ``(buckets, bucket_width)`` f32 grid (``+inf`` =
empty) with a per-bucket min. A delivery pops the ``d`` smallest
deadlines, ties to the lower flat index (what a one-at-a-time argmin pop
gives): ``torch.topk`` of the unique int64 keys ``(f32 bits of the
deadline << 32) | flat index`` — deadlines are >= 0 or +inf, so their bits
order like their values — which is the same selection on both devices.

**Arrival times** are ``na + [0, cumsum(inter[:-1])]`` in XLA:CPU's
cumsum order (``xla_cumsum``): in-order sums of blocks of 16, the block
totals scanned the same way, each block offset by the exclusive total of
the blocks before it. Plain f32 adds in that order give XLA's bits on
both devices; neither device's ``torch.cumsum`` does.

**Fan-out**: non-dropped arrivals form an append-only sorted queue, and
the number of started clients at a delivery instant is one
``searchsorted``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.kernels import xla_math
from repro_torch.kernels.ref import MASK32, counter_uniform, fma_f32

IDLE, WORKING, OFFLINE, DROPPED = 0, 1, 2, 3
N_STATES = 4

# draw channels: each random quantity of a client hashes (seed, cid) under
# its own channel salt
_CH_ARRIVAL, _CH_DURATION, _CH_STRAGGLER, _CH_DROPOUT, _CH_TIER = range(5)

_SQRT2 = math.sqrt(2.0)
_SCAN_BLOCK = 16  # XLA:CPU's cumsum block (its reduce-window rewrite)


@dataclasses.dataclass(frozen=True)
class CompiledScenario:
    """One ``ScenarioConfig`` at a fixed concurrency: ``rate`` is the
    calibrated arrival rate (``ScenarioConfig.arrival_rate``)."""

    latency: str = "half_normal"
    latency_scale: float = 1.0
    lognormal_sigma: float = 1.0
    trace: Tuple[float, ...] = ()
    arrival: str = "constant"
    rate: float = 1.0
    dropout: float = 0.0
    straggler_frac: float = 0.0
    straggler_mult: float = 1.0
    tier_fracs: Tuple[float, ...] = ()


def run_seeds(seed: int) -> torch.Tensor:
    """The (2,) seed words keying every population draw of a run, as an
    int64 tensor of uint32 values on the host."""
    seed = int(seed)
    return torch.tensor([seed & MASK32, ((seed >> 32) ^ 0xA511E9B3) & MASK32],
                        dtype=torch.int64)


def _f32(v: float) -> float:
    return float(np.float32(v))


def _channel_uniform(seeds, channel: int, cids: torch.Tensor):
    """f32 uniforms in [0, 1), one per client id (int64 tensor), on
    ``channel``: the wire dither's counter hash keyed by the global id."""
    s0, s1 = (int(v) & MASK32 for v in seeds.tolist())
    salt = (channel + 1) * 0x7F4A7C15 & MASK32
    return counter_uniform(s0, s1 ^ salt, cids)


def scenario_draws(scn: CompiledScenario, seeds, cids: torch.Tensor):
    """All per-client draws of one admission, keyed only by (seed, cid).

    ``cids`` is an int64 tensor of client ids; returns ``(interarrivals,
    durations, dropouts, tiers)`` on its device: f32, f32, bool, int32.
    A comparison with a fraction compares with the fraction rounded to f32,
    as the reference's does."""
    return _draws(scn, seeds, cids)[:4]


def _draws(scn: CompiledScenario, seeds, cids: torch.Tensor):
    """``scenario_draws`` plus the last products of the interarrival and
    the duration, ``(u, m)`` with ``inter = u * m`` (``dur = u * m``), or
    None where the value does not end in a product. XLA:CPU contracts
    those products into the adds that consume them (read from its
    object code: one ``vfmadd`` in each fusion): ``arr[-1] + inter[-1] =
    fma(u[-1], m, arr[-1])`` for the next arrival and ``arrival + dur =
    fma(u, m, arrival)`` for the deadline."""
    cids = cids.to(torch.int64)
    shape, dev = cids.shape, cids.device
    rate = np.float32(scn.rate)
    inter_last = None
    if scn.arrival == "constant":
        inter = torch.full(shape, float(np.float32(1.0) / rate),
                           dtype=torch.float32, device=dev)
    else:  # poisson: XLA multiplies by the constant's f32 reciprocal
        ua = _channel_uniform(seeds, _CH_ARRIVAL, cids)
        inter_last = (-xla_math.log1p(-ua), float(np.float32(1.0) / rate))
        inter = inter_last[0] * inter_last[1]

    last = None
    if scn.latency == "trace":  # replay, cycled by global client id
        tr = torch.tensor(scn.trace, dtype=torch.float32, device=dev)
        dur = tr[cids % tr.numel()]
    else:
        ud = _channel_uniform(seeds, _CH_DURATION, cids)
        if scn.latency == "half_normal":  # |N(0,1)| quantile
            last = (xla_math.erfinv(ud), _f32(_SQRT2))
            dur = last[0] * last[1]
        elif scn.latency == "lognormal":  # mu = -sigma^2/2 -> mean 1
            s = scn.lognormal_sigma
            c = torch.full_like(ud, _f32(-0.5 * s * s))
            dur = xla_math.exp(fma_f32(xla_math.ndtri(ud), _f32(s), c))
        else:  # uniform U(0.5, 1.5)
            dur = ud + 0.5
    if scn.latency_scale != 1.0:  # XLA drops a product by 1 ...
        scale = _f32(scn.latency_scale)
        if last is None:
            last = (dur, scale)
        else:  # ... and folds a product of two constants
            last = (last[0], float(np.float32(last[1]) * np.float32(scale)))
        dur = last[0] * last[1]
    if scn.straggler_frac > 0.0:
        us = _channel_uniform(seeds, _CH_STRAGGLER, cids)
        mult = np.float32(scn.straggler_mult)
        slow = (dur * float(mult) if last is None
                else last[0] * float(np.float32(last[1]) * mult))
        dur = torch.where(us < _f32(scn.straggler_frac), slow, dur)
        last = None

    if scn.dropout > 0.0:
        drops = _channel_uniform(seeds, _CH_DROPOUT, cids) < _f32(scn.dropout)
    else:
        drops = torch.zeros(shape, dtype=torch.bool, device=dev)

    tiers = torch.full(shape, -1, dtype=torch.int32, device=dev)
    if scn.tier_fracs:
        ut = _channel_uniform(seeds, _CH_TIER, cids)
        lo = 0.0
        for j, frac in enumerate(scn.tier_fracs):
            tiers = torch.where((ut >= _f32(lo)) & (ut < _f32(lo + frac)),
                                torch.full_like(tiers, j), tiers)
            lo += frac
    return inter, dur, drops, tiers, inter_last, last


def _inorder_rows(x: torch.Tensor) -> torch.Tensor:
    """In-order prefix sums along the last dim, one f32 add per step."""
    cols = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., j])
    return torch.stack(cols, dim=-1)


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's inclusive f32 cumsum of a 1-D tensor: in order up to 16
    elements; beyond, blocks of 16 (zero-padded) scanned in order, their
    totals scanned by this same law, and each block offset by the
    inclusive total of the blocks before it."""
    n = x.numel()
    if n <= _SCAN_BLOCK:
        return _inorder_rows(x) if n else x
    nb = -(-n // _SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - n))
    inner = _inorder_rows(xp.reshape(nb, _SCAN_BLOCK))
    outer = xla_cumsum(inner[:, -1].contiguous())
    excl = torch.cat([torch.zeros_like(outer[:1]), outer[:-1]])
    return (excl[:, None] + inner).reshape(-1)[:n]


# ---------------------------------------------------------------------------
# Population state
# ---------------------------------------------------------------------------


def wheel_shape(capacity: int) -> Tuple[int, int]:
    """(buckets, bucket_width) for a ``capacity``-slot wheel: a near-square
    split."""
    w = max(8, int(math.ceil(math.sqrt(capacity))))
    nb = -(-capacity // w)
    return nb, w


# 0-dim fields of the state, with their dtypes
_SCALARS = (("sp", torch.int32), ("tail", torch.int32),
            ("next_arrival", torch.float32), ("next_cid", torch.int32),
            ("t", torch.float32), ("admitted", torch.int32),
            ("delivered", torch.int32), ("dropped", torch.int32),
            ("discarded", torch.int32), ("error", torch.int32))


def init_population(capacity: int, buckets: int, bucket_width: int,
                    queue_cap: int, device=None) -> Dict[str, torch.Tensor]:
    """A fresh population-state dict on ``device`` (default: the card).
    ``buckets * bucket_width >= capacity``; padding slots past
    ``capacity`` never enter the free stack."""
    p_pad = buckets * bucket_width
    if p_pad < capacity:
        raise ValueError(f"wheel {buckets}x{bucket_width} < capacity "
                         f"{capacity}")
    dev = resolve_device(device)
    inf = float("inf")
    counts = torch.zeros(N_STATES, dtype=torch.int32, device=dev)
    counts[IDLE] = capacity
    pop = {
        "deadline": torch.full((buckets, bucket_width), inf,
                               dtype=torch.float32, device=dev),
        "bucket_min": torch.full((buckets,), inf, dtype=torch.float32,
                                 device=dev),
        "state": torch.zeros(p_pad, dtype=torch.int8, device=dev),
        "stack": torch.arange(capacity, dtype=torch.int32, device=dev),
        "slot_version": torch.zeros(p_pad, dtype=torch.int32, device=dev),
        "slot_cid": torch.full((p_pad,), -1, dtype=torch.int32, device=dev),
        "slot_uploads": torch.zeros(p_pad, dtype=torch.int32, device=dev),
        "arrival_q": torch.full((queue_cap,), inf, dtype=torch.float32,
                                device=dev),
        "counts": counts,
    }
    for name, dtype in _SCALARS:
        pop[name] = torch.zeros((), dtype=dtype, device=dev)
    pop["sp"].fill_(capacity)
    return pop


def state_bytes(pop: Dict[str, torch.Tensor]) -> int:
    """Bytes of population state held on its device."""
    return sum(t.numel() * t.element_size() for t in pop.values())


# ---------------------------------------------------------------------------
# Packed macro-step output
# ---------------------------------------------------------------------------
# One macro step's outputs travel as two flat tensors, one f32 and one
# i32, both views of one int32 buffer, so the host reads a step with one
# device-to-host copy. Field order is the layout contract (the
# reference's); booleans travel as i32 and are re-cast on read.

_OUT_BOOL = frozenset(("admit_drops", "deliver_valid", "admitted",
                       "will_admit"))
_OUT_SCALAR = frozenset(("next_arrival", "next_finish", "t", "admitted",
                         "will_admit", "error", "admitted_total",
                         "delivered_total", "dropped_total",
                         "discarded_total"))


def _out_layout(b: int, d: int):
    """(f32 fields, i32 fields) of one macro-step output: name -> length,
    in packing order."""
    f32 = (("admit_arrivals", b), ("admit_durations", b), ("deliver_t", d),
           ("next_arrival", 1), ("next_finish", 1), ("t", 1))
    i32 = (("admit_cids", b), ("admit_slots", b), ("admit_tiers", b),
           ("admit_drops", b), ("deliver_slots", d), ("deliver_cids", d),
           ("deliver_nrec", d), ("deliver_tau", d), ("deliver_valid", d),
           ("state_counts", N_STATES), ("admitted", 1), ("will_admit", 1),
           ("error", 1), ("admitted_total", 1), ("delivered_total", 1),
           ("dropped_total", 1), ("discarded_total", 1))
    return f32, i32


class PackedStepOut(NamedTuple):
    """A macro step's packed output on the device: ``f32`` and ``i32`` are
    views of the one int32 buffer ``words``."""
    f32: torch.Tensor
    i32: torch.Tensor
    words: torch.Tensor


def pack_step_out(out: Dict[str, torch.Tensor], b: int,
                  d: int) -> PackedStepOut:
    """Pack one macro step's out dict into its two flat tensors."""
    f32l, i32l = _out_layout(b, d)
    nf = sum(n for _, n in f32l)
    ni = sum(n for _, n in i32l)
    dev = out["state_counts"].device
    words = torch.empty(nf + ni, dtype=torch.int32, device=dev)
    f32, i32 = words[:nf].view(torch.float32), words[nf:]
    torch.cat([out[k].to(torch.float32).reshape(-1) for k, _ in f32l],
              out=f32)
    torch.cat([out[k].to(torch.int32).reshape(-1) for k, _ in i32l],
              out=i32)
    return PackedStepOut(f32, i32, words)


class PopStepOut:
    """Host-side named view of one packed macro-step output: size-1 fields
    read as Python scalars, bool fields re-cast from their i32 form. Built
    from a ``PackedStepOut`` (one device-to-host copy of its buffer) or
    from a pair of host arrays ``(f32, i32)``."""

    def __init__(self, packed, b: int, d: int):
        f32l, i32l = _out_layout(b, d)
        if isinstance(packed, PackedStepOut):
            words = packed.words.cpu().numpy()
            nf = packed.f32.numel()
            self._f32, self._i32 = words[:nf].view(np.float32), words[nf:]
        else:
            self._f32 = np.asarray(packed[0], np.float32)
            self._i32 = np.asarray(packed[1], np.int32)
        self._slices = {}
        for arr, fields in ((self._f32, f32l), (self._i32, i32l)):
            off = 0
            for name, length in fields:
                self._slices[name] = (arr, off, length)
                off += length

    def __getitem__(self, name: str):
        arr, off, length = self._slices[name]
        if name in _OUT_SCALAR:
            v = arr[off]
            return bool(v) if name in _OUT_BOOL else v
        v = arr[off:off + length]
        return v.astype(bool) if name in _OUT_BOOL else v

    def __contains__(self, name) -> bool:
        return name in self._slices

    def keys(self):
        return self._slices.keys()


# ---------------------------------------------------------------------------
# The macro-step body
# ---------------------------------------------------------------------------

_CACHE: Dict[tuple, Dict[str, torch.Tensor]] = {}


def _consts(b: int, d: int, p_pad: int,
            dev: torch.device) -> Dict[str, torch.Tensor]:
    """Per-shape constants of the macro step, made once per device."""
    key = (b, d, p_pad, str(dev))
    c = _CACHE.get(key)
    if c is None:
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        c = {
            "ar_b": torch.arange(b, **i32),
            "ar_d": torch.arange(d, **i32),
            "flat_idx": torch.arange(p_pad, dtype=torch.int64, device=dev),
            "neg1_b": torch.full((b,), -1, **i32),
            "zero_bf": torch.zeros(b, **f32),
            "zero_bi": torch.zeros(b, **i32),
            "neg1_d": torch.full((d,), -1, **i32),
            "zero_df": torch.zeros(d, **f32),
            "zero_di": torch.zeros(d, **i32),
            "ones_b": torch.ones(b, **i32),
        }
        _CACHE[key] = c
    return c


def advance(pop: Dict[str, torch.Tensor], seeds, version: int,
            draws: Optional[Dict[str, torch.Tensor]], *, admitting: bool,
            scn: CompiledScenario, bucket_width: int, admit: int,
            deliver: int, queue_cap: int) -> Dict[str, torch.Tensor]:
    """One macro step on ``pop``, in place; returns its (unpacked) out
    dict. ``admitting`` is the host's branch (the last step's
    ``will_admit``; True on a fresh population). ``draws`` are host-fed
    ``{"inter", "dur", "drop", "tier"}`` tensors of ``(admit,)`` on the
    state's device, or None for the in-step counter-hash draws."""
    b, d, w, q = admit, deliver, bucket_width, queue_cap
    dev = pop["deadline"].device
    c = _consts(b, d, pop["state"].numel(), dev)
    na = pop["next_arrival"].clone()
    next_finish = pop["bucket_min"].min()
    want_admit = na <= next_finish
    room = (pop["sp"] >= b) & (pop["tail"] + b <= q)
    do_admit = want_admit & room
    inf = float("inf")

    if admitting:
        cids = pop["next_cid"] + c["ar_b"]
        if draws is not None:
            inter, dur = draws["inter"], draws["dur"]
            drops, tiers = draws["drop"], draws["tier"]
            inter_last = last = None
        else:
            inter, dur, drops, tiers, inter_last, last = _draws(scn, seeds,
                                                                cids)
        # member i arrives at base + the XLA-order sum of the first i
        # interarrivals
        arr = na + torch.cat([torch.zeros_like(inter[:1]),
                              xla_cumsum(inter[:-1])])
        pop["next_arrival"].copy_(
            arr[-1] + inter[-1] if inter_last is None
            else fma_f32(inter_last[0][-1], inter_last[1], arr[-1]))
        pop["sp"].sub_(b)
        slots = pop["stack"][(pop["sp"] + c["ar_b"]).long()].long()
        dl = arr + dur if last is None else fma_f32(last[0], last[1], arr)
        pop["deadline"].view(-1)[slots] = dl
        pop["bucket_min"].scatter_reduce_(0, slots // w, dl, "amin")
        prev_state = pop["state"][slots].long()
        new_state = torch.where(drops, OFFLINE, WORKING)
        pop["state"][slots] = new_state.to(torch.int8)
        pop["counts"].index_add_(0, prev_state, -c["ones_b"])
        pop["counts"].index_add_(0, new_state, c["ones_b"])
        pop["slot_version"].index_fill_(0, slots, int(version))
        pop["slot_cid"][slots] = cids
        # this cohort's non-dropped arrivals, sorted; dropped members sort
        # to +inf and the tail advances past the real entries only
        av = torch.sort(torch.where(drops, inf, arr)).values
        pop["arrival_q"][(pop["tail"] + c["ar_b"]).long()] = av
        n_drop = drops.sum().to(torch.int32)
        pop["tail"].add_(b - n_drop)
        pop["next_cid"].add_(b)
        pop["admitted"].add_(b)
        pop["dropped"].add_(n_drop)
        out = dict(admit_cids=cids, admit_arrivals=arr,
                   admit_durations=dur, admit_drops=drops,
                   admit_tiers=tiers, admit_slots=slots,
                   deliver_slots=c["neg1_d"], deliver_cids=c["neg1_d"],
                   deliver_t=c["zero_df"], deliver_valid=c["zero_di"],
                   deliver_nrec=c["zero_di"], deliver_tau=c["zero_di"])
    else:
        # the d smallest deadlines in ascending order, ties to the lower
        # flat index: one top-k over unique (deadline bits, index) keys
        flat = pop["deadline"].view(-1)
        keys = (flat.view(torch.int32).to(torch.int64) << 32) | c["flat_idx"]
        top = torch.topk(keys, d, largest=False, sorted=True).values
        slots = top & MASK32
        dls = (top >> 32).to(torch.int32).view(torch.float32)
        valid = dls < na
        vi = valid.to(torch.int32)
        st = pop["state"][slots].long()
        is_work = st == WORKING
        new_st = torch.where(is_work, IDLE, DROPPED)
        flat[slots] = torch.where(valid, inf, dls)
        torch.amin(pop["deadline"], dim=1, out=pop["bucket_min"])
        pop["state"][slots] = torch.where(valid, new_st, st).to(torch.int8)
        pop["counts"].index_add_(0, st, -vi)
        pop["counts"].index_add_(0, new_st, vi)
        # free-stack pushes in pop order: the valid lanes are a prefix, so
        # lane i pushes at sp + i; the other lanes write back what their
        # (distinct) positions hold
        pos = ((pop["sp"] + c["ar_d"]) % pop["stack"].numel()).long()
        pop["stack"][pos] = torch.where(valid, slots.to(torch.int32),
                                        pop["stack"][pos])
        is_real = valid & is_work
        # lane i's fan-out counts its own delivery, as a sequential pop
        delivered = pop["delivered"] + torch.cumsum(
            is_real.to(torch.int32), 0, dtype=torch.int32)
        started = torch.searchsorted(pop["arrival_q"], dls,
                                     right=True).to(torch.int32)
        nrec = torch.clamp(started - delivered, min=1)
        tau = int(version) - pop["slot_version"][slots]
        n_valid = vi.sum().to(torch.int32)
        t_max = torch.where(valid, dls, -inf).max()
        pop["t"].copy_(torch.where(n_valid > 0, t_max, pop["t"]))
        pop["sp"].add_(n_valid)
        pop["delivered"].copy_(delivered[-1])
        pop["discarded"].add_((valid & ~is_work).sum().to(torch.int32))
        pop["slot_uploads"].index_add_(0, slots, is_real.to(torch.int32))
        out = dict(admit_cids=c["neg1_b"], admit_arrivals=c["zero_bf"],
                   admit_durations=c["zero_bf"], admit_drops=c["zero_bi"],
                   admit_tiers=c["neg1_b"], admit_slots=c["neg1_b"],
                   deliver_slots=torch.where(valid, slots, -1),
                   deliver_cids=pop["slot_cid"][slots], deliver_t=dls,
                   deliver_valid=is_real, deliver_nrec=nrec,
                   deliver_tau=tau)

    pop["error"].bitwise_or_((want_admit & ~room).to(torch.int32))
    nf_new = pop["bucket_min"].min()
    will_admit = ((pop["next_arrival"] <= nf_new) & (pop["sp"] >= b)
                  & (pop["tail"] + b <= q))
    out.update(admitted=do_admit, will_admit=will_admit, error=pop["error"],
               next_arrival=pop["next_arrival"], next_finish=nf_new,
               t=pop["t"], state_counts=pop["counts"],
               admitted_total=pop["admitted"],
               delivered_total=pop["delivered"],
               dropped_total=pop["dropped"],
               discarded_total=pop["discarded"])
    return out
