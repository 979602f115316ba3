"""The tap kernels' work mapping (``csrc/tap_reduce.cuh``, and the code
words of ``csrc/upload_taps.cu``) spelled in Python on the CPU, against
the plain law, bit for bit.

The kernels sum in XLA:CPU's order (``ref.tap_sum``: windows of 32 with
the padding split, recursively), but map the work their own way: a warp
sums a span of 1,024 values (one level-1 window) lane by lane, a unit of
the short plan is 4 consecutive spans, a unit of the long plan one
level-2 window of 32 spans (level 2's padding added to the offset), units
go to the blocks of a persistent grid in turn, and the block that ends a
row runs the levels above the units' sums. This file spells that mapping
(the constants read from the header) and holds both plans to
``ref.tap_sum`` at the lengths where a level's padding changes; and the
upload's decode from a span's staged code words (one funnel shift a
warp, two scales a lane) to ``ref.signed_magnitudes``. No card: the
kernels themselves are held to the plain versions at these lengths in
tests/test_torch_kernels_card.py and by ``chip_smoke.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

HEADER = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "tap_reduce.cuh").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr (?:int|long long) {name} = (\d+);",
                         HEADER).group(1))


WINDOW, WARPS = _const("kWindow"), _const("kWarps")
LONG_SPANS, SPAN = WINDOW // WARPS, WINDOW * WINDOW
LONG_MIN_SPANS = _const("kLongMinSpans")
# where a level's padding changes: around 32, 1,024 and 32,768 values, the
# CNN's n, past 2^20 and past 32 level-2 windows
LENGTHS = (1, 31, 33, 1_023, 1_025, 32_767, 32_768, 32_769, 79_842,
           1_048_577, 32 * 32_768 + 5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The module's tests on one torch thread, restored after (the suite
    runs six workers on the CPU's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _front_pad(m: int) -> int:
    return 0 if m <= WINDOW else (_cdiv(m, WINDOW) * WINDOW - m) // 2


def plan_of(n: int, rows: int, long_rows=None) -> dict:
    """``tap_reduce.cuh``'s ``plan_of`` (``long_rows`` forces a plan)."""
    l0 = _cdiv(n, WINDOW)
    l1 = _cdiv(l0, WINDOW)
    if long_rows is None:
        long_rows = l1 >= 2 * WINDOW and rows * l1 >= LONG_MIN_SPANS
    plan = dict(n=n, l1=l1, l1_off=_front_pad(n) + WINDOW * _front_pad(l0),
                long=long_rows)
    if long_rows:
        plan.update(l2_pad=_front_pad(l1), units=_cdiv(l1, WINDOW))
    else:
        plan.update(l2_pad=0, units=_cdiv(l1, WARPS))
    return plan


def _in_order(t: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(t.shape[:-1], dtype=t.dtype)
    for j in range(t.shape[-1]):
        acc = acc + t[..., j]
    return acc


def unit_windows(plan: dict) -> torch.Tensor:
    """The level-1 window each span of each unit takes: (units, spans),
    spans in the order the unit adds them (warp w's t-th span of a long
    unit is its w * 8 + t-th)."""
    u = torch.arange(plan["units"])[:, None]
    if plan["long"]:
        w = torch.arange(WARPS)[:, None] * LONG_SPANS + torch.arange(
            LONG_SPANS)
        return u * WINDOW - plan["l2_pad"] + w.reshape(1, -1)
    return u * WARPS + torch.arange(WARPS)[None]


def kernel_sum(sq: torch.Tensor, plan: dict) -> torch.Tensor:
    """The sum of the f32 values ``sq`` as the tap kernels take it."""
    j = unit_windows(plan)
    live = (j >= 0) & (j < plan["l1"])
    base = j * SPAN - plan["l1_off"]
    # the span from value base, 0 outside [0, n): rows of a zero-padded copy
    pad = 2 * SPAN
    spans = torch.nn.functional.pad(sq, (pad, pad)).unfold(0, SPAN, 1)
    vals = torch.where(live[..., None],
                       spans[(base + pad).clamp(0, spans.shape[0] - 1)],
                       torch.zeros(()))
    # lane l sums values [32 l, 32 l + 32) of the span in order, then
    # lanes 0..S-1 the 32 lane sums in order: the level-1 sum
    level1 = _in_order(_in_order(vals.reshape(*j.shape, WINDOW, WINDOW)))
    if plan["long"]:
        sums = _in_order(level1)  # the block adds its 32 spans in order
    else:
        sums = level1[live]  # live spans in order of their window
    assert sums.numel() == (plan["units"] if plan["long"] else plan["l1"])
    # the tail: each level's windows, then the top in order
    m = sums.numel()
    while m > WINDOW:
        windows, pad = _cdiv(m, WINDOW), _front_pad(m)
        idx = torch.arange(windows)[:, None] * WINDOW + torch.arange(
            WINDOW) - pad
        ok = (idx >= 0) & (idx < m)
        sums = _in_order(torch.where(ok, sums[idx.clamp(0, m - 1)],
                                     torch.zeros(())))
        m = windows
    return _in_order(sums[None])[0]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.int32)


@pytest.mark.parametrize("n", LENGTHS)
def test_both_plans_sum_in_the_reference_order(n):
    """Squares of N(0, 1) values (and values spread over ten orders of
    magnitude, where every rounding shows) through the short and the long
    plan, bit for bit with ``ref.tap_sum``."""
    rng = np.random.default_rng(n)
    for scale in (np.ones(n), 10.0 ** rng.uniform(-5, 5, n)):
        x = torch.from_numpy((rng.standard_normal(n) * scale)
                             .astype(np.float32))
        want = ref.tap_sum(x * x)
        for long_rows in (False, True):
            got = kernel_sum(x * x, plan_of(n, 1, long_rows))
            assert _bits(got) == _bits(want), (n, long_rows)


@pytest.mark.parametrize("n,rows", ((1, 1), (79_842, 1), (79_842, 32),
                                    (1_048_577, 1), (1_048_577, 8),
                                    (100_000_000, 1), (32 * 32_768 + 5, 8)))
def test_plan_and_ownership(n, rows):
    """Which plan a launch takes (long rows from 8,192 level-1 windows in
    all and 64 a row), its offsets, and a persistent grid of any size
    giving every unit of every row to exactly one block; a long unit's
    32 windows are level 2's window: consecutive, from ``32 u - pad``."""
    plan = plan_of(n, rows)
    l1 = _cdiv(n, SPAN)
    assert plan["l1"] == l1
    assert plan["long"] == (l1 >= 64 and rows * l1 >= LONG_MIN_SPANS)
    j = unit_windows(plan)
    if plan["long"]:
        assert plan["l1_off"] + SPAN * plan["l2_pad"] == (
            _front_pad(n) + WINDOW * _front_pad(_cdiv(n, WINDOW))
            + SPAN * _front_pad(l1))
        assert torch.equal(j[:, 1:] - j[:, :-1], torch.ones(
            plan["units"], WINDOW - 1, dtype=torch.int64))
        assert plan["units"] == _cdiv(n, WINDOW * SPAN)
    live = j[(j >= 0) & (j < l1)]
    assert torch.equal(live, torch.arange(l1))  # each window once, in order
    total = rows * plan["units"]
    for grid in (1, 7, 132, total):
        owned = sorted(g for b in range(min(grid, total))
                       for g in range(b, total, min(grid, total)))
        assert owned == list(range(total))


def _words(packed: torch.Tensor) -> np.ndarray:
    """A message's codes as little-endian 32-bit words."""
    return np.ascontiguousarray(packed.numpy()).reshape(-1).view("<u4")


@pytest.mark.parametrize("bits", (2, 4, 8))
@pytest.mark.parametrize("d", (79_842, 1_025, 300))
def test_upload_decode_from_staged_words(bits, d):
    """``upload_taps.cu``'s decode of value e0 + k of lane l from its span's
    staged words: words from floor(base * bits / 32) staged with one pad
    every 32, lane l's bits + 1 from index l * bits, shifted right by
    (base * bits) mod 32 (a funnel shift), code k at bit k * bits of
    them; and its scale, that of row floor((e0 + 31) / 128) from the
    first index of that row, else of row floor(e0 / 128). Held to
    ``ref.signed_magnitudes`` and the row norms for every value of every
    span a message has, the spans of the front padding included."""
    rng = np.random.default_rng(bits * d)
    rows = ref.rows_for(d)
    packed = torch.from_numpy(rng.integers(0, 256, (rows, 16 * bits),
                                           dtype=np.uint8))
    sm = ref.signed_magnitudes(packed, bits).reshape(-1).numpy()
    norms = rng.uniform(0.1, 2.0, rows).astype(np.float32)
    words = _words(packed).astype(np.uint64)
    code_words = WINDOW * bits + 1
    mask, mag_mask = (1 << bits) - 1, (1 << (bits - 1)) - 1
    plan = plan_of(d, 1, False)
    for j in range(plan["l1"]):
        base = j * SPAN - plan["l1_off"]
        w0 = (base * bits) >> 5
        wi = w0 + np.arange(code_words)
        ok = (wi >= 0) & (wi < words.size)
        staged = np.zeros(code_words + code_words // 32 + 1, np.uint64)
        slots = np.arange(code_words)
        staged[slots + slots // 32] = np.where(
            ok, words[np.clip(wi, 0, words.size - 1)], 0)
        r = (base >> 7) + np.arange(9)
        nm = np.where((r >= 0) & (r < rows), norms[np.clip(r, 0, rows - 1)],
                      0.0)
        shift = (base * bits) & 31
        for lane in range(WINDOW):
            e0 = base + WINDOW * lane
            idx = lane * bits + np.arange(bits + 1)
            wv = staged[idx + idx // 32]
            aw = ((wv[1:] << 32 | wv[:-1]) >> shift) & 0xFFFFFFFF
            k = np.arange(WINDOW)
            code = (aw[k * bits // 32] >> (k * bits % 32).astype(np.uint64)
                    ) & mask
            mag = (code & mag_mask).astype(np.float32)
            got = np.where(code >> (bits - 1) != 0, -mag, mag)
            rb = (e0 + WINDOW - 1) >> 7
            scale = np.where(k >= rb * 128 - e0, nm[rb - (base >> 7)],
                             nm[(e0 >> 7) - (base >> 7)])
            e = e0 + k
            inside = (e >= 0) & (e < d)
            assert np.array_equal(got[inside], sm[e[inside]]), (j, lane)
            assert np.array_equal(scale[inside], norms[e[inside] // 128])
