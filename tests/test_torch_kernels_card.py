"""The CUDA kernels against their plain PyTorch versions, on the card:
codes, norms and f32 values bit for bit (signed zeros included), and one
launch counted per call. The metric-tap kernels also against the plain
versions on the CPU, which is what the CPU tests hold to the reference. Needs a CUDA device and nvcc; without a device
every case skips with the reason. Imports no JAX, so it runs where the
port runs:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as tkernels
from repro_torch.common import prng
from repro_torch.kernels import ref

BITS = (2, 4, 8)
# key words on both sides of 2**31: a uint32 argument must not sign-extend
KEYS = ((0, 0), (0x80000000, 0xFFFFFFFF), (0xDEADBEEF, 0x9E3779B9))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _inputs(kernel, bits, rows, k, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((rows, 128)) * 0.1)
                         .astype(np.float32))
    x[rows // 2] = 0.0  # an all-zero bucket
    if kernel == "qsgd_quantize_pack":
        return (x, prng.uniform(prng.PRNGKey(seed), (rows, 128)), bits)
    if kernel == "qsgd_quantize_pack_threefry":
        return (x.reshape(-1), torch.tensor(KEYS[1]), bits)
    if kernel == "qsgd_quantize_pack_batch":
        return (x[None].repeat(2, 1, 1) * torch.tensor([1.0, -3.0])[:, None, None],
                prng.split(prng.PRNGKey(seed), 2), bits)
    p, nm = ref.quantize_pack_batch(
        x[None].repeat(k, 1, 1), prng.split(prng.PRNGKey(seed), k), bits)
    if kernel == "qsgd_unpack_dequantize":
        return (p[0], nm[0], bits)
    w = torch.from_numpy(rng.uniform(0.01, 0.2, k).astype(np.float32))
    return (p, nm, w, bits)


_WRAPPERS = {
    "qsgd_quantize_pack": (tkernels.qsgd.qsgd_quantize_pack, ref.quantize_pack),
    "qsgd_quantize_pack_threefry": (tkernels.qsgd.qsgd_quantize_pack_threefry,
                                    ref.quantize_pack_threefry),
    "qsgd_quantize_pack_batch": (tkernels.qsgd.qsgd_quantize_pack_batch,
                                 ref.quantize_pack_batch),
    "qsgd_unpack_dequantize": (tkernels.qsgd.qsgd_unpack_dequantize,
                               ref.unpack_dequantize),
    "buffer_aggregate": (tkernels.buffer_agg.buffer_aggregate,
                         ref.buffer_aggregate),
}


def _assert_bits_equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:  # bit patterns: signed zeros too
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", sorted(_WRAPPERS))
@pytest.mark.parametrize("bits", BITS)
def test_kernel_matches_plain_on_card(kernel, bits):
    dev = _card()
    wrapper, plain = _WRAPPERS[kernel]
    for rows, k in ((1, 1), (624, 10), (1000, 3)):
        args = [a.to(dev) if isinstance(a, torch.Tensor) else a
                for a in _inputs(kernel, bits, rows, k)]
        before = tkernels.launches()[kernel]
        got = wrapper(*args)
        torch.cuda.synchronize()
        assert tkernels.launches()[kernel] == before + 1
        _assert_bits_equal(got, plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("key", KEYS)
def test_threefry_quantize_ragged_messages(bits, key):
    """The in-kernel dither on ragged lengths (the kernel pads the last row
    itself), an all-zero bucket and keys with high words set."""
    dev = _card()
    rng = np.random.default_rng(bits)
    for n in (1, 127, 129, 79_842, 128 * 1001 - 5):
        x = torch.from_numpy((rng.standard_normal(n) * 0.1).astype(np.float32))
        x[128:256] = 0.0
        x, k = x.to(dev), torch.tensor(key)
        before = tkernels.launches()["qsgd_quantize_pack_threefry"]
        got = tkernels.qsgd.qsgd_quantize_pack_threefry(x, k, bits)
        torch.cuda.synchronize()
        assert tkernels.launches()["qsgd_quantize_pack_threefry"] == before + 1
        _assert_bits_equal(got, ref.quantize_pack_threefry(x, k, bits))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("k", (1, 3, 10, 33))
def test_buffer_aggregate_every_k(bits, k):
    """K = 1 (the folded product keeps -0.0), K inside the unrolled range
    and K = 33 (stages of 8, then the remainder), on odd row counts on both
    sides of the switch from one code word per thread to 16-byte vectors
    (40,001 rows fill an H100 four blocks per SM at every bit width). The
    codes are random bytes: every byte is a valid pair, quad or octet of
    codes, signed zeros included."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(bits * 100 + k)
    for rows in (1, 625, 1001, 40_001):
        p = torch.randint(0, 256, (k, rows, 16 * bits), generator=gen,
                          device=dev, dtype=torch.uint8)
        nm = torch.rand((k, rows), generator=gen, device=dev) * 3.0
        nm[:, rows // 2] = 0.0  # an all-zero bucket
        w = torch.rand(k, generator=gen, device=dev) / k
        before = tkernels.launches()["buffer_aggregate"]
        got = tkernels.buffer_agg.buffer_aggregate(p, nm, w, bits)
        torch.cuda.synchronize()
        assert tkernels.launches()["buffer_aggregate"] == before + 1
        want = ref.buffer_aggregate(p, nm, w, bits)
        _assert_bits_equal(got, want)
        if k == 1:
            assert bool((want.view(torch.int32) == -2**31).any())  # a -0.0


@pytest.mark.gpu
def test_misaligned_inputs_raise():
    dev = _card()
    flat = torch.zeros(1025, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):
        tkernels.qsgd.qsgd_quantize_pack_threefry(flat, prng.PRNGKey(0), 4)
    stack = torch.zeros(2 * 64 + 1, dtype=torch.uint8, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):
        tkernels.buffer_agg.buffer_aggregate(
            stack.reshape(2, 1, 64), torch.ones(2, 1, device=dev),
            torch.ones(2, device=dev), 4)
    with pytest.raises(ValueError, match="aligned"):
        tkernels.qsgd.qsgd_unpack_dequantize(
            stack[:64].reshape(1, 64), torch.ones(1, device=dev), 4)
    with pytest.raises(ValueError, match="aligned"):
        tkernels.qsgd.qsgd_quantize_pack_batch_flat(
            flat.reshape(1, -1), prng.split(prng.PRNGKey(0), 1), 4)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", BITS)
def test_unpack_dequantize_random_codes(bits):
    """The broadcast decode on random code bytes (every code, -0.0
    included) on odd row counts on both sides of the switch from one code
    word per thread to 16-byte vectors, as the aggregate's test does."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(bits)
    for rows in (1, 625, 1001, 40_001):
        p = torch.randint(0, 256, (rows, 16 * bits), generator=gen,
                          device=dev, dtype=torch.uint8)
        nm = torch.rand(rows, generator=gen, device=dev) * 3.0
        nm[rows // 2] = 0.0  # an all-zero bucket
        before = tkernels.launches()["qsgd_unpack_dequantize"]
        got = tkernels.qsgd.qsgd_unpack_dequantize(p, nm, bits)
        torch.cuda.synchronize()
        assert tkernels.launches()["qsgd_unpack_dequantize"] == before + 1
        want = ref.unpack_dequantize(p, nm, bits)
        _assert_bits_equal(got, want)
        assert bool((want.view(torch.int32) == -2**31).any())  # a -0.0


@pytest.mark.gpu
@pytest.mark.parametrize("bits", BITS)
def test_unpack_dequantize_eager_random_codes(bits):
    """K3's eager variant (``norm / s``) against its plain version, on the
    shapes of the fused decode's test."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(bits + 10)
    for rows in (1, 625, 1001, 40_001):
        p = torch.randint(0, 256, (rows, 16 * bits), generator=gen,
                          device=dev, dtype=torch.uint8)
        nm = torch.rand(rows, generator=gen, device=dev) * 3.0
        got = tkernels.qsgd.qsgd_unpack_dequantize(p, nm, bits, eager=True)
        want = ref.unpack_dequantize(p, nm, bits, eager=True)
        _assert_bits_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", BITS)
def test_unpack_dequantize_accumulate_random_codes(bits):
    """K3 with an accumulator (``fma(sign*mag, scale, acc)``, the round's
    fused x-hat + q) against its plain version, accumulators shorter than
    the rows (a ragged message) and as long; one launch per call."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(bits + 20)
    for rows, n in ((1, 100), (625, 79_842), (1001, 1001 * 128),
                    (40_001, 40_001 * 128 - 5)):
        p = torch.randint(0, 256, (rows, 16 * bits), generator=gen,
                          device=dev, dtype=torch.uint8)
        nm = torch.rand(rows, generator=gen, device=dev) * 3.0
        acc = torch.randn(n, generator=gen, device=dev)
        old = acc.clone()
        want = ref.unpack_dequantize(p, nm, bits, acc=acc).reshape(-1)[:n]
        before = tkernels.launches()["qsgd_unpack_dequantize"]
        got = tkernels.qsgd.qsgd_unpack_dequantize(p, nm, bits, acc=acc)
        torch.cuda.synchronize()
        assert tkernels.launches()["qsgd_unpack_dequantize"] == before + 1
        assert got is acc
        _assert_bits_equal(got, want)
        assert not torch.equal(got, old)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", BITS)
def test_unpack_dequantize_weighted_accumulate_random_codes(bits):
    """K3 with an accumulator and a weight (``fma(sign*mag * scale, w,
    acc)``, the round's ``buf + w_k * dec``) against its plain version;
    one launch per call."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(bits + 30)
    for rows, n in ((1, 100), (625, 79_842), (40_001, 40_001 * 128 - 5)):
        p = torch.randint(0, 256, (rows, 16 * bits), generator=gen,
                          device=dev, dtype=torch.uint8)
        nm = torch.rand(rows, generator=gen, device=dev) * 3.0
        acc = torch.randn(n, generator=gen, device=dev)
        w = torch.rand(1, generator=gen, device=dev)
        want = ref.unpack_dequantize(p, nm, bits, acc=acc,
                                     weight=w).reshape(-1)[:n]
        unweighted = ref.unpack_dequantize(p, nm, bits,
                                           acc=acc).reshape(-1)[:n]
        before = tkernels.launches()["qsgd_unpack_dequantize"]
        got = tkernels.qsgd.qsgd_unpack_dequantize(p, nm, bits, acc=acc,
                                                   weight=w)
        torch.cuda.synchronize()
        assert tkernels.launches()["qsgd_unpack_dequantize"] == before + 1
        assert got is acc
        _assert_bits_equal(got, want)
        assert not torch.equal(got, unweighted)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("b", (1, 3, 8, 65))
def test_quantize_batch_every_shape(bits, b):
    """The batched encode with seed words >= 2**31, by value (B <= 64) and
    from a device buffer (B = 65), on flat messages whose lengths leave the
    last row ragged and, for odd messages, the start unaligned (the kernel
    pads and copies such rows itself); row counts that end inside a warp's
    8-row tile; all-zero rows, an all-zero message and -0.0 elements; and
    enough tiles (B = 3 at 40,001 rows: over six per warp of the persistent
    grid) that every warp refills each of its three buffers. Each message's
    codes are the same alone as inside the batch."""
    dev = _card()
    rng = np.random.default_rng(bits * 1000 + b)
    seeds = torch.from_numpy(
        rng.integers(2**31, 2**32, (b, 2), dtype=np.uint64).astype(np.int64))
    sizes = [1, 127, 128 * 8 + 5, 79_842]
    if b == 3:
        sizes += [128 * 40_001 - 3, 128 * 40_001]
    for n in sizes:
        x = torch.from_numpy((rng.standard_normal((b, n)) * 0.1)
                             .astype(np.float32))
        x[:, 128:256] = 0.0  # an all-zero bucket
        x[:, 5::97] = -0.0
        if b > 1:
            x[-1] = 0.0  # an all-zero message
        x = x.to(dev)
        before = tkernels.launches()["qsgd_quantize_pack_batch"]
        got = tkernels.qsgd.qsgd_quantize_pack_batch_flat(x, seeds, bits)
        torch.cuda.synchronize()
        assert tkernels.launches()["qsgd_quantize_pack_batch"] == before + 1
        x3d = ref.rows2d(x)
        want = ref.quantize_pack_batch(x3d, seeds, bits)
        _assert_bits_equal(got, want)
        _assert_bits_equal(
            tkernels.qsgd.qsgd_quantize_pack_batch(x3d, seeds, bits), want)
        for i in {0, b - 1}:
            alone = tkernels.qsgd.qsgd_quantize_pack_batch_flat(
                x[i:i + 1].clone(), seeds[i:i + 1], bits)
            _assert_bits_equal((alone[0][0], alone[1][0]),
                               (got[0][i], got[1][i]))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", (2, 4))
def test_cohort_step_card_equals_cpu(bits):
    """``ops.cohort_train_encode_step`` on the quad task (d = 2048) at
    b = 4: the vmapped local SGD on the card, then one K2 launch, gives
    the CPU path's codes and norms bit for bit."""
    import functools

    from repro_torch.core import QAFeLConfig
    from repro_torch.core.qafel import client_update
    from repro_torch.core.quantizers import flatten_tree
    from repro_torch.examples import cohort_scenarios
    from repro_torch.kernels import ops

    dev = _card()
    b = 4
    wstar = cohort_scenarios.quad_optimum()
    targets = torch.from_numpy(
        cohort_scenarios.quad_targets(wstar, range(b)))
    keys = prng.split_each(prng.split(prng.PRNGKey(bits), b))
    cfg = QAFeLConfig(client_lr=0.05, local_steps=2)
    out = {}
    for d in ("cpu", dev):
        flat, layout = flatten_tree({"w": torch.from_numpy(wstar * 0.3)}, d)
        before = tkernels.launches()["qsgd_quantize_pack_batch"]
        member = functools.partial(client_update, cohort_scenarios.quad_loss,
                                   cfg, layout)
        out[str(d)] = ops.cohort_train_encode_step(
            member, flat, {"target": targets.to(d)}, keys[:, 0], keys[:, 1],
            b=b, bits=bits)
        if d != "cpu":
            torch.cuda.synchronize()
            assert tkernels.launches()["qsgd_quantize_pack_batch"] == \
                before + 1
    card = out[str(dev)]
    _assert_bits_equal((card["packed"].cpu(), card["norms"].cpu()),
                       (out["cpu"]["packed"], out["cpu"]["norms"]))


def _taps_equal_on_card_and_cpu(kernel, wrapper, plain, args):
    """One launch of the tap kernel ``kernel`` on the card's copies of
    ``args`` (CPU tensors or None), bit-equal to the plain version on the
    card and on the CPU; returns the result."""
    dev = _card()
    card_args = [a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in args]
    before = tkernels.launches()[kernel]
    got = wrapper(*card_args)
    torch.cuda.synchronize()
    assert tkernels.launches()[kernel] == before + 1
    _assert_bits_equal(got, plain(*card_args))
    _assert_bits_equal(got.cpu(), plain(*args))
    return got


def _flush_vectors(n, seed, identity=False, zero_diff=False):
    rng = np.random.default_rng(seed)
    v = [torch.from_numpy((rng.standard_normal(n) * s).astype(np.float32))
         for s in (1.0, 1.0, 0.02, 0.05, 0.05)]
    v[1] = v[0] + v[1] * 0.01
    if zero_diff:
        v[3] = torch.zeros(n)
        v[4] = torch.zeros(n)
    if identity:
        v[4] = v[3].clone()
    return v


@pytest.mark.gpu
@pytest.mark.parametrize("n", (1, 307, 79_842, 3 * 4096 + 77, 257 * 4096 + 5))
@pytest.mark.parametrize("k", (0, 1, 10))
def test_flush_taps_match_plain_on_card(n, k):
    """The flush taps at the CNN's n, lengths around and past the chunk
    and past 256 chunks (the second level's lanes wrap), with 0, 1 and 10
    weights; an identity broadcast (q = diff) gives a relative error of
    exactly 0, and a zero diff gives 0, not NaN."""
    rng = np.random.default_rng(k)
    w = (None if k == 0 else
         torch.from_numpy(rng.uniform(0.01, 0.3, k).astype(np.float32)))
    for identity, zero in ((False, False), (True, False), (False, True)):
        got = _taps_equal_on_card_and_cpu(
            "flush_taps", tkernels.taps.flush_taps, ref.flush_taps,
            (*_flush_vectors(n, n + k, identity, zero), w))
        if identity or zero:
            assert got[3].item() == 0.0
        assert bool(torch.isfinite(got).all())


@pytest.mark.gpu
@pytest.mark.parametrize("bits", (*BITS, None))
@pytest.mark.parametrize("b,d", ((1, 79_842), (32, 79_842), (3, 4097),
                                 (65, 300), (2, 257 * 4096 + 5)))
def test_upload_taps_match_plain_on_card(b, d, bits):
    """The upload taps over a stack with ragged last rows, an all-zero
    bucket and an all-zero message (both taps 0, not NaN), in every bit
    width and for identity uploads; and each row alone gives its row of
    the stack, bit for bit."""
    rng = np.random.default_rng(b * d)
    flat = torch.from_numpy((rng.standard_normal((b, d)) * 0.01)
                            .astype(np.float32))
    flat[0, :200] = 0.0
    flat[-1] = 0.0
    packed = norms = None
    if bits is not None:
        packed, norms = ref.quantize_pack_batch(
            ref.rows2d(flat), prng.split(prng.PRNGKey(b), b), bits)
    got = _taps_equal_on_card_and_cpu(
        "upload_taps", tkernels.taps.upload_taps, ref.upload_taps,
        (flat, packed, norms, bits))
    assert got[-1].tolist() == [0.0, 0.0]
    if bits is None:
        assert (got[:, 1] == 0.0).all()
    dev = _card()
    for i in (0, b // 2):
        one = tkernels.taps.upload_taps(
            flat[i:i + 1].to(dev),
            None if packed is None else packed[i:i + 1].to(dev),
            None if norms is None else norms[i:i + 1].to(dev), bits)
        _assert_bits_equal(one, got[i:i + 1])


# where a level of the tap sums' padding changes (around 32, 1,024 and
# 32,768 values, the CNN's n, past 2^20 and past 32 level-2 windows); at
# B = 8 the last two take tap_reduce.cuh's long plan, alone the short one
TAP_LENGTHS = (1, 31, 33, 1_023, 1_025, 32_767, 32_768, 32_769, 79_842,
               1_048_577, 32 * 32_768 + 5)
TAP_LONG_N = 8_192 * 1_024 + 5  # one row in the long plan


@pytest.mark.gpu
@pytest.mark.parametrize("n", (*TAP_LENGTHS, TAP_LONG_N))
def test_flush_taps_at_every_padding_change(n):
    """The flush taps at the lengths where the sum law's padding changes,
    and at a length whose one row takes the long plan, bit for bit with
    the plain version on the card."""
    dev = _card()
    v = [t.to(dev) for t in _flush_vectors(n, n)]
    w = torch.rand(10, device=dev)
    got = tkernels.taps.flush_taps(*v, w)
    _assert_bits_equal(got, ref.flush_taps(*v, w))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", (4, None))
@pytest.mark.parametrize("n", TAP_LENGTHS)
def test_upload_taps_at_every_padding_change(n, bits):
    """The upload taps of a stack of 8 at the lengths where the sum law's
    padding changes (the longest two in the long plan) against the plain
    version message by message, and each message alone (the short plan)
    against its row of the stack, bit for bit."""
    dev = _card()
    rng = np.random.default_rng(n)
    flat = torch.from_numpy((rng.standard_normal((8, n)) * 0.01)
                            .astype(np.float32)).to(dev)
    packed = norms = None
    if bits is not None:
        packed, norms = tkernels.qsgd.qsgd_quantize_pack_batch_flat(
            flat, prng.split(prng.PRNGKey(n), 8), bits)
    got = tkernels.taps.upload_taps(flat, packed, norms, bits)
    for i in range(8):
        one = [None if t is None else t[i:i + 1] for t in (packed, norms)]
        _assert_bits_equal(got[i:i + 1],
                           ref.upload_taps(flat[i:i + 1], *one, bits))
        _assert_bits_equal(
            got[i:i + 1],
            tkernels.taps.upload_taps(flat[i:i + 1], *one, bits))


@pytest.mark.gpu
@pytest.mark.parametrize("windows", (1, 33, 1_025, 79_842, TAP_LONG_N))
def test_round_taps_both_plans(windows):
    """The round's finishing pass over window sums at lengths of the short
    plan and one of the long plan, bit for bit with the plain version."""
    from repro_torch.kernels.taps import round_taps

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(windows)
    parts = torch.rand((5, windows), generator=gen, device=dev)
    w = torch.rand(4, generator=gen, device=dev)
    _assert_bits_equal(round_taps(parts, w), ref.round_taps_finish(parts, w))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("chunk", (1, 7, 1000))
def test_threefry_quantize_row_offset(bits, chunk):
    """K1 on row chunks at their row offsets (``row0``): each chunk equal
    to those rows of the whole message's encode and to the plain version
    with the same offset; ragged last rows; one launch per chunk."""
    dev = _card()
    rng = np.random.default_rng(bits + chunk)
    n = 128 * 2500 - 37
    rows = ref.rows_for(n)
    x = torch.from_numpy((rng.standard_normal(n) * 0.1).astype(
        np.float32)).to(dev)
    k = torch.tensor(KEYS[2])
    whole = tkernels.qsgd.qsgd_quantize_pack_threefry(x, k, bits)
    for r0 in range(0, rows, chunk):
        r1 = min(rows, r0 + chunk)
        seg = x[r0 * 128:r1 * 128]
        before = tkernels.launches()["qsgd_quantize_pack_threefry"]
        got = tkernels.qsgd.qsgd_quantize_pack_threefry(
            seg, k, bits, row0=r0, total_rows=rows)
        torch.cuda.synchronize()
        assert tkernels.launches()["qsgd_quantize_pack_threefry"] == \
            before + 1
        _assert_bits_equal(got, (whole[0][r0:r1], whole[1][r0:r1]))
        if r0 < 3 * chunk or r1 == rows:
            _assert_bits_equal(got, ref.quantize_pack_threefry(
                seg, k, bits, row0=r0))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", BITS)
def test_quantize_batch_row_offset(bits):
    """K2 at row offsets (the counter hash's global row index, wrapping
    past 2**32 / 128 rows) against its plain version."""
    dev = _card()
    rng = np.random.default_rng(bits)
    x = torch.from_numpy((rng.standard_normal((3, 77, 128)) * 0.1).astype(
        np.float32)).to(dev)
    seeds = prng.split(prng.PRNGKey(bits), 3)
    for row0 in (0, 5, 2 ** 25 - 30):
        got = tkernels.qsgd.qsgd_quantize_pack_batch(x, seeds, bits,
                                                     row0=row0)
        torch.cuda.synchronize()
        _assert_bits_equal(got, ref.quantize_pack_batch(x, seeds, bits,
                                                        row0=row0))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("mode", ("apply_f32", "apply_bf16", "weighted"))
def test_unpack_dequantize_in_place(bits, mode):
    """K3's accumulating modes, written over the accumulator (f32, or
    bf16 rounded to nearest even for the apply mode), against the
    wrapper's plain path on the CPU; nothing past n is written; one
    launch per call."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(bits + 40)
    dtype = torch.bfloat16 if mode == "apply_bf16" else torch.float32
    for rows, n in ((1, 100), (625, 79_842), (40_001, 40_001 * 128 - 5)):
        p = torch.randint(0, 256, (rows, 16 * bits), generator=gen,
                          device=dev, dtype=torch.uint8)
        nm = torch.rand(rows, generator=gen, device=dev) * 3.0
        store = torch.randn(n + 64, generator=gen, device=dev).to(dtype)
        acc = store[:n]
        tail = store[n:].clone()
        w = (torch.rand(1, generator=gen, device=dev)
             if mode == "weighted" else None)
        want = tkernels.qsgd.qsgd_unpack_dequantize(
            p.cpu(), nm.cpu(), bits, acc=acc.cpu(),
            weight=None if w is None else w.cpu())
        before = tkernels.launches()["qsgd_unpack_dequantize"]
        got = tkernels.qsgd.qsgd_unpack_dequantize(p, nm, bits, acc=acc,
                                                   weight=w)
        torch.cuda.synchronize()
        assert tkernels.launches()["qsgd_unpack_dequantize"] == before + 1
        assert got is acc
        if dtype == torch.bfloat16:
            got, want = got.view(torch.int16), want.view(torch.int16)
        _assert_bits_equal(got.cpu(), want)
        assert torch.equal(store[n:], tail)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("beta,lr", ((0.3, 1.0), (None, 1.0), (0.9, 0.7)))
def test_server_update_matches_plain_on_card(dtype, beta, lr):
    """The server-update kernel against its plain version on the card and
    on the CPU, bit for bit, with a tail past the last 8-element vector
    and a buf longer than the state; one launch per call."""
    from repro_torch.kernels.server_update import server_update_

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(7)
    dt = getattr(torch, dtype)
    for n in (5, 4096, 1_000_003):
        buf = torch.randn(n + 3, generator=gen, device=dev) * 1e-2
        m = (torch.randn(n, generator=gen, device=dev) * 1e-3).to(dt)
        x = torch.randn(n, generator=gen, device=dev).to(dt)
        xhat = (x.float() + torch.randn(n, generator=gen, device=dev)
                * 1e-3).to(dt)
        cpu = [t.cpu() for t in (buf, m, x)]
        card = [t.clone() for t in (buf, m, x)]
        plain = [t.clone() for t in (buf, m, x)]
        before = tkernels.launches()["server_update"]
        server_update_(*card, xhat, k=4, beta=beta, lr=lr)
        torch.cuda.synchronize()
        assert tkernels.launches()["server_update"] == before + 1
        f32 = lambda v: float(np.float32(v))
        ref.server_update_(*plain, xhat, inv_k=0.25,
                           beta=None if beta is None else f32(beta),
                           lr=f32(lr))
        server_update_(*cpu, xhat.cpu(), k=4, beta=beta, lr=lr)
        for a, b, c in zip(card, plain, cpu):
            if a.dtype == torch.bfloat16:
                a, b, c = (t.view(torch.int16) for t in (a, b, c))
            _assert_bits_equal(a, b)
            _assert_bits_equal(a.cpu(), c)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("bits,n", (
    (4, 4_100), (4, 4_095), (4, 4_080), (4, 79_842), (4, 100_000),
    (2, 79_842), (8, 79_842), (8, 4_096), (2, 100_000), (4, 10 ** 8)))
def test_round_tap_outputs_match_plain_on_card(dtype, bits, n):
    """The round's taps on the card: the server-update kernel's tap rows,
    K3's x-hat apply with its tap rows and the finishing pass
    (``kernels.taps.round_taps``) against their plain versions on the
    card, bit for bit, and the seven taps against ``ref.round_taps`` over
    the materialized vectors; the state written as without taps; one
    launch each. The lengths take every path of the window law: front
    padding 14 (4,100), 0 with a ragged last window (4,095), 8 (4,080), 15
    (the CNN's 79,842), none (100,000, d = 1e8)."""
    from repro_torch.kernels.server_update import server_update_
    from repro_torch.kernels.taps import round_taps

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(n % 1000 + bits)
    dt = getattr(torch, dtype)
    buf = torch.randn(n, generator=gen, device=dev) * 4e-2
    m = (torch.randn(n, generator=gen, device=dev) * 1e-2).to(dt)
    x = torch.randn(n, generator=gen, device=dev).to(dt)
    xhat = (x.float() + torch.randn(n, generator=gen, device=dev) * 1e-2
            ).to(dt)
    w = torch.tensor([0.9, 1.0, 0.7, 0.5], device=dev)
    x_old = x.float().clone()
    delta = buf * np.float32(0.25)
    x_new = ref.fma_f32(m.float(), float(np.float32(0.3)), delta) + x_old
    plain_state = [t.clone() for t in (buf, m, x)]
    parts = torch.empty((5, ref.tap_windows(n)), device=dev)
    want = torch.empty_like(parts)
    ref.server_update_(*plain_state, xhat, inv_k=0.25,
                       beta=float(np.float32(0.3)), lr=1.0, taps=want[:3])
    no_taps = [t.clone() for t in (buf, m, x)]
    server_update_(*no_taps, xhat, k=4, beta=0.3, lr=1.0)
    before = tkernels.launches()
    server_update_(buf, m, x, xhat, k=4, beta=0.3, lr=1.0, taps=parts[:3])
    torch.cuda.synchronize()
    assert tkernels.launches()["server_update"] == \
        before["server_update"] + 1
    for a, b, c in zip((buf, m, x), plain_state, no_taps):
        if a.dtype == torch.bfloat16:
            a, b, c = (t.view(torch.int16) for t in (a, b, c))
        _assert_bits_equal(a, b)
        _assert_bits_equal(a, c)
    _assert_bits_equal(parts[:3], want[:3])
    del plain_state, no_taps

    diff = buf
    packed, norms = tkernels.qsgd.qsgd_quantize_pack_threefry(
        diff, torch.tensor(KEYS[1]), bits)
    acc, acc_plain = xhat.clone(), xhat.clone()
    tkernels.qsgd.qsgd_unpack_dequantize(packed, norms, bits, acc=acc_plain)
    want[3:] = ref.dequantize_taps(packed, norms, bits, diff)
    before = tkernels.launches()
    tkernels.qsgd.qsgd_unpack_dequantize(packed, norms, bits, acc=acc,
                                         tap_diff=diff, taps=parts[3:])
    torch.cuda.synchronize()
    assert tkernels.launches()["qsgd_unpack_dequantize"] == \
        before["qsgd_unpack_dequantize"] + 1
    if dt == torch.bfloat16:
        acc, acc_plain = acc.view(torch.int16), acc_plain.view(torch.int16)
    _assert_bits_equal(acc, acc_plain)
    _assert_bits_equal(parts[3:], want[3:])

    before = tkernels.launches()["round_taps"]
    got = round_taps(parts, w)
    torch.cuda.synchronize()
    assert tkernels.launches()["round_taps"] == before + 1
    _assert_bits_equal(got, ref.round_taps_finish(parts, w))
    _assert_bits_equal(got, ref.round_taps(x_old, x_new, delta, diff, packed,
                                           norms, bits, w))
    _assert_bits_equal(got.cpu(), round_taps(parts.cpu(), w.cpu()))
    assert torch.isfinite(got).all()


# the round under the other quantizers: gemma2-2b at 2 layers, narrowed,
# on the card against the same on the CPU
_QUANT_KINDS = ("identity", "top_k0.1", "rand_k0.1", "lowrank4g32")


def _two_layer_cfg():
    from repro_torch import configs
    return configs.get_config("gemma2-2b").replace(
        n_layers=2, d_model=64, vocab=512, n_heads=2, n_kv_heads=1,
        head_dim=32, d_ff=128, param_dtype="float32", dtype="float32")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", _QUANT_KINDS)
def test_round_quantizers_card_vs_plain(kind):
    """One client's upload under ``kind`` into the weighted sum
    (``steps.upload`` + ``accumulate_upload``: K1 and K3 where lowrank's
    codes travel, the plain sums otherwise) and the server half under
    ``kind`` with its taps, on the card and on the CPU from the same
    delta, state and keys: the sum, x, x-hat, m, the broadcast and the
    taps bit for bit."""
    import dataclasses

    from repro_torch.core.quantizers import TreeLayout, make_quantizer
    from repro_torch.distributed import steps
    from repro_torch.examples import federated_llm as fl
    from repro_torch.kernels.taps import round_taps

    dev = _card()
    cfg = _two_layer_cfg()
    state = steps.init_round_state(cfg, 1, "cpu")
    d = state.flat[0].numel()
    layout = TreeLayout.of(state.x)
    g = torch.Generator().manual_seed(3)
    delta = 3e-3 * torch.randn(d, generator=g)
    hidden = state.flat[0] + 2e-3 * torch.randn(d, generator=g)
    m = 1e-3 * torch.randn(d, generator=g)
    spec = make_quantizer(kind).spec
    seeds = tkernels.qsgd.basis_seeds(0, 2) if spec.kind == "lowrank" else None
    qcfg = dataclasses.replace(fl.qafel_config(4), server_quantizer=kind)
    out = {}
    for where in ("cpu", dev):
        flat = delta.to(where)[None]
        if spec.kind == "lowrank":
            msg = tkernels.ops._lowrank_encode(
                flat, prng.PRNGKey(5), spec.bits, spec.group, seeds, None,
                False, 7, new_residual=False)
        else:
            msg = {"flat": flat}
        payload = steps.upload(spec, msg, prng.PRNGKey(5), layout, seeds)
        buf = torch.zeros(d, device=where)
        steps.accumulate_upload(buf, payload, torch.tensor([0.7],
                                                           device=where),
                                spec)
        summed = buf.clone()
        xs, hs, ms = (t.clone().to(where) for t in (state.flat[0], hidden,
                                                    m))
        parts = torch.empty((ref.ROUND_TAP_SUMS, ref.tap_windows(d)),
                            device=where)
        bmsg = steps.server_half(xs, hs, ms, buf, prng.PRNGKey(9), qcfg=qcfg,
                                 d=d, taps=parts)
        taps = round_taps(parts, torch.ones(4, device=where))
        out[str(where)] = [t.cpu() for t in (summed, xs, hs, ms, taps,
                                             bmsg[0])]
    for a, b in zip(out["cpu"], out[str(dev)]):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


# a message past element 2**31 (wire row 2**24), as musicgen-large's d =
# 3.25e9 gives the round: every per-element index past the int32 range
_BIG_N = 2 ** 31 + 3 * 2 ** 20 + 77


def _big_rows():
    """Row ranges around element 2**31 and at the end of ``_BIG_N``."""
    rows = ref.rows_for(_BIG_N)
    return ((2 ** 24 - 1000, 2 ** 24 + 1000), (rows - 1000, rows))


@pytest.mark.gpu
def test_kernels_past_element_2_31():
    """K1 (the threefry encode whole and at a row offset past row 2**24),
    K3's weighted add and its bf16 x-hat apply in place, and the server
    update, over a vector of 2**31 + 3,145,805 elements: each bit-equal
    to its plain version on the rows across element 2**31 and on the last
    rows; one launch per call."""
    from repro_torch.kernels.server_update import server_update_

    dev = _card()
    n, bits = _BIG_N, 4
    key = torch.tensor(KEYS[1])
    gen = torch.Generator(device=dev).manual_seed(31)
    x = torch.randn(n, generator=gen, device=dev) * 1e-2
    before = tkernels.launches()["qsgd_quantize_pack_threefry"]
    packed, norms = tkernels.qsgd.qsgd_quantize_pack_threefry(x, key, bits)
    torch.cuda.synchronize()
    assert tkernels.launches()["qsgd_quantize_pack_threefry"] == before + 1
    rows = norms.numel()
    for r0, r1 in _big_rows():
        seg = x[r0 * 128:min(n, r1 * 128)]
        want = ref.quantize_pack_threefry(seg, key, bits, row0=r0)
        _assert_bits_equal((packed[r0:r1], norms[r0:r1]), want)
        _assert_bits_equal(tkernels.qsgd.qsgd_quantize_pack_threefry(
            seg, key, bits, row0=r0, total_rows=rows), want)
    del x
    torch.cuda.empty_cache()

    w = torch.tensor([0.7], device=dev)
    for dtype, weight in ((torch.float32, w), (torch.bfloat16, None)):
        acc = (torch.randn(n, generator=gen, device=dev) * 1e-2).to(dtype)
        old = [acc[r0 * 128:min(n, r1 * 128)].clone()
               for r0, r1 in _big_rows()]
        before = tkernels.launches()["qsgd_unpack_dequantize"]
        tkernels.qsgd.qsgd_unpack_dequantize(packed, norms, bits, acc=acc,
                                             weight=weight)
        torch.cuda.synchronize()
        assert tkernels.launches()["qsgd_unpack_dequantize"] == before + 1
        for (r0, r1), a in zip(_big_rows(), old):
            want = ref.unpack_dequantize(
                packed[r0:r1], norms[r0:r1], bits, acc=a.float(),
                weight=weight).reshape(-1)[:a.numel()].to(dtype)
            got = acc[r0 * 128:min(n, r1 * 128)]
            if dtype == torch.bfloat16:
                got, want = got.view(torch.int16), want.view(torch.int16)
            _assert_bits_equal(got, want)
        del acc
        torch.cuda.empty_cache()
    del packed, norms

    buf = torch.randn(n, generator=gen, device=dev) * 1e-2
    m, xs, xhat = ((torch.randn(n, generator=gen, device=dev) * s).to(
        torch.bfloat16) for s in (1e-3, 1.0, 1.0))
    spans = [slice(r0 * 128, min(n, r1 * 128)) for r0, r1 in _big_rows()]
    old = [[t[sp].clone() for t in (buf, m, xs, xhat)] for sp in spans]
    before = tkernels.launches()["server_update"]
    server_update_(buf, m, xs, xhat, k=4, beta=0.3, lr=1.0)
    torch.cuda.synchronize()
    assert tkernels.launches()["server_update"] == before + 1
    for sp, (b0, m0, x0, h0) in zip(spans, old):
        ref.server_update_(b0, m0, x0, h0, inv_k=0.25,
                           beta=float(np.float32(0.3)), lr=1.0)
        for got, want in ((buf[sp], b0), (m[sp], m0), (xs[sp], x0)):
            if got.dtype == torch.bfloat16:
                got, want = got.view(torch.int16), want.view(torch.int16)
            _assert_bits_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_mixed_state_server_half_card_vs_cpu(arch):
    """The server half on a mixed bf16/f32 tree (the reduced ``arch`` in
    bf16: its f32 ``A_log``, ``D`` and ``dt_bias`` beside the bf16
    buffers), with the taps and the broadcast in row chunks, on the card
    and on the CPU from the same trees and messages: every leaf, the
    broadcast and the taps bit for bit; the f32 leaves stay f32."""
    from repro_torch import configs
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.core.quantizers import TreeLayout
    from repro_torch.distributed import steps
    from repro_torch.examples import federated_llm as fl
    from repro_torch.kernels.taps import round_taps

    dev = _card()
    cfg = configs.get_reduced(arch).replace(param_dtype="bfloat16",
                                            dtype="bfloat16")
    base = steps.init_round_state(cfg, 0, "cpu")
    g = torch.Generator().manual_seed(5)
    noisy = lambda tr, s: tree_map(lambda t: (t.float() + s * torch.randn(
        t.shape, generator=g)).to(t.dtype), tr)
    trees = (base.x, noisy(base.x, 2e-3), noisy(base.momentum, 1e-3))
    d = sum(t.numel() for t in tree_leaves(base.x))
    packed, norms = tkernels.ops.qsgd_quantize_batch(
        3e-3 * torch.randn((4, d), generator=g),
        torch.randint(0, 2 ** 32, (4, 2), generator=g), 4)
    w = torch.tensor([0.9, 1.0, 0.7, 0.5])
    out = {}
    for where in ("cpu", dev):
        st = steps.RoundState.from_trees(
            *(tree_map(lambda t: t.to(where), tr) for tr in trees))
        sides = steps._sides(st, TreeLayout.of(st.x))
        assert sides and all(sd.x.dtype == torch.float32 for sd in sides)
        buf = torch.zeros(d, device=where)
        for k in range(4):
            steps.accumulate(buf, packed[k].to(where), norms[k].to(where),
                             w[k:k + 1].to(where), bits=4, d=d)
        parts = torch.empty((ref.ROUND_TAP_SUMS, ref.tap_windows(d)),
                            device=where)
        bp, bn = steps.server_half(*st.flat, buf, prng.PRNGKey(9),
                                   qcfg=fl.qafel_config(4), d=d,
                                   chunk_rows=1000, taps=parts, sides=sides)
        taps = round_taps(parts, w.to(where))
        out[str(where)] = [t.cpu() for tr in (st.x, st.hidden, st.momentum)
                           for t in tree_leaves(tr)] + [
            bp.cpu(), bn.cpu(), taps.cpu()]
    for a, b in zip(out["cpu"], out[str(dev)]):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype in (torch.float32, torch.bfloat16):
            a, b = a.view(torch.int16 if a.dtype == torch.bfloat16
                          else torch.int32), b.view(
                torch.int16 if b.dtype == torch.bfloat16 else torch.int32)
        assert torch.equal(a, b)


SILU_SPECIAL = (0.0, -0.0, 1e-40, -1e-40, 1.4e-45, -1.4e-45, 1.1e-38,
                -1.1e-38, 2e-38, float("inf"), float("-inf"), float("nan"),
                87.5, 88.5, 89.0, -87.5, -88.5, -89.0, 3.4e38, -3.4e38)


def _same_or_nan(a, b) -> bool:
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n,offset", ((1, 0), (7, 0), (4099, 0), (4099, 1),
                                      ((1 << 20) + 3, 3)))
def test_silu_matches_plain_on_card(n, offset):
    """``csrc/silu.cu`` forward and backward against the plain version
    (``xla_math.silu_fwd`` / ``silu_bwd``) on the card and on the CPU, bit
    for bit (a nan as a nan), at lengths that are not multiples of 4 and
    from a start off the 16-byte boundary (``offset`` floats in): the
    tail [-88.8, -87.3], N(0, 16) values and the special values; one
    launch each way."""
    from repro_torch.kernels import silu, xla_math
    dev = _card()
    gen = torch.Generator().manual_seed(n)
    x = 4 * torch.randn(n + offset, generator=gen)
    x[: (n + offset) // 2] = -88.8 + 1.5 * torch.rand((n + offset) // 2,
                                                        generator=gen)
    sp = torch.tensor(SILU_SPECIAL)
    x[-min(sp.numel(), n):] = sp[:min(sp.numel(), n)]
    g = torch.randn(n + offset, generator=gen)
    g[::5] = 1e-40
    xc, gc = x.to(dev)[offset:], g.to(dev)[offset:]
    tkernels.reset_launches()
    y = silu.silu_forward(xc)
    gx = silu.silu_backward(gc, xc)
    assert tkernels.launches()["silu_forward"] == 1
    assert tkernels.launches()["silu_backward"] == 1
    py, pg = xla_math.silu_fwd(xc), xla_math.silu_bwd(gc, xc)
    cy = xla_math.silu_fwd(x[offset:])
    cg = xla_math.silu_bwd(g[offset:], x[offset:])
    for got, card, cpu in ((y, py, cy), (gx, pg, cg)):
        assert _same_or_nan(got, card) and _same_or_nan(got.cpu(), cpu)


def _lse_rows(rows, cols, offset, seed):
    """(rows, cols) logits of N(0, 64) on the CPU, ``offset`` floats into
    their storage: the special values in row 0, -inf in row 1 whole, a
    tail whose exp flushes (a - m in [-88.8, -86.5]) in the last row."""
    gen = torch.Generator().manual_seed(seed)
    a = 8 * torch.randn(rows * cols + offset, generator=gen)
    x = a[offset:].view(rows, cols)
    sp = torch.tensor(SILU_SPECIAL)[:cols]
    x[0, :sp.numel()] = sp
    if rows > 2:
        x[1] = -torch.inf
    k = min(cols, 300)
    x[-1, :k] = x[-1].amax() - torch.linspace(86.5, 88.8, k)
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols,offset", (
    (3, 1, 0), (5, 31, 1), (4, 32, 0), (3, 33, 2), (6, 1024, 0),
    (3, 1025, 1), (2, 32768, 0), (3, 32769, 3), (128, 50288, 0),
    (64, 256000, 0), (8, 256000, 1)))
def test_logsumexp_matches_plain_on_card(rows, cols, offset):
    """``csrc/logsumexp.cu`` against its plain version
    (``logsumexp.plain_*``) on the card and on the CPU, bit for bit (a nan
    as a nan), at every padding change of law 7's levels and the pool's
    vocabularies, both plans (short and long rows), from a start
    ``offset`` floats off the 16-byte boundary: the forward (lse, m, the
    sum), the sum-only and log-only modes, the backward with a cotangent
    a row and with one broadcast from a scalar (stride 0); one launch
    each (the forward two: the row max, then the pass)."""
    from repro_torch.kernels import logsumexp as klse
    dev = _card()
    x = _lse_rows(rows, cols, offset, cols)
    g = torch.randn(rows, generator=torch.Generator().manual_seed(1))
    g[-1] = 1e-37  # a subnormal quotient, flushed
    xd = torch.cat([torch.zeros(offset), x.reshape(-1)]).to(dev)[
        offset:].view(rows, cols)
    gd = g.to(dev)
    tkernels.reset_launches()
    got = klse.forward(xd)
    counts = tkernels.launches()
    assert counts["logsumexp_max"] == 1 and counts["logsumexp_forward"] == 1
    card = klse.plain_forward(xd)
    cpu = klse.plain_forward(x)
    for a, b, c in zip(got, card, cpu):
        assert _same_or_nan(a, b) and _same_or_nan(a.cpu(), c)
    _, m, total = got
    raw = xd.amax(-1, keepdim=True)
    tkernels.reset_launches()
    m2, t2 = klse.sum_exp(xd, raw.clone())
    lse2 = klse.log_plus(t2, m2)
    counts = tkernels.launches()
    assert counts["logsumexp_sum"] == 1 and counts["logsumexp_log"] == 1
    assert _same_or_nan(m2, m) and _same_or_nan(t2, total)
    assert _same_or_nan(lse2, got[0])
    for cot in (gd, torch.full((), 0.25, device=dev).expand(rows)):
        tkernels.reset_launches()
        da = klse.backward(cot, xd, m, total)
        assert tkernels.launches()["logsumexp_backward"] == 1
        assert _same_or_nan(da, klse.plain_backward(cot, xd, m, total))
    assert _same_or_nan(klse.backward(gd, xd, m, total).cpu(),
                        klse.plain_backward(g, x, *cpu[1:]))
