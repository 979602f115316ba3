"""The plain PyTorch versions of the four kernels (repro_torch.kernels.ref,
reached through the wrappers on CPU tensors) against the JAX package's
jitted entry points (repro.kernels.ops), with torch.equal: codes, norms and
f32 values bit for bit. The JAX side runs its own CPU routes, which its
test_fast_routes_match_interpreted_pallas pins to the interpreted kernels.
The CUDA kernels against their plain versions: test_torch_kernels_card."""
import ctypes
import fractions

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import qsgd as jqsgd
from repro_torch import kernels as tkernels
from repro_torch.common import prng
from repro_torch.kernels import ops, ref

BITS = (2, 4, 8)
# ragged tails, one exact row count, one row, and the CNN's 624 rows
SIZES = (1, 200, 2048, 4100)
# key words on both sides of 2**31: the kernel takes them as uint32 values
HIGH_KEYS = ((0x80000000, 0xFFFFFFFF), (0xDEADBEEF, 0x9E3779B9),
             (7, 0x80000001))


def _msg(rng, n, zero_row=True):
    x = (rng.standard_normal(n) * rng.uniform(1e-3, 10)).astype(np.float32)
    if zero_row and n > 128:
        x[128:256] = 0.0  # an all-zero bucket: norm 0, codes 0
    return x


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    return a.shape == b.shape and np.array_equal(a, b)


def _key(seed):
    k = jax.random.split(jax.random.PRNGKey(seed))[1]
    return k, torch.from_numpy(np.asarray(k).astype(np.int64))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n", SIZES)
def test_quantize_matches_jax(bits, n):
    rng = np.random.default_rng(n * 10 + bits)
    x = _msg(rng, n)
    jk, tk = _key(n + bits)
    jp, jn = jops.qsgd_quantize(jnp.asarray(x), jk, bits)
    tp, tn = ops.qsgd_quantize(torch.from_numpy(x), tk, bits)
    assert tp.dtype == torch.uint8 and tuple(tp.shape) == jp.shape
    assert _bits_equal(jp, tp) and _bits_equal(jn, tn)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("key", HIGH_KEYS)
@pytest.mark.parametrize("n", (200, 4100))
def test_threefry_quantize_matches_jax_high_keys(bits, key, n):
    """The fused b=1 entry's plain version, through its wrapper and
    directly, against the reference's upload for raw keys whose words are
    >= 2**31; ragged n with an all-zero bucket."""
    rng = np.random.default_rng(n + bits)
    x = _msg(rng, n)
    jp, jn = jops.qsgd_quantize(jnp.asarray(x),
                                jnp.asarray(np.array(key, np.uint32)), bits)
    tk = torch.tensor(key, dtype=torch.int64)
    for tp, tn in (tkernels.qsgd.qsgd_quantize_pack_threefry(
                       torch.from_numpy(x), tk, bits),
                   ref.quantize_pack_threefry(torch.from_numpy(x), tk, bits)):
        assert _bits_equal(jp, tp) and _bits_equal(jn, tn)


def _threefry_np(k0, k1, x1):
    """threefry2x32((k0, k1), (0, x1)) on numpy uint32 arrays: the
    per-element law the fused kernel implements (csrc/threefry.cuh)."""
    def rotl(v, r):
        return (v << np.uint32(r)) | (v >> np.uint32(32 - r))

    ks = [np.uint32(k0), np.uint32(k1),
          np.uint32(k0) ^ np.uint32(k1) ^ np.uint32(0x1BD11BDA)]
    x0 = np.zeros_like(x1) + ks[0]
    x1 = x1 + ks[1]
    for g in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[g % 2]:
            x0 = x0 + x1
            x1 = rotl(x1, r) ^ x0
        x0 = x0 + ks[(g + 1) % 3]
        x1 = x1 + ks[(g + 2) % 3] + np.uint32(g + 1)
    return x0, x1


@pytest.mark.parametrize("key", ((0, 42),) + HIGH_KEYS)
def test_counter_law_matches_prng_uniform(key):
    """Element i of uniform(key, (rows, 128)) is one cipher call on the
    counter (0, i): b = w0 ^ w1, u = f32((b >> 9) | 0x3F800000) - 1."""
    rows = 9
    i = np.arange(rows * 128, dtype=np.uint32)
    with np.errstate(over="ignore"):
        w0, w1 = _threefry_np(*key, i)
    u = (((w0 ^ w1) >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    u = (u - np.float32(1.0)).reshape(rows, 128)
    got = prng.uniform(torch.tensor(key, dtype=torch.int64), (rows, 128))
    assert _bits_equal(u, got)


def test_threefry_wrapper_rejects_counter_overflow():
    """rows*128 >= 2**32 would wrap the 32-bit counter: refused before any
    allocation or device dispatch (a meta tensor carries only the shape)."""
    key = prng.PRNGKey(0)
    with pytest.raises(ValueError, match=r"2\*\*32"):
        tkernels.qsgd.qsgd_quantize_pack_threefry(
            torch.empty(2**32 - 127, device="meta"), key, 4)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tkernels.qsgd.qsgd_quantize_pack_threefry(
            torch.empty(2**32 - 128, device="meta"), key, 4)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n", SIZES)
def test_quantize_batch_matches_jax(bits, n):
    rng = np.random.default_rng(n * 10 + bits + 1)
    x = np.stack([_msg(rng, n, zero_row=(b == 1)) for b in range(3)])
    keys = jax.random.split(jax.random.PRNGKey(n), 3)
    jp, jn = jops.qsgd_quantize_batch(jnp.asarray(x), keys, bits)
    tp, tn = ops.qsgd_quantize_batch(
        torch.from_numpy(x), torch.from_numpy(np.asarray(keys).astype(np.int64)),
        bits)
    assert _bits_equal(jp, tp) and _bits_equal(jn, tn)


@pytest.mark.parametrize("rows", (1, 9, 624))
def test_hash_uniform_matches_jax(rows):
    seeds = np.array([[0, 1], [0x9E3779B9, 0xFFFFFFFF], [12345, 678]],
                     np.uint32)
    lane = jax.lax.broadcasted_iota(jnp.uint32, (rows, 128), 1)
    row = jax.lax.broadcasted_iota(jnp.uint32, (rows, 128), 0)
    idx = row * jnp.uint32(128) + lane
    want = np.stack([np.asarray(jqsgd._hash_uniform(
        jnp.uint32(s0), jnp.uint32(s1), idx)) for s0, s1 in seeds])
    got = ref.hash_uniform(torch.from_numpy(seeds.astype(np.int64)), rows)
    assert _bits_equal(want, got)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n", SIZES)
def test_dequantize_matches_jax(bits, n):
    rng = np.random.default_rng(n * 10 + bits + 2)
    jk, _ = _key(n)
    jp, jn = jops.qsgd_quantize(jnp.asarray(_msg(rng, n)), jk, bits)
    jd = jops.qsgd_dequantize(jp, jn, bits, n)
    td = ops.qsgd_dequantize(torch.from_numpy(np.array(jp)),
                             torch.from_numpy(np.array(jn)), bits, n)
    assert tuple(td.shape) == (n,)
    assert _bits_equal(jd, td)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n", SIZES)
def test_dequantize_eager_matches_jax_eager(bits, n):
    """K3's eager variant against the reference's decode block run op by
    op (its non-fused flush chain): a true division by s."""
    rng = np.random.default_rng(n * 10 + bits + 5)
    jk, _ = _key(n + 1)
    jp, jn = jops.qsgd_quantize(jnp.asarray(_msg(rng, n)), jk, bits)
    with jax.disable_jit():
        want = jqsgd._unpack_dequantize_block(jp, jn[:, None], bits)
    got = tkernels.qsgd.qsgd_unpack_dequantize(
        torch.from_numpy(np.array(jp)), torch.from_numpy(np.array(jn)), bits,
        eager=True)
    assert _bits_equal(want, got)
    fused = tkernels.qsgd.qsgd_unpack_dequantize(
        torch.from_numpy(np.array(jp)), torch.from_numpy(np.array(jn)), bits)
    if bits > 2 and n >= 2048:  # s = 1 at 2 bits: both scales are the norm
        assert not _bits_equal(fused, got)  # the two laws do differ here


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n", SIZES)
def test_dequantize_accumulate_matches_jitted_apply(bits, n):
    """K3 with an accumulator, written over it, against the reference's
    jitted ``acc + qsgd_dequantize(...)`` (the round's x-hat + q): XLA:CPU
    fuses the decode's last product into the add, one rounding."""
    rng = np.random.default_rng(n * 10 + bits + 7)
    jk, _ = _key(n + 2)
    jp, jn = jops.qsgd_quantize(jnp.asarray(_msg(rng, n)), jk, bits)
    acc = (0.3 * rng.standard_normal(n)).astype(np.float32)
    want = jax.jit(lambda a, p, nm: a + jops.qsgd_dequantize(p, nm, bits, n))(
        jnp.asarray(acc), jp, jn)
    acc_t = torch.from_numpy(acc.copy())
    got = tkernels.qsgd.qsgd_unpack_dequantize(
        torch.from_numpy(np.array(jp)), torch.from_numpy(np.array(jn)), bits,
        acc=acc_t)
    assert got is acc_t and tuple(got.shape) == (n,)
    assert _bits_equal(want, got)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n", SIZES)
def test_dequantize_weighted_accumulate_matches_jitted_scan(bits, n):
    """K3 with an accumulator and a weight, written over the accumulator,
    against the reference round's
    jitted ``buf + w * qsgd_dequantize(...)`` inside a scan over three
    messages (``repro/distributed/steps.py:170``): XLA:CPU rounds the
    decode, then fuses the weight's product into the add."""
    rng = np.random.default_rng(n * 10 + bits + 9)
    msgs = [jops.qsgd_quantize(jnp.asarray(_msg(rng, n)), _key(n + i)[0],
                               bits) for i in range(3)]
    jp = jnp.stack([m[0] for m in msgs])
    jn = jnp.stack([m[1] for m in msgs])
    w = rng.uniform(0.3, 1.0, 3).astype(np.float32)

    def scan(p, nm, w):
        body = lambda buf, i: (buf + i[2] * jops.qsgd_dequantize(
            i[0], i[1], bits, n), None)
        return jax.lax.scan(body, jnp.zeros((n,), jnp.float32),
                            (p, nm, w))[0]
    want = jax.jit(scan)(jp, jn, jnp.asarray(w))
    got = torch.zeros(n)
    for i in range(3):
        tkernels.qsgd.qsgd_unpack_dequantize(
            torch.from_numpy(np.array(jp[i])),
            torch.from_numpy(np.array(jn[i])), bits, acc=got,
            weight=torch.from_numpy(w[i:i + 1]))
    assert _bits_equal(want, got)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("k", (1, 4, 10))
def test_buffer_aggregate_matches_jax(bits, k):
    n = 2000
    rng = np.random.default_rng(100 * k + bits)
    stack, norms = [], []
    for i in range(k):
        p, nm = jops.qsgd_quantize(jnp.asarray(_msg(rng, n, zero_row=i == 0)),
                                   jax.random.PRNGKey(i), bits)
        stack.append(np.asarray(p))
        norms.append(np.asarray(nm))
    taus = rng.integers(0, 5, size=k)
    w = (np.asarray([1.0 / np.sqrt(1.0 + t) for t in taus], np.float32)
         / np.float32(k)).astype(np.float32)
    stack, norms = np.stack(stack), np.stack(norms)
    ja = jops.buffer_aggregate(jnp.asarray(stack), jnp.asarray(norms),
                               jnp.asarray(w), bits, n)
    ta = ops.buffer_aggregate(torch.from_numpy(stack),
                              torch.from_numpy(norms), torch.from_numpy(w),
                              bits, n)
    assert _bits_equal(ja, ta)


@pytest.mark.parametrize("b", (1, 3, 64, 65))
def test_seed_words_by_value(b):
    """The batched kernel's seed words: up to the cap (64 messages) they
    ride in the launch as a struct of 2*cap uint32 words, words 2b and 2b+1
    being message b's, the same bit patterns the kernel would otherwise
    read from a device buffer (``prng.key_words_i32``), high words
    included; above the cap there is no struct."""
    from repro_torch.kernels import _build
    rng = np.random.default_rng(b)
    seeds = torch.from_numpy(
        rng.integers(0, 2**32, (b, 2), dtype=np.uint64).astype(np.int64))
    seeds[0] = torch.tensor([0x80000000, 0xFFFFFFFF])
    words = tkernels.qsgd.seed_words(seeds)
    if b > _build.SEEDS_BY_VALUE:
        assert words is None
        return
    cap = _build.SEEDS_BY_VALUE
    assert cap == 64 and ctypes.sizeof(words) == 8 * cap
    raw = np.frombuffer(bytes(words), dtype=np.uint32)
    want = prng.key_words_i32(seeds).numpy().view(np.uint32).reshape(-1)
    assert np.array_equal(raw[:2 * b], want)
    assert not raw[2 * b:].any()


def test_fma_f32_rounds_once():
    """A case that float64 then float32 rounding gets wrong: the exact sum
    lies just below an f32 midpoint, the float64 sum ON it, and ties-to-even
    then picks the far neighbour. 2**36 + 1 = 4097 * 16773121."""
    a = torch.tensor([-4097 * 2.0**-30], dtype=torch.float32)
    b = torch.tensor([16773121 * 2.0**-30], dtype=torch.float32)
    c = torch.tensor([1 + 2.0**-22], dtype=torch.float32)
    exact = (fractions.Fraction(a.item()) * fractions.Fraction(b.item())
             + fractions.Fraction(c.item()))
    third = fractions.Fraction(1, 2**24)
    assert exact == 1 + 3 * third - fractions.Fraction(1, 2**60)
    naive = (a.double() * b.double() + c.double()).float()
    assert naive.item() == 1 + 2.0**-22  # the double-rounding error
    assert ref.fma_f32(a, b, c).item() == 1 + 2.0**-23  # correctly rounded


def test_sqrt_f32_correctly_rounded():
    rng = np.random.default_rng(3)
    v = np.concatenate([rng.uniform(0, 1e4, 20000),
                        rng.uniform(0, 1e-30, 100), [0.0, 1.0, 4.0]])
    v = v.astype(np.float32)
    got = ref.sqrt_f32(torch.from_numpy(v)).numpy()
    assert _bits_equal(np.sqrt(v), got)


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros(4, 128)
    u = torch.zeros(4, 128)
    with pytest.raises(ValueError):
        tkernels.qsgd.qsgd_quantize_pack(x, u, 3)
    with pytest.raises(TypeError):
        tkernels.qsgd.qsgd_quantize_pack(x.double(), u, 4)
    with pytest.raises(ValueError):
        tkernels.qsgd.qsgd_quantize_pack(x, u[:3], 4)
    with pytest.raises(ValueError):
        tkernels.qsgd.qsgd_quantize_pack(x.t().contiguous().t(), u, 4)
    with pytest.raises(ValueError):
        tkernels.qsgd.qsgd_quantize_pack(x.to("meta"), u.to("meta"), 4)


def test_cpu_tensors_launch_nothing():
    tkernels.reset_launches()
    ops.qsgd_quantize(torch.ones(300), prng.PRNGKey(0), 4)
    assert all(v == 0 for v in tkernels.launches().values())
