"""The port's quantizer specs and in-math paths (repro_torch.core.quantizers)
against the JAX package's, on the CPU.

Exact: every spec property of every kind (``levels``, ``unbiased``,
``delta``, ``rank``, ``wire_bits``, ``label``) and the ``__post_init__``
refusals; ``make_quantizer``'s names; wire bytes by arithmetic and from
encoded payloads (1,328 B per lowrank4g32 upload and 63,880 B per
top_k0.1 / rand_k0.1 message at the CNN's n = 79,842; 1,660,160 B per
lowrank4g32 upload at d = 1e8).

Bit for bit (``np.array_equal`` on the f32 bit patterns): ``qdq`` /
``qdq_flat`` of qsgd at bits 2..8 and bucket sizes 16 to 2,055 (65, 100,
129, 200, 1,000 and 2,055 among them), and of every other kind. XLA:CPU
sums a bucket's squares in an order that depends on its width
(``quantizers._bucket_sq_sums``): in order with fused squares up to 32,
above that in windows of 32 with the padding split evenly
(``ref.xla_sum``)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizers as J
from repro.core.protocol import payload_kind_label as jlabel
from repro.core.protocol import payload_wire_bytes as jbytes
from repro_torch.common import prng
from repro_torch.core import quantizers as T
from repro_torch.core.protocol import payload_kind_label, payload_wire_bytes

CNN_N = 79_842


@pytest.fixture(scope="module", autouse=True)
def _cold_jax_caches_after():
    """This module compiles the reference's jitted wire entries. Clearing
    JAX's caches when it is done leaves a later test in the same process
    that expects a cold compile (the reference's compile watch and trace
    counters) a cold cache."""
    yield
    jax.clear_caches()


def _bits(a) -> np.ndarray:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    a, b = _bits(a), _bits(b)
    return a.shape == b.shape and np.array_equal(a, b)


SPECS = [
    dict(kind="qsgd", bits=b) for b in range(2, 9)
] + [
    dict(kind="qsgd", bits=4, bucket_size=64),
    dict(kind="top_k", fraction=0.1), dict(kind="top_k", fraction=0.013),
    dict(kind="rand_k", fraction=0.1),
    dict(kind="rand_k", fraction=0.25, scaled=False),
    dict(kind="lowrank"), dict(kind="lowrank", bits=2, group=16),
    dict(kind="lowrank", bits=8, group=128),
    dict(kind="lowrank", bits=4, group=4, bucket_size=64),
    dict(kind="identity"),
]


@pytest.mark.parametrize("fields", SPECS, ids=lambda f: "-".join(
    str(v) for v in f.values()))
def test_spec_properties_match_reference(fields):
    jspec, tspec = J.QuantizerSpec(**fields), T.QuantizerSpec(**fields)
    assert dataclass_fields(tspec) == dataclass_fields(jspec)
    assert tspec.unbiased == jspec.unbiased
    assert tspec.levels == jspec.levels
    assert tspec.label() == jspec.label()
    for d in (1, 5, 127, 128, 1000, 2048, CNN_N, 10**8):
        assert tspec.wire_bits(d) == jspec.wire_bits(d), d
        assert tspec.delta(d) == jspec.delta(d), d
        if fields["kind"] == "lowrank":
            assert tspec.rank(d) == jspec.rank(d), d
    if fields["kind"] != "lowrank":
        with pytest.raises(ValueError):
            tspec.rank(10)


def dataclass_fields(spec) -> dict:
    return {f: getattr(spec, f) for f in (
        "kind", "bits", "fraction", "scaled", "bucket_size", "group")}


@pytest.mark.parametrize("fields", [
    dict(kind="foo"), dict(kind="qsgd", bits=1), dict(kind="qsgd", bits=9),
    dict(kind="lowrank", bits=9), dict(kind="top_k", fraction=0.0),
    dict(kind="rand_k", fraction=1.5), dict(kind="lowrank", group=1),
    dict(kind="lowrank", group=48),
    dict(kind="lowrank", group=32, bucket_size=48)])
def test_spec_refusals_match_reference(fields):
    with pytest.raises(ValueError) as jerr:
        J.QuantizerSpec(**fields)
    with pytest.raises(ValueError) as terr:
        T.QuantizerSpec(**fields)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("name", [
    "qsgd", "qsgd2", "qsgd3", "qsgd4", "qsgd8", "top_k", "top_k0.1",
    "rand_k0.05", "lowrank", "lowrank4", "lowrank4g32", "lowrank2g16",
    "identity", None])
def test_make_quantizer_names_match_reference(name):
    assert dataclass_fields(T.make_quantizer(name).spec) == \
        dataclass_fields(J.make_quantizer(name).spec)


def test_make_quantizer_refuses_unknown_names():
    with pytest.raises(ValueError):
        T.make_quantizer("sign_sgd")


def test_wire_bytes_by_arithmetic():
    lowrank, top_k, rand_k = (T.make_quantizer(n).spec for n in (
        "lowrank4g32", "top_k0.1", "rand_k0.1"))
    # lowrank4g32 at n = 79,842: 624 rows, rank 79,872 / 32 = 2,496, four
    # bits each and one norm per 128 of them (20)
    assert lowrank.rank(CNN_N) == 2_496
    assert lowrank.wire_bits(CNN_N) / 8 == (4 * 2_496 + 32 * 20) / 8 == 1_328
    # top_k0.1 / rand_k0.1: ceil(7,984.2) = 7,985 pairs of 64 bits
    for spec in (top_k, rand_k):
        assert spec.wire_bits(CNN_N) / 8 == 64 * 7_985 / 8 == 63_880
    # lowrank4g32 at d = 1e8: rank 3,125,000, 24,415 norms
    assert lowrank.rank(10**8) == 3_125_000
    assert lowrank.wire_bits(10**8) / 8 == (4 * 3_125_000 + 32 * math.ceil(
        3_125_000 / 128)) / 8 == 1_660_160


@pytest.mark.parametrize("name,want", [("lowrank4g32", 1_328),
                                       ("top_k0.1", 63_880),
                                       ("rand_k0.1", 63_880)])
def test_encoded_payload_bytes_at_cnn_size(name, want):
    """A real message of the CNN's size meters exactly its wire bytes and
    its kind label, in both packages."""
    x = np.random.default_rng(3).standard_normal(CNN_N).astype(np.float32)
    tflat, tlayout = T.flatten_tree({"w": torch.from_numpy(x)})
    jflat, jlayout = J.flatten_tree({"w": jnp.asarray(x)})
    tenc = T.make_quantizer(name).encode_flat(tflat, tlayout,
                                              prng.PRNGKey(4))
    jenc = J.make_quantizer(name).encode_flat(jflat, jlayout,
                                              jax.random.PRNGKey(4))
    assert payload_wire_bytes(tenc) == jbytes(jenc) == want
    assert payload_kind_label(tenc) == jlabel(jenc)
    assert T.make_quantizer(name).wire_bytes_packed(tlayout) == want


def test_wire_encode_refuses_bits_that_do_not_divide_a_byte():
    """qsgd3 runs in the math (``qdq``) but not on the wire, as in the
    reference, whose kernels assert ``8 % bits == 0``."""
    q = T.make_quantizer("qsgd3")
    flat, layout = T.flatten_tree({"w": torch.ones(300)})
    with pytest.raises(ValueError, match="bits"):
        q.encode_flat(flat, layout, prng.PRNGKey(0))
    assert q.qdq_flat(flat, prng.PRNGKey(0)).shape == (300,)


@pytest.mark.parametrize("bucket", [16, 32, 40, 48, 64, 65, 100, 128, 129,
                                    200, 256, 1000, 2055])
@pytest.mark.parametrize("bits", [2, 3, 4, 5, 8])
def test_qsgd_qdq_honours_bucket_size(bucket, bits):
    x = np.random.default_rng(bucket + bits).standard_normal(
        1000).astype(np.float32)
    x[::97] = 0.0
    fields = dict(bits=bits, bucket_size=bucket)
    jq = J.Quantizer(J.QuantizerSpec("qsgd", **fields))
    tq = T.Quantizer(T.QuantizerSpec("qsgd", **fields))
    assert _same(jq.qdq_flat(jnp.asarray(x), jax.random.PRNGKey(3)),
                 tq.qdq_flat(torch.from_numpy(x), prng.PRNGKey(3)))
    jtree = jq.qdq({"a": jnp.asarray(x[:300]), "b": jnp.asarray(x[300:])},
                   jax.random.PRNGKey(5))
    ttree = tq.qdq({"a": torch.from_numpy(x[:300]),
                    "b": torch.from_numpy(x[300:])}, prng.PRNGKey(5))
    assert _same(jtree["a"], ttree["a"]) and _same(jtree["b"], ttree["b"])


def test_qsgd_qdq_bucket_100_within_tolerance():
    """A bucket of 100 (above 64, not a multiple of 32) is exact: XLA:CPU
    sums it in windows of 32 with the padding split evenly (14 zeros in
    front, 14 behind), the law ``ref.xla_sum`` spells."""
    x = np.random.default_rng(0).standard_normal(4000).astype(np.float32)
    for bits in (2, 4, 8):
        fields = dict(bits=bits, bucket_size=100)
        want = np.asarray(J.Quantizer(J.QuantizerSpec(
            "qsgd", **fields)).qdq_flat(jnp.asarray(x), jax.random.PRNGKey(3)))
        got = T.Quantizer(T.QuantizerSpec("qsgd", **fields)).qdq_flat(
            torch.from_numpy(x), prng.PRNGKey(3))
        assert _same(want, got), bits


@pytest.mark.parametrize("name", ["top_k0.1", "rand_k0.1", "rand_k0.3",
                                  "lowrank4g32", "lowrank2g16", "lowrank8g64",
                                  "identity"])
@pytest.mark.parametrize("n", [1000, 2048])
def test_qdq_flat_matches_reference(name, n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    x[:40] = 0.5  # ties for top_k, broken by index
    jq, tq = J.make_quantizer(name), T.make_quantizer(name)
    assert _same(jq.qdq_flat(jnp.asarray(x), jax.random.PRNGKey(6)),
                 tq.qdq_flat(torch.from_numpy(x), prng.PRNGKey(6)))
    if not name.startswith("lowrank"):
        jt = jq.qdq({"w": jnp.asarray(x)}, jax.random.PRNGKey(7))
        tt = tq.qdq({"w": torch.from_numpy(x)}, prng.PRNGKey(7))
        assert _same(jt["w"], tt["w"])


def test_lowrank_has_no_per_leaf_qdq():
    """lowrank's basis spans the whole flat message: the port refuses
    ``qdq_leaf`` (the reference's falls through to its rand_k branch)."""
    with pytest.raises(ValueError, match="qdq_flat"):
        T.make_quantizer("lowrank4g32").qdq_leaf(torch.ones(64),
                                                 prng.PRNGKey(0))
