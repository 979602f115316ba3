"""The four CUDA kernels against their plain PyTorch versions, on the card:
codes, norms and f32 values bit for bit (signed zeros included), and one
launch counted per call. Needs a CUDA device and nvcc; without a device
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
    "qsgd_quantize_pack_batch": (tkernels.qsgd.qsgd_quantize_pack_batch,
                                 ref.quantize_pack_batch),
    "qsgd_unpack_dequantize": (tkernels.qsgd.qsgd_unpack_dequantize,
                               ref.unpack_dequantize),
    "buffer_aggregate": (tkernels.buffer_agg.buffer_aggregate,
                         ref.buffer_aggregate),
}


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
        want = plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            if g.dtype == torch.float32:  # bit patterns: signed zeros too
                g, w = g.view(torch.int32), w.view(torch.int32)
            assert torch.equal(g, w)
