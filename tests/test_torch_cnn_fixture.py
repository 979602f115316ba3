"""The port's CNN gradients against the JAX reference's eager ones, from
the committed fixture ``tests/fixtures_torch/cnn_grad_ref.npz`` (made on
the CPU by ``tests/fixtures_torch/make_cnn_grad_ref.py``).

No JAX here: the fixture holds the parameters, the batch's rows of
``SyntheticCelebA(3000)`` and the reference's gradients at full width
(79,842 parameters) with ``train=False`` and with a fixed dropout key.
Tolerance rtol 1e-5, atol 1e-6 per element, as tests/test_torch_cnn.py
holds the CNN (XLA's and ATen's convolutions sum in other orders).
``chip_smoke.py`` makes the same comparison on the card."""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.common.tree import tree_leaves
from repro_torch.core.quantizers import TreeLayout
from repro_torch.data import SyntheticCelebA
from repro_torch.models.cnn import cnn_loss, init_cnn

FIXTURE = Path(__file__).parent / "fixtures_torch" / "cnn_grad_ref.npz"
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def ref():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_cnn_gradients_match_fixture(ref, mode):
    layout = TreeLayout.of(init_cnn(0, device="cpu"))
    assert layout.total_size == ref["params"].size == 79_842
    params = layout.unflatten(torch.from_numpy(ref["params"]))
    data = SyntheticCelebA(n_samples=int(ref["n_samples"])).batch(
        ref["indices"])
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    key = torch.from_numpy(ref["dropout_key"].astype(np.int64))
    train = mode == "train"
    grads, loss = torch.func.grad_and_value(
        lambda p: cnn_loss(p, batch, train=train,
                           key=key if train else None)[0])(params)
    assert float(loss) == pytest.approx(float(ref[f"loss_{mode}"]),
                                        rel=RTOL, abs=ATOL)
    got = torch.cat([g.reshape(-1) for g in tree_leaves(grads)]).numpy()
    np.testing.assert_allclose(got, ref[f"grad_{mode}"], rtol=RTOL,
                               atol=ATOL)
