"""Write ``cnn_grad_ref.npz``: the JAX reference's eager gradients of the
paper's CNN at full width (79,842 parameters), for the port to be held
against on the CPU (tests/test_torch_cnn_fixture.py) and on the card
(chip_smoke.py, phase ``cnn_grad_vs_fixture``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures_torch/make_cnn_grad_ref.py

Contents: the parameters (``init_cnn(PRNGKey(0))``, flat, in JAX leaf
order), the batch (``SyntheticCelebA(3000)`` rows ``indices``), and the
loss and flat gradient of ``cnn_loss`` run op by op (no jit) with
``train=False`` and with ``train=True`` under dropout key ``PRNGKey(7)``.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.data import SyntheticCelebA
from repro.models.cnn import cnn_loss, init_cnn

N_SAMPLES = 3000
INDICES = np.arange(8, dtype=np.int64) * 37 + 5
DROPOUT_KEY = 7


def flat(tree) -> np.ndarray:
    return np.concatenate([np.ravel(np.asarray(x, np.float32))
                           for x in jax.tree.leaves(tree)])


def main() -> None:
    params = init_cnn(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v)
             for k, v in SyntheticCelebA(n_samples=N_SAMPLES)
             .batch(INDICES).items()}
    out = {"n_samples": np.int64(N_SAMPLES), "indices": INDICES,
           "params": flat(params),
           "dropout_key": np.asarray(jax.random.PRNGKey(DROPOUT_KEY),
                                     np.uint32)}
    with jax.disable_jit():
        for name, train, key in (
                ("eval", False, None),
                ("train", True, jax.random.PRNGKey(DROPOUT_KEY))):
            loss, grads = jax.value_and_grad(
                lambda p: cnn_loss(p, batch, train=train, key=key)[0])(params)
            out[f"loss_{name}"] = np.float32(loss)
            out[f"grad_{name}"] = flat(grads)
    path = Path(__file__).with_name("cnn_grad_ref.npz")
    np.savez_compressed(path, **out)
    print(path, path.stat().st_size, "bytes")


if __name__ == "__main__":
    main()
