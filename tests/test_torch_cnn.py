"""The port's CNN (repro_torch.models.cnn) against the JAX package's: the
parameter conversion round trip, the loss and gradient at batch 4 with the
dropout key, and the upload encode of an identical delta.

Tolerances: the loss and gradients go through XLA's convolutions on one
side and ATen's on the other, whose sums run in other orders, so they agree
to float32 rounding, not bit for bit — rtol 1e-5 and atol 1e-6 (observed:
max abs error 6e-7 on gradients up to 0.43, loss within 2e-7). The dropout
mask itself is identical (the port's threefry), and everything downstream
of an identical flat delta is bit-exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantizers import qsgd_encode_flat2d as jencode
from repro.models.cnn import cnn_accuracy as jaccuracy
from repro.models.cnn import cnn_loss as jloss
from repro.models.cnn import init_cnn as jinit
from repro_torch.common import prng
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.convert import params_from_jax
from repro_torch.core.quantizers import flatten_tree, qsgd_encode_flat2d
from repro_torch.models.cnn import CNN, cnn_accuracy, cnn_loss, init_cnn

RTOL, ATOL = 1e-5, 1e-6
N_PARAMS = 79_842


@pytest.fixture(scope="module")
def setup():
    params = jinit(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"images": rng.standard_normal((4, 32, 32, 3), dtype=np.float32),
             "labels": rng.integers(0, 2, 4).astype(np.int32)}
    key = jax.random.PRNGKey(7)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b, k: jloss(p, b, train=True, key=k)[0]))
    loss, grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()},
                     key)
    return dict(params=params, batch=batch, key=key, loss=float(loss),
                grads=[np.asarray(g) for g in jax.tree.leaves(grads)])


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_params_from_jax_round_trip(setup):
    np_params = jax.tree.map(np.asarray, setup["params"])
    tparams = params_from_jax(np_params, device="cpu")
    back = tree_map(lambda t: t.detach().numpy(), CNN(tparams).tree())
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(np_params), jax.tree.leaves(back)):
        assert a.shape == b.shape and np.array_equal(a, b)
    flat, layout = flatten_tree(tparams)
    assert layout.total_size == N_PARAMS
    jflat = np.concatenate([np.ravel(x) for x in jax.tree.leaves(np_params)])
    assert np.array_equal(flat.numpy(), jflat)  # JAX leaf order


def test_init_cnn_shapes_match_reference(setup):
    mine = init_cnn(3, device="cpu")
    ref = jax.tree.map(np.asarray, setup["params"])
    assert [tuple(x.shape) for x in tree_leaves(mine)] == [
        x.shape for x in jax.tree.leaves(ref)]


def test_loss_and_grad_match_jax(setup):
    tparams = params_from_jax(jax.tree.map(np.asarray, setup["params"]),
                              device="cpu")
    tkey = torch.from_numpy(np.asarray(setup["key"]).astype(np.int64))
    grads, loss = torch.func.grad_and_value(
        lambda p, b, k: cnn_loss(p, b, train=True, key=k)[0])(
        tparams, _torch_batch(setup["batch"]), tkey)
    assert float(loss) == pytest.approx(setup["loss"], rel=RTOL, abs=ATOL)
    for want, got in zip(setup["grads"], tree_leaves(grads)):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_module_forward_and_accuracy_match_jax(setup):
    np_params = jax.tree.map(np.asarray, setup["params"])
    tb = _torch_batch(setup["batch"])
    model = CNN(params_from_jax(np_params, device="cpu"))
    with torch.no_grad():
        logits = model(tb["images"])
    jb = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    want = np.asarray(jax.jit(lambda p, b: jloss(p, b)[1])(setup["params"], jb))
    np.testing.assert_allclose(logits.numpy(), want, rtol=RTOL, atol=ATOL)
    assert float(cnn_accuracy(model.tree(), tb)) == float(
        jaccuracy(setup["params"], jb))


def test_dropout_mask_is_the_reference_mask(setup):
    """Same key, same mask: the train-mode logits differ from eval-mode
    ones in the same places on both sides."""
    np_params = jax.tree.map(np.asarray, setup["params"])
    jb = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    jl = np.asarray(jax.jit(lambda p, b, k: jloss(p, b, train=True, key=k)[1])(
        setup["params"], jb, setup["key"]))
    tkey = torch.from_numpy(np.asarray(setup["key"]).astype(np.int64))
    tl = cnn_loss(params_from_jax(np_params, device="cpu"),
                  _torch_batch(setup["batch"]),
                  train=True, key=tkey)[1].detach().numpy()
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)


def test_upload_encode_of_identical_delta_is_bit_exact(setup):
    delta = np.concatenate([g.ravel() for g in setup["grads"]]) * -0.05
    delta = delta.astype(np.float32)[None]
    key = jax.random.split(jax.random.PRNGKey(11))[1]
    jp, jn = jax.jit(lambda d, k: jencode(d, k, 4, threefry=True))(
        jnp.asarray(delta), key)
    tp, tn = qsgd_encode_flat2d(
        torch.from_numpy(delta), torch.from_numpy(np.asarray(key).astype(np.int64)),
        4, threefry=True)
    assert tuple(tp.shape) == (1, 624, 64) and tuple(tn.shape) == (1, 624)
    assert np.array_equal(np.asarray(jp), tp.numpy())
    assert np.array_equal(np.asarray(jn).view(np.int32),
                          tn.numpy().view(np.int32))
    # and the dither key reaches the codes: another key, other codes
    tp2, _ = qsgd_encode_flat2d(torch.from_numpy(delta),
                                prng.PRNGKey(12), 4, threefry=True)
    assert not torch.equal(tp, tp2)
