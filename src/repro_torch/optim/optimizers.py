"""Functional optimizers on parameter trees.

Counterpart of ``repro/optim/optimizers.py``. Each optimizer is a pair of
pure functions bundled in ``Optimizer``: ``init(params) -> state`` and
``update(grads, state, params) -> (new_params, new_state)``; states are
``OptState`` tuples of trees in the parameters' dtypes, with the step
count as a host int.

Every update rounds as the reference's does called eagerly (each op its
own rounding, in the dtypes jax's promotion gives): a Python float meets a
tensor in the tensor's dtype (``_weak``), a bf16 tensor meets an f32 one
in f32, square roots are correctly rounded (``ref.sqrt_f32``), and
adamw's ``b ** step`` is XLA:CPU's f32 ``pow``, which calls the C
library's ``powf`` and flushes a subnormal result to zero (``_powf``;
read from the reference's object code). Jitted, XLA fuses some of the
products into their sums, and the reference's updates move in their last
bits (tests/test_torch_optim.py holds both).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.common.tree import tree_map
from repro_torch.common.tree import weak_scalar as _weak
from repro_torch.kernels.ref import sqrt_f32

_F32_TINY = float(np.finfo(np.float32).tiny)


class OptState(NamedTuple):
    step: int
    mu: Any = None  # first moment / momentum
    nu: Any = None  # second moment


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any], tuple]


@functools.lru_cache(maxsize=1)
def _libm_powf():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    fn = lib.powf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float,
                                               ctypes.c_float]
    return fn


def _powf(base: float, step: int) -> float:
    """``base ** f32(step)`` in f32 as XLA:CPU computes it: the C
    library's ``powf``, a subnormal result flushed to zero."""
    r = float(_libm_powf()(float(np.float32(base)), float(np.float32(step))))
    return 0.0 if abs(r) < _F32_TINY else r


def sgd(lr: float) -> Optimizer:
    def init(params):
        return OptState(step=0)

    def update(grads, state, params):
        new = tree_map(lambda p, g: (p - _weak(lr, g) * g).to(p.dtype),
                       params, grads)
        return new, OptState(step=state.step + 1)

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return OptState(step=0, mu=tree_map(torch.zeros_like, params))

    def update(grads, state, params):
        mu = tree_map(lambda m, g: _weak(beta, m) * m + g, state.mu, grads)
        upd = (tree_map(lambda m, g: _weak(beta, m) * m + g, mu, grads)
               if nesterov else mu)
        new = tree_map(lambda p, u: (p - _weak(lr, u) * u).to(p.dtype),
                       params, upd)
        return new, OptState(step=state.step + 1, mu=mu)

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return OptState(step=0, mu=tree_map(torch.zeros_like, params),
                        nu=tree_map(torch.zeros_like, params))

    def update(grads, state, params):
        step = state.step + 1
        mu = tree_map(lambda m, g: _weak(b1, m) * m + _weak(1 - b1, g) * g,
                      state.mu, grads)
        nu = tree_map(lambda v, g: _weak(b2, v) * v + _weak(1 - b2, g)
                      * (g * g), state.nu, grads)
        one = np.float32(1.0)
        bc1 = float(one - np.float32(_powf(b1, step)))
        bc2 = float(one - np.float32(_powf(b2, step)))
        f32 = torch.float32

        def upd(p, m, v):
            mhat = m.to(f32) / bc1
            vhat = v.to(f32) / bc2
            den = sqrt_f32(vhat) + _weak(eps, vhat)
            s = mhat / den + (_weak(weight_decay, p) * p).to(f32)
            return (p.to(f32) - _weak(lr, s) * s).to(p.dtype)

        new = tree_map(upd, params, mu, nu)
        return new, OptState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)


def make_optimizer(name: str, lr: float, **kw) -> Optimizer:
    return {"sgd": sgd, "momentum": momentum, "adamw": adamw}[name](lr, **kw)
