"""Wrapper of the round's server-update kernel (``csrc/server_update.cu``).

The kernel has no Pallas counterpart: the reference computes the server
update in XLA inside its jitted round. One pass over d does the FedBuff
momentum and update from the clients' weighted sum and leaves the
broadcast diff in the sum's buffer (``server_update_``); with ``taps`` the
same pass also writes the level-1 window sums of the round's three
server-side taps (the kernel's taps instantiation, one launch all the
same). A CPU tensor runs the plain version (``ref.server_update_``); a
CUDA tensor launches the kernel, adding one to
``LAUNCHES["server_update"]``; any other device raises.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.qsgd import check_aligned, check_tensor, on_card

# launches since the last reset (``kernels.reset_launches``)
LAUNCHES = {"server_update": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def server_update_(buf: torch.Tensor, m: torch.Tensor, x: torch.Tensor,
                   xhat: torch.Tensor, *, k: int, beta: Optional[float],
                   lr: float,
                   taps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The server update of a round with buffer size ``k``, in place:
    from the f32 weighted sum ``buf`` (at least n = ``x.numel()`` values)
    and the state ``m``, ``x``, ``xhat`` (n values each, one dtype: f32 or
    bf16), ``delta_bar = buf * fl32(1/k)``, ``m_new = fma(m, beta,
    delta_bar)`` (``beta`` None: no momentum), ``x_new = m_new + x``
    (server ``lr`` 1, else ``fma(m_new, lr, x)``), ``diff = x_new -
    xhat``; ``buf[:n] <- diff``, ``m <- m_new`` and ``x <- x_new`` rounded
    to the state's dtype, nearest even. Every scalar is taken as f32, as
    XLA holds the reference's Python floats. ``taps``, an f32 (3,
    ``ref.tap_windows(n)``) tensor, gets the level-1 window sums of
    XLA:CPU's sum law of ``delta_bar**2``, ``(x_new - x)**2`` (x_new in
    f32, before its rounding) and ``diff**2`` (``ref.server_update_``).
    Returns ``buf``."""
    n = x.numel()
    dev = x.device
    if x.dtype not in _DTYPES:
        raise TypeError(f"a server update on {x.dtype} state")
    for name, t in (("m", m), ("x", x), ("xhat", xhat)):
        check_tensor(name, t, x.dtype, (n,), dev)
    check_tensor("buf", buf, torch.float32, (None,), dev)
    if buf.numel() < n:
        raise ValueError(f"buf: {buf.numel()} values for a state of {n}")
    if taps is not None:
        check_tensor("taps", taps, torch.float32, (3, _ref.tap_windows(n)),
                     dev)
    f32 = lambda v: float(np.float32(v))
    inv_k = f32(1.0 / k)
    beta = None if beta is None else f32(beta)
    lr = f32(lr)
    if not on_card(x):
        return _ref.server_update_(buf, m, x, xhat, inv_k=inv_k, beta=beta,
                                   lr=lr, taps=taps)
    for name, t in (("buf", buf), ("m", m), ("x", x), ("xhat", xhat)):
        check_aligned(name, t)
    fn = _build.entry("server_update")
    _build.check("server_update", fn(
        buf.data_ptr(), m.data_ptr(), x.data_ptr(), xhat.data_ptr(), n,
        _DTYPES[x.dtype], inv_k, 0.0 if beta is None else beta,
        int(beta is not None), lr, int(lr == 1.0),
        None if taps is None else taps.data_ptr(), _ref.tap_windows(n),
        _ref.tap_front(n), torch.cuda.current_stream(dev).cuda_stream))
    LAUNCHES["server_update"] += 1
    return buf
