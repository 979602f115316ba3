"""The port's kernels: hand-written CUDA C++ for Hopper (``csrc/``), their
plain PyTorch versions (``ref``), the wrappers (``qsgd``, ``buffer_agg``,
``taps``) and the wire-layout entry points (``ops``); and the population
engine's macro step (``population``, with ``xla_math``), plain torch as
the reference's is XLA code; and the round's server update
(``server_update``) and the round's tap finishing pass
(``taps.round_taps``), silu by the reference's law (``silu``) and the
loss's logsumexp by it (``logsumexp``), kernels with no Pallas
counterpart."""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import (buffer_agg, logsumexp, qsgd, server_update,
                                 silu, taps)


def launches() -> Dict[str, int]:
    """Kernel launches per kernel since the last ``reset_launches``."""
    return {**qsgd.LAUNCHES, **buffer_agg.LAUNCHES, **taps.LAUNCHES,
            **server_update.LAUNCHES, **silu.LAUNCHES, **logsumexp.LAUNCHES}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for counts in (qsgd.LAUNCHES, buffer_agg.LAUNCHES, taps.LAUNCHES,
                   server_update.LAUNCHES, silu.LAUNCHES,
                   logsumexp.LAUNCHES):
        for name in counts:
            counts[name] = 0
