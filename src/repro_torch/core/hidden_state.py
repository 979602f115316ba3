"""The shared hidden state x-hat (QAFeL's central mechanism).

Counterpart of ``repro/core/hidden_state.py``. The server and every client
hold x-hat and evolve it by the same quantized increments
q^t = Q_s(x^{t+1} - x-hat^t) (Algorithm 1 line 14, Algorithm 3 line 4), so
the copies stay bit-identical. Because the broadcast encodes the difference
to the hidden state rather than the server model itself, quantization
error does not compound across rounds.

On the server x-hat lives as a flat f32 vector in
``core.qafel.ServerState`` and is updated inside ``ops.server_flush_step``;
``HiddenState`` is the tree view at the client and eval boundaries.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.common.tree import tree_map


def hidden_apply(value, q_decoded):
    """x-hat^{t+1} = x-hat^t + q^t (Equation 4), leaf by leaf, keeping each
    leaf's dtype. The flush runs the same ``h + q`` on the flat vector."""
    return tree_map(lambda h, d: (h + d).to(h.dtype), value, q_decoded)


@dataclasses.dataclass
class HiddenState:
    value: Any  # tree of the model's structure

    @staticmethod
    def init(params0) -> "HiddenState":
        return HiddenState(value=tree_map(lambda x: x.clone(), params0))

    def apply(self, q_decoded) -> "HiddenState":
        """x-hat^{t+1} = x-hat^t + q^t (Equation 4)."""
        return HiddenState(value=hidden_apply(self.value, q_decoded))


def server_broadcast_delta(quantizer, x_new, x_hat, key):
    """q^t = Q_s(x^{t+1} - x-hat^t): the *decoded* increment, the in-math
    path (``Quantizer.qdq``, leaf by leaf) of the reference's function,
    bit for bit. The flush applies the decoded wire bits instead."""
    return quantizer.qdq(tree_map(lambda a, b: a - b, x_new, x_hat), key)
