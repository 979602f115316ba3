"""FedBuff baseline (Nguyen et al., 2022) — the paper's comparison point.

Counterpart of ``repro/core/fedbuff.py``: FedBuff is QAFeL in the
infinite-precision limit (Proposition 3.5), so the baseline is the same
implementation with identity quantizers, 32 bits per coordinate on the wire.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.qafel import QAFeL, QAFeLConfig


def fedbuff_config(base: QAFeLConfig) -> QAFeLConfig:
    return dataclasses.replace(base, client_quantizer="identity",
                               server_quantizer="identity")


def make_fedbuff(qcfg: QAFeLConfig, loss_fn, params0, device=None,
                 mesh=None) -> QAFeL:
    return QAFeL(fedbuff_config(qcfg), loss_fn, params0, device=device,
                 mesh=mesh)
