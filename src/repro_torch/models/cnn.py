"""The paper's model: the 4-layer CNN binary classifier for CelebA smiling.

Counterpart of ``repro/models/cnn.py``. Four conv layers (5x5 kernels,
stride 1, padding 2, 32 channels), GroupNorm (8 groups) in place of
BatchNorm, ReLU and a 2x2 VALID max-pool after each, dropout 0.1 on the
flattened features, and a linear head: 79,842 parameters for 32x32x3 input.

Parameters keep the reference's leaf shapes — HWIO conv kernels, (in, out)
head — and the functions take channel-last (NHWC) images, so a flat vector
of the port lists the same numbers in the same order as the reference's
(``common.tree``). The layout change to PyTorch's NCHW/OIHW happens at the
``conv2d`` call only. The dropout mask is the reference's exactly:
``bernoulli(key, 0.9)`` from the port's threefry.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common import prng
from repro_torch.common.device import resolve_device
from repro_torch.models.layers import dense_init, group_norm

CH = 32
N_LAYERS = 4
GROUPS = 8
IN_CH, N_CLASSES = 3, 2
DROPOUT = 0.1


def init_cnn(seed: int = 0, device=None):
    """A random parameter tree of the CNN, made from ``seed`` on the CPU's
    generator and placed on ``device`` (``None``: the card, as for every
    entry point; ``"cpu"`` for the CPU)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {}
    ch_in = IN_CH
    for i in range(N_LAYERS):
        params[f"conv{i}"] = {
            "w": dense_init(gen, (5, 5, ch_in, CH), 25 * ch_in),
            "b": torch.zeros(CH),
            "gn_scale": torch.ones(CH),
            "gn_bias": torch.zeros(CH),
        }
        ch_in = CH
    # 32x32 -> pool x4 -> 2x2 spatial
    params["head"] = {
        "w": dense_init(gen, (2 * 2 * CH, N_CLASSES), 2 * 2 * CH),
        "b": torch.zeros(N_CLASSES),
    }
    return {k: {kk: v.to(device) for kk, v in sub.items()}
            for k, sub in params.items()}


def cnn_forward(params, images: torch.Tensor, *, train: bool = False,
                key=None) -> torch.Tensor:
    """images (B, 32, 32, 3) NHWC -> logits (B, n_classes)."""
    h = images.permute(0, 3, 1, 2)  # NCHW for conv2d
    for i in range(N_LAYERS):
        p = params[f"conv{i}"]
        h = F.conv2d(h, p["w"].permute(3, 2, 0, 1), padding=2)  # HWIO->OIHW
        h = h.permute(0, 2, 3, 1) + p["b"]  # NHWC
        h = torch.relu(group_norm(h, p["gn_scale"], p["gn_bias"], GROUPS))
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # flatten in HWC order
    if train:
        if key is None:
            raise ValueError("dropout needs a key in train mode")
        keep = prng.bernoulli(key, 1.0 - DROPOUT, h.shape, device=h.device)
        h = torch.where(keep, h / (1.0 - DROPOUT), torch.zeros_like(h))
    return h @ params["head"]["w"] + params["head"]["b"]


def cnn_loss(params, batch, *, train: bool = False, key=None):
    """Mean negative log-likelihood and the logits."""
    logits = cnn_forward(params, batch["images"], train=train, key=key)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    labels = batch["labels"].to(torch.int64)
    nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
    return nll.mean(), logits


def cnn_accuracy(params, batch) -> torch.Tensor:
    logits = cnn_forward(params, batch["images"], train=False)
    return (logits.argmax(-1) == batch["labels"].to(torch.int64)).to(
        torch.float32).mean()


class CNN(nn.Module):
    """The CNN as a module: its parameters, under the reference's names
    (``conv0.w`` ... ``head.b``), hold one parameter tree."""

    def __init__(self, params):
        super().__init__()
        self.layers = nn.ModuleDict({
            name: nn.ParameterDict({k: nn.Parameter(v.detach().clone())
                                    for k, v in sub.items()})
            for name, sub in params.items()})

    def tree(self):
        """The parameters as a nested dict (the functions' input)."""
        return {name: dict(sub.items()) for name, sub in self.layers.items()}

    def forward(self, images, *, train: bool = False, key=None):
        return cnn_forward(self.tree(), images, train=train, key=key)

