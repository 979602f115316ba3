"""Functional optimizers on parameter trees (``optimizers``)."""
from repro_torch.optim.optimizers import (OptState, Optimizer, adamw,
                                          make_optimizer, momentum, sgd)

__all__ = ["OptState", "Optimizer", "adamw", "make_optimizer", "momentum",
           "sgd"]
