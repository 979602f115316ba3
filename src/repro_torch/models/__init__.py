"""Models of the port: the paper's 4-layer CNN and the decoders
(attention, MoE and MLA, Mamba2 and the hybrid)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (abstract_cache, abstract_params,
                                            decode_step, forward, init_cache,
                                            init_params, loss_fn)

__all__ = ["ModelConfig", "abstract_cache", "abstract_params",
           "decode_step", "forward", "init_cache", "init_params", "loss_fn"]
