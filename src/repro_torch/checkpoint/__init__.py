"""Checkpoints of parameter trees (``ckpt``), in the reference's msgpack
layout."""
from repro_torch.checkpoint.ckpt import (latest_step, load_checkpoint,
                                         save_checkpoint)

__all__ = ["latest_step", "load_checkpoint", "save_checkpoint"]
