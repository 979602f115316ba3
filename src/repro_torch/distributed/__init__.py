"""The QAFeL round on a decoder architecture (``steps``)."""
from repro_torch.distributed.steps import (RoundState, abstract_round_state,
                                           init_round_state,
                                           make_decode_step,
                                           make_prefill_step,
                                           make_qafel_round)

__all__ = ["RoundState", "abstract_round_state", "init_round_state",
           "make_decode_step", "make_prefill_step", "make_qafel_round"]
