"""QAFeL core: quantizers, wire protocol, buffer, staleness, the shared
hidden state, checkpoints and the algorithm."""
from repro_torch.core.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core.fedbuff import fedbuff_config, make_fedbuff
from repro_torch.core.hidden_state import (HiddenState, hidden_apply,
                                           server_broadcast_delta)
from repro_torch.core.protocol import Message, TrafficMeter
from repro_torch.core.qafel import QAFeL, QAFeLConfig, ServerState
from repro_torch.core.quantizers import (Quantizer, QuantizerSpec, TreeLayout,
                                         flatten_tree, make_quantizer)

__all__ = ["HiddenState", "Message", "QAFeL", "QAFeLConfig", "Quantizer",
           "QuantizerSpec", "ServerState", "TrafficMeter", "TreeLayout",
           "fedbuff_config", "flatten_tree", "hidden_apply", "load_checkpoint",
           "make_fedbuff", "make_quantizer", "save_checkpoint",
           "server_broadcast_delta"]
