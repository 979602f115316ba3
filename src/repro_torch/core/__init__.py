"""QAFeL core: quantizers, wire protocol, buffer, staleness, algorithm."""
from repro_torch.core.fedbuff import fedbuff_config, make_fedbuff
from repro_torch.core.protocol import Message, TrafficMeter
from repro_torch.core.qafel import QAFeL, QAFeLConfig, ServerState
from repro_torch.core.quantizers import (Quantizer, QuantizerSpec, TreeLayout,
                                         flatten_tree, make_quantizer)

__all__ = ["Message", "QAFeL", "QAFeLConfig", "Quantizer", "QuantizerSpec",
           "ServerState", "TrafficMeter", "TreeLayout", "fedbuff_config",
           "flatten_tree", "make_fedbuff", "make_quantizer"]
