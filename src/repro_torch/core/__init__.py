"""QAFeL core: quantizers, wire protocol, buffer, staleness, the shared
hidden state, checkpoints and the algorithm."""
from repro_torch.core.buffer import FlushBatch, UpdateBuffer
from repro_torch.core.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core.fedbuff import fedbuff_config, make_fedbuff
from repro_torch.core.hidden_state import (HiddenState, hidden_apply,
                                           server_broadcast_delta)
from repro_torch.core.protocol import (Message, TrafficMeter, decode_message,
                                       decode_message_flat, encode_message,
                                       encode_message_flat,
                                       frame_packed_message)
from repro_torch.core.qafel import (QAFeL, QAFeLConfig, ServerState,
                                    client_update, client_update_flat,
                                    local_sgd_scan, server_apply)
from repro_torch.core.quantizers import (Quantizer, QuantizerSpec, TreeLayout,
                                         flatten_tree, make_quantizer)
from repro_torch.core.staleness import (StalenessMonitor, staleness_weight,
                                        tau_max_for_buffer)
from repro_torch.kernels.ops import server_apply_flat

__all__ = ["FlushBatch", "HiddenState", "Message", "QAFeL", "QAFeLConfig",
           "Quantizer", "QuantizerSpec", "ServerState", "StalenessMonitor",
           "TrafficMeter", "TreeLayout", "UpdateBuffer", "client_update",
           "client_update_flat", "decode_message", "decode_message_flat",
           "encode_message", "encode_message_flat", "fedbuff_config",
           "flatten_tree", "frame_packed_message", "hidden_apply",
           "load_checkpoint", "local_sgd_scan", "make_fedbuff",
           "make_quantizer", "save_checkpoint", "server_apply",
           "server_apply_flat", "server_broadcast_delta", "staleness_weight",
           "tau_max_for_buffer"]
