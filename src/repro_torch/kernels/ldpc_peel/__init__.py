"""LDPC peeling decode on the card: the fixed-D and early-exit flooding
decodes, for one pattern or a batch."""
from repro_torch.kernels.ldpc_peel.ops import (CodeTables, peel_decode_adaptive_cuda,
                                               peel_decode_batch_adaptive_cuda,
                                               peel_decode_batch_cuda, peel_decode_cuda)
from repro_torch.kernels.ldpc_peel.ref import (decode_fused_adaptive_ref,
                                               decode_fused_batch_adaptive_ref,
                                               decode_fused_batch_ref,
                                               decode_fused_ref, dense_h)

__all__ = ["CodeTables", "peel_decode_cuda", "peel_decode_batch_cuda",
           "peel_decode_adaptive_cuda", "peel_decode_batch_adaptive_cuda",
           "decode_fused_ref", "decode_fused_batch_ref", "decode_fused_adaptive_ref",
           "decode_fused_batch_adaptive_ref", "dense_h"]
