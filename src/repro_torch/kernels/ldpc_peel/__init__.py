"""LDPC peeling decode on the card: the fixed-D flooding decode."""
from repro_torch.kernels.ldpc_peel.ops import CodeTables, peel_decode_cuda
from repro_torch.kernels.ldpc_peel.ref import decode_fused_ref, dense_h

__all__ = ["CodeTables", "peel_decode_cuda", "decode_fused_ref", "dense_h"]
