"""Tiled matrix product on the card (the moment encode): ``csrc/block_matmul.cu``,
its wrappers and its plain version."""
from repro_torch.kernels.block_matmul.ops import block_matmul, coded_matvec, encode_gm
from repro_torch.kernels.block_matmul.ref import block_matmul_ref

__all__ = ["block_matmul", "coded_matvec", "encode_gm", "block_matmul_ref"]
