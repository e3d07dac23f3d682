"""Matrix product on the card in f32 accuracy (the moment encode):
``csrc/block_matmul.cu`` (the split pass and the tensor-core products),
their wrappers and their plain versions."""
from repro_torch.kernels.block_matmul.ops import (block_matmul, coded_matvec, encode_gm,
                                                  products_of_terms, split_terms)
from repro_torch.kernels.block_matmul.ref import (block_matmul_ref, products_ref, split_terms_ref,
                                                  terms_product_ref)

__all__ = ["block_matmul", "coded_matvec", "encode_gm", "split_terms", "products_of_terms",
           "block_matmul_ref", "products_ref", "split_terms_ref", "terms_product_ref"]
