"""Attention with an online softmax on the card (the model zoo's attention
core): ``csrc/flash_attention.cu``, its wrapper and its plain version."""
from repro_torch.kernels.flash_attention.ops import flash_attention_cuda, plain_version
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention_cuda", "plain_version", "attention_ref"]
