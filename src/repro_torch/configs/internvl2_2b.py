"""internvl2-2b [vlm] — language backbone (InternLM2-1.8B-like): 24L
d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.  The InternViT vision
encoder + MLP projector are a STUB — input_specs() supplies 256 projected
patch embeddings (B, 256, d_model) prepended to the text sequence.
[arXiv:2404.16821]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=92553,
    n_patches=256,
    rope_theta=1e6,
    source="arXiv:2404.16821 (InternVL2-2B; InternLM2 backbone)",
))
