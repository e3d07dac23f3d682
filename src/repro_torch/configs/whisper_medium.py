"""whisper-medium [audio] — 24L enc + 24L dec, d_model=1024 16H (MHA)
d_ff=4096 vocab=51865; encoder-decoder; conv/mel frontend is a STUB —
input_specs() supplies post-conv frame embeddings (B, 1500, d_model).
[arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51865,
    act="gelu",
    norm="layernorm",
    pos="sinusoidal",
    enc_layers=24,
    enc_seq=1500,
    source="arXiv:2212.04356 (Whisper medium)",
))
