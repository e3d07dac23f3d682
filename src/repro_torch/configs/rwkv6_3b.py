"""rwkv6-3b [ssm] — 32L d_model=2560 (attention-free, 40 heads x 64)
d_ff=8960 vocab=65536; RWKV-6 "Finch" with data-dependent decay.
[arXiv:2404.05892]"""
from repro_torch.configs.base import ArchConfig, RWKVSpec, register

CONFIG = register(ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,           # d_model / rwkv.head_dim
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab=65536,
    rwkv=RWKVSpec(head_dim=64, decay_lora=64),
    attn_every=0,
    pos="none",
    source="arXiv:2404.05892 (RWKV-6 Finch, 3B)",
))
