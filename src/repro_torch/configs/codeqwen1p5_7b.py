"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (GQA kv=32 == MHA)
d_ff=13440 vocab=92416, qwen1.5 arch (QKV bias, no qk-norm).
[hf:Qwen/CodeQwen1.5-7B]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab=92416,
    qk_norm=False,
    qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/CodeQwen1.5-7B",
))
