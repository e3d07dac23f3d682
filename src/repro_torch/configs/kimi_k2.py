"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8, head_dim 128)
vocab=163840; MoE 384 routed experts top-8 + 1 shared, expert d_ff=2048,
first layer dense (d_ff=18432).  Trillion-param MoE (paper-table dims).
[arXiv:2501.kimi2]"""
from repro_torch.configs.base import ArchConfig, MoESpec, register

CONFIG = register(ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=18432,           # dense first layer; experts use d_ff_expert
    vocab=163840,
    moe=MoESpec(n_experts=384, top_k=8, d_ff_expert=2048, n_shared=1,
                first_dense=1),
    rope_theta=5e7,
    source="arXiv:2501.kimi2 (Kimi K2 paper-table dims)",
))
