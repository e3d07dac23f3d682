"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2; Mamba:attention 7:1 interleave
(one attention layer per 8), MoE every 2nd layer.  [arXiv:2403.19887]"""
from repro_torch.configs.base import ArchConfig, MambaSpec, MoESpec, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    moe=MoESpec(n_experts=16, top_k=2, d_ff_expert=24576, every=2),
    mamba=MambaSpec(d_state=16, d_conv=4, expand=2),
    attn_every=8,
    attn_offset=4,
    rope_theta=1e6,
    source="arXiv:2403.19887 (Jamba); 1.5-large scaling",
))
