"""deepseek-v2-236b [moe] — 60L d_model=5120 128H MLA (kv_lora=512,
q_lora=1536, nope 128 / rope 64 / v 128) vocab=102400; MoE: 2 shared +
160 routed experts top-6, expert d_ff=1536, first layer dense (d_ff=12288).
[arXiv:2405.04434]"""
from repro_torch.configs.base import ArchConfig, MLASpec, MoESpec, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,       # MLA: per-head K/V (latent-compressed)
    head_dim=128,
    d_ff=12288,           # the single dense (non-MoE) first layer
    vocab=102400,
    mla=MLASpec(kv_lora=512, q_lora=1536, qk_nope=128, qk_rope=64, v_head=128),
    moe=MoESpec(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2,
                first_dense=1),
    rope_theta=1e4,
    source="arXiv:2405.04434 (DeepSeek-V2)",
))
