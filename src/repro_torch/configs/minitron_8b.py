"""minitron-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000; pruned Nemotron-4 (squared-ReLU MLP, no bias).
[arXiv:2407.14679]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=256000,
    act="relu2",          # nemotron-family squared ReLU
    rope_theta=1e4,
    source="arXiv:2407.14679 (Minitron / pruned Nemotron-4)",
))
