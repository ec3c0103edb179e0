"""rwkv6-1.6b [ssm] "Finch": 24L d_model=2048 (attention-free)
d_ff=7168 vocab=65536 — data-dependent decay linear attention.
O(1) recurrent state -> native long_500k. The paper's PCA-filtering
technique is inapplicable to the sequence mixer (no neighbor candidate
set to filter) — see DESIGN.md §Arch-applicability. [arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,           # time-mix heads (head_dim 64)
    kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab=65536,
    mlp="rwkv",           # channel-mix (relu^2 gated)
    norm="layernorm",
    norm_eps=1e-5,
)
