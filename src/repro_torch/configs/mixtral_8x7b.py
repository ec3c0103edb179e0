"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1e6,
    window=4096,          # SWA -> bounded KV cache -> native long_500k
    moe=MoEConfig(n_experts=8, experts_per_tok=2),
)
