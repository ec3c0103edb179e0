"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
(per expert) vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-*]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    kv_heads=4,
    head_dim=128,         # Qwen3 decouples head_dim from d_model/n_heads
    d_ff=1536,            # per-expert FFN width
    vocab=151936,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1e6,
    moe=MoEConfig(n_experts=128, experts_per_tok=8),
)
