"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE. [arXiv:2402.19173]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab=49152,
    mlp="gelu",           # starcoder2 uses a plain GELU MLP
    norm="layernorm",
    qkv_bias=True,
    rope_theta=1e5,
    norm_eps=1e-5,
)
