"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256. [arXiv:2407.21783]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab=128256,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=5e5,
)
