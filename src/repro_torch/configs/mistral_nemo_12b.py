"""mistral-nemo-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k context. [hf:mistralai/Mistral-Nemo-Base-2407]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    kv_heads=8,
    head_dim=128,         # Nemo uses head_dim=128 (not d_model/n_heads=160)
    d_ff=14336,
    vocab=131072,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1e6,
)
