"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT frontend STUBBED (input_specs provides patch
embeddings); the LLM backbone (llama3-70b-like) is modeled in full.
[arXiv:2404.16821]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=5e5,
    vis_tokens=256,       # stubbed patch embeddings prepended to the text
)
