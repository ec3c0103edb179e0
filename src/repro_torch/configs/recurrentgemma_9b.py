"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — RG-LRU recurrent blocks + local attention, 2:1 pattern
(rec, rec, attn). Sub-quadratic: bounded local window + O(1) recurrent
state -> native long_500k. [arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,          # 12 full (rec,rec,attn) groups + 2 trailing rec
    d_model=4096,
    n_heads=16,
    kv_heads=1,           # MQA in the local-attention blocks
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    mlp="geglu",
    norm="rmsnorm",
    pattern=("rec", "rec", "attn"),
    local_window=2048,
    lru_width=4096,
    rope_theta=10000.0,
)
