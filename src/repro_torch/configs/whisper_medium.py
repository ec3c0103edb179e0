"""whisper-medium [audio]: 24L d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=51865 — encoder-decoder, conv audio frontend stubbed (input_specs
provides precomputed frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,          # decoder layers
    enc_layers=24,        # encoder layers
    d_model=1024,
    n_heads=16,
    kv_heads=16,          # MHA
    head_dim=64,
    d_ff=4096,
    vocab=51865,
    mlp="gelu",
    norm="layernorm",
    qkv_bias=True,
    enc_frames=1500,      # 30 s audio -> 1500 frames after the conv stub
    rope_theta=0.0,       # whisper uses learned/sinusoidal positions
    norm_eps=1e-5,
)
