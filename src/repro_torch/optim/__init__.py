"""Optimizer and gradient compression (port of ``repro/optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     cosine_lr, global_norm)
from repro_torch.optim.compression import compress_grads, decompress_grads

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm", "compress_grads", "decompress_grads"]
