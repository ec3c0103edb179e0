"""pHNSW retrieval attention on a long-context decode, on the PyTorch
port: the paper's 3-step filter (PCA project -> low-dim top-k -> exact
rerank) applied to a transformer KV cache.

Runs a small dense model twice over the same 2048-token cache (exact
attention against retrieval attention, the same weights) and reports
the agreement of the decoded tokens, then the HBM-traffic arithmetic at
the production long_500k shape. On the card by default (B9 for the
exact decode), on the CPU with ``--device cpu``.

    PYTHONPATH=src python examples/long_context_decode_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import RetrievalConfig
from repro_torch.models import get_model

T = 2048
STEPS = 48


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)

    base = get_smoke_config("llama3-405b").replace(
        n_layers=4, d_model=128, n_heads=8, kv_heads=2, head_dim=32)
    retr = base.replace(retrieval=RetrievalConfig(enabled=True, d_low=16,
                                                  topk=512, block=16))
    api_d, api_r = get_model(base), get_model(retr)
    gen = torch.Generator(device=dev).manual_seed(0)
    model_r = api_r.init(gen, dev)
    model_d = api_d.init(None, dev)      # the dense model has no rp_proj
    missing = model_d.load_state_dict(model_r.state_dict(), strict=False)
    assert not missing.missing_keys, missing

    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, base.vocab, (1, T)).astype(np.int64)).to(dev)
    cd, cr = api_d.init_cache(1, T, dev), api_r.init_cache(1, T, dev)
    agree = 0
    for t in range(STEPS):
        lg_d, cd = api_d.decode_step(model_d, cd, toks[:, t:t + 1], t)
        lg_r, cr = api_r.decode_step(model_r, cr, toks[:, t:t + 1], t)
        agree += int(lg_d.argmax() == lg_r.argmax())
    print(f"greedy-token agreement over {STEPS} steps "
          f"(topk={retr.retrieval.topk}/{T} cache): {agree}/{STEPS}")

    # the production arithmetic (llama3-405b long_500k):
    cfg = get_config("llama3-405b")
    Tl, KV, Hd, dl = 524_288, cfg.kv_heads, cfg.resolved_head_dim, 16
    full = 2 * Tl * KV * Hd * 2
    filt = Tl * KV * dl * 2 + 4096 * KV * 2 * Hd * 2
    print("llama3-405b long_500k, per layer per decode step:")
    print(f"  exact attention reads {full / 1e9:.2f} GB of KV cache")
    print(f"  retrieval attention reads {filt / 1e9:.3f} GB "
          f"(low-dim keys + reranked blocks) -> {full / filt:.1f}x less HBM")


if __name__ == "__main__":
    main()
