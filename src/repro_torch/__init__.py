"""PyTorch/CUDA port of the pHNSW engine (``src/repro``), for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
module tree (``core/``, ``kernels/``, ``configs/``, ``data/``, ``index/``,
``serve/``, ``obs/``, ``distributed/``) and imports none of it. Entry points run on ``device="cuda"`` unless the caller asks
for ``device="cpu"``; a CPU tensor takes each kernel's plain PyTorch
version, a CUDA tensor launches the hand-written kernel (built at first
use from ``kernels/csrc``)."""
