"""Argument checks, the stream handle and the shared-memory limits shared
by the CUDA wrappers."""
from __future__ import annotations

import functools

import torch

# dynamic shared memory a block gets without opting in
SMEM_DEFAULT = 48 * 1024


@functools.lru_cache(maxsize=None)
def _optin(idx: int) -> int:
    return torch.cuda.get_device_properties(idx).shared_memory_per_block_optin


@functools.lru_cache(maxsize=None)
def _sms(idx: int) -> int:
    return torch.cuda.get_device_properties(idx).multi_processor_count


def sm_count(dev) -> int:
    """The SM count of CUDA device ``dev`` (132 on an H100 SXM), asked
    once per device."""
    idx = torch.device(dev).index
    return _sms(torch.cuda.current_device() if idx is None else idx)


def smem_optin(dev) -> int:
    """The most dynamic shared memory a block on CUDA device ``dev`` can
    opt into (cudaDevAttrMaxSharedMemoryPerBlockOptin: 227 KB on an
    H100), asked once per device."""
    idx = torch.device(dev).index
    return _optin(torch.cuda.current_device() if idx is None else idx)


def scratch_rows(plan: dict, B: int, dev):
    """The global scratch a host plan asks for, [B, plan["scratch"]]
    f32, or None when the kernel keeps its rows in shared memory."""
    if not plan["scratch"]:
        return None
    return torch.empty((B, plan["scratch"]), dtype=torch.float32,
                       device=dev)


def ptr(t) -> int:
    """A tensor's device pointer, 0 (a null pointer) for None."""
    return 0 if t is None else t.data_ptr()


def warps_for(n: int, most: int = 1024) -> int:
    """Threads of a block that gives each of n elements a thread, in
    whole warps, at most ``most``."""
    return min(most, max(32, -(-n // 32) * 32))


# the payload types of the Dist.L kernels (dist_l, the fused filters):
# rows stored in f32 or bf16, widened to f32 in registers
PAYLOAD_DTYPES = (torch.float32, torch.bfloat16)


def check_payload(t, name: str) -> None:
    """Raise unless ``t`` holds f32 or bf16 rows (a payload the Dist.L
    kernels read as it is)."""
    if t.dtype not in PAYLOAD_DTYPES:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32 "
                        "or torch.bfloat16 rows")


def check_cuda(t, dtype, shape, name: str, like=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (or of
    one of a tuple of dtypes) and ``shape`` (on the same device as
    ``like`` when given)."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if like is not None and t.device != like.device:
        raise ValueError(f"{name}: on {t.device}, expected {like.device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
