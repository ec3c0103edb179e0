"""Per-kernel cost table on the card: the port of
``benchmarks/bench_kernel_footprint.py``.

    python -m repro_torch.bench.kernel_footprint [--out FILE]

Six rows at the reference bench's shapes and seed (``default_rng(0)``,
drawn in its order): ``dist_l`` [64, 32, 15], ``ksort_l`` [64, 32] k=16
(on ``dist_l``'s output), ``dist_h`` [64, 16, 128], ``fused_filter``
[64, 32, 15] k=16, ``flash_attention`` B=1 H=4 S=T=512 d=64 bf16 causal
(q = k = v, as the reference calls it) and ``decode_attention`` B=1 H=4
T=4096 d=64 bf16 at full length (k = v). Each row prints
``kernels/<name>,<us per call>,<derived>``, as the reference's ``emit``
does. The time is the device time of one call of the port's op, from
CUDA-graph replays timed with CUDA events (the reference takes the host
clock over three calls). ``derived`` gives the card's own counts: bytes
(each distinct input read once, each output written once: the flash row's
one tensor stands for q, k and v, the decode row's one cache for k and
v), operations, the bound
(the larger of bytes over the HBM rate and operations over the peak of
their type: bf16 tensor cores for bf16 attention, the f32 rate
otherwise), which of the two bounds it, and the kernel's shared memory
per block. The TPU's ``vmem_block_bytes`` has no counterpart here. The
bench needs a CUDA device and raises without one; nothing is timed on
the CPU. ``--out`` writes the rows as JSON; it never writes
``BENCH_table3.json``.

``graph_ms`` and ``bound_ms`` are the one timer and the one bound of the
port's measurements, ``launch_floor_ms`` the floor under them (an empty
kernel's replay), and ``attention_excess`` the one attention tolerance
of its checks (``chip_smoke.py`` uses them too)."""
from __future__ import annotations

import argparse
import json
import subprocess
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ksort_l import ksort_plan

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth,
# the f32 rate outside the tensor cores and the bf16 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12
VMEM_NOTE = "n/a (a TPU VMEM block; no counterpart on the card)"
# an H100's opt-in shared memory a block (bytes), for plans made without
# a card
SMEM_OPTIN = 232_448


def graph_ms(fn: Callable, reps: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in one
    CUDA graph, replayed ``replays`` times between two CUDA events — no
    host launch overhead in the figure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (reps * replays)


def launch_floor_ms() -> float:
    """``graph_ms`` of a kernel that does nothing (``csrc/empty.cu``, one
    block of one warp): the least any kernel of the port costs in a CUDA
    graph replay, the floor under every small kernel's time."""
    import ctypes
    from repro_torch.kernels import _build
    lib = _build.load("empty")
    fn = lib.empty_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def launch():
        _build.check(lib, "empty", fn(torch.cuda.current_stream()
                                      .cuda_stream))
    return graph_ms(launch)


def device_kernels(fn: Callable) -> int:
    """Device-side operations (kernels, copies, sets) of one ``fn()``
    call: the nodes of a CUDA graph that captures it, after a warm-up
    call (libcuda's ``cuGraphGetNodes``; a profiler's trace can miss a
    kernel of a few microseconds)."""
    import ctypes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(g.raw_cuda_graph()), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUDA error {err}")
    return int(n.value)


def bound_ms(nbytes: float, ops_: float,
             peak_ops: float = PEAK_F32_OPS_PER_S) -> tuple:
    """(least time in ms, "bytes" or "operations"): the larger of the
    bytes over the HBM rate and the operations over ``peak_ops``."""
    tb, to = nbytes / PEAK_BYTES_PER_S, ops_ / peak_ops
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


# attention against its plain version: |got - want| <= rtol * |want| +
# row * rms(want's row over d). bf16: one output ulp (<= |want| / 128)
# plus 1/32 of the row's RMS for the plain version's rounding of the
# weights to bf16 before PV; f32: both 1e-4. The RMS term scales with the
# outputs, which shrink as 1/sqrt(keys seen) (a flat absolute tolerance
# would pass a dropped kv tile on a long row); a row that sees no key has
# RMS 0 and must match exactly.
ATTN_ROW_TOL = {torch.float32: (1e-4, 1e-4),
                torch.bfloat16: (2 ** -7, 2 ** -5)}


def attention_excess(got, want) -> float:
    """max |got - want| / (rtol * |want| + row * rms) over the elements
    of [..., d] outputs, at ``ATTN_ROW_TOL`` for want's dtype: at most 1
    passes."""
    rtol, row = ATTN_ROW_TOL[want.dtype]
    g, w = got.float(), want.float()
    lim = rtol * w.abs() + row * w.pow(2).mean(-1, keepdim=True).sqrt()
    err = (g - w).abs()
    return float(torch.where(err > 0, err / lim, torch.zeros_like(err))
                 .amax()) if err.numel() else 0.0


def attention_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """Visible (query, key) pairs of one head: query row i at position
    i + T - S sees key t iff t <= pos (causal) and pos - t < window."""
    pos = np.arange(S, dtype=np.int64) + (T - S)
    hi = np.minimum(pos, T - 1) if causal else np.full(S, T - 1, np.int64)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_cost(B: int, H: int, S: int, T: int, d: int, itemsize: int,
               causal: bool, window: int, same_qkv: bool = False
               ) -> Dict[str, float]:
    """q, k, v read once and the output written once (``same_qkv``: one
    tensor is q, k and v, read once); 4*d operations (QK^T and PV
    multiply-adds) per visible pair."""
    reads = S if same_qkv else S + 2 * T
    return {"bytes": B * H * (reads + S) * d * itemsize,
            "ops": 4 * d * B * H * attention_pairs(S, T, causal, window)}


def decode_cost(H: int, d: int, itemsize: int, lengths, T: int,
                same_kv: bool = False) -> Dict[str, float]:
    """The valid K/V prefix of every (b, h) (``same_kv``: one cache is k
    and v, read once), q, the output and ``length``; 4*d operations per
    valid key."""
    valid = int(np.clip(np.asarray(lengths), 0, T).sum())
    B = len(lengths)
    caches = 1 if same_kv else 2
    return {"bytes": caches * H * valid * d * itemsize
            + 2 * B * H * d * itemsize
            + 4 * B, "ops": 4 * d * H * valid}


def fused_filter_cost(B: int, M: int, dl: int, k: int,
                      itemsize: int = 4) -> Dict[str, float]:
    """The [B, M, dl] block (``itemsize`` bytes an element: 4 f32, 2
    bf16), the f32 q and the (f32, int32) outputs; Dist.L's 3 operations
    per element and M compares per element's rank."""
    return {"bytes": itemsize * B * M * dl + 4 * B * dl + 8 * B * k,
            "ops": 3 * B * M * dl + B * M * M}


def _row_specs():
    """(name, shape, cost, peak, shared memory per block) of each row."""
    B, M, dl, K, D = 64, 32, 15, 16, 128
    Bq, H, S, hd, Td = 1, 4, 512, 64, 4096
    return [
        ("kernels/dist_l", [B, M, dl],
         {"bytes": 4 * (B * M * dl + B * dl + B * M), "ops": 3 * B * M * dl},
         PEAK_F32_OPS_PER_S, 0),
        ("kernels/ksort_l", [B, M, K],
         {"bytes": 4 * B * M + 8 * B * K,
          "ops": B * M * max(M - 1, 1).bit_length()},
         PEAK_F32_OPS_PER_S, ksort_plan(M, SMEM_OPTIN)["smem"]),
        ("kernels/dist_h", [B, K, D],
         {"bytes": 4 * (B * K * D + B * D + B * K), "ops": 3 * B * K * D},
         PEAK_F32_OPS_PER_S, 0),
        ("kernels/fused_filter", [B, M, dl, K], fused_filter_cost(B, M, dl, K),
         PEAK_F32_OPS_PER_S, 0),
        ("kernels/flash_attention", [Bq, H, S, S, hd],
         flash_cost(Bq, H, S, S, hd, 2, True, 0, same_qkv=True),
         PEAK_BF16_OPS_PER_S,
         _flash.smem_bytes(hd, torch.bfloat16)),
        ("kernels/decode_attention", [Bq, H, Td, hd],
         decode_cost(H, hd, 2, [Td] * Bq, Td, same_kv=True),
         PEAK_BF16_OPS_PER_S,
         _decode.split_plan(Bq * H, Td, hd, 2)["smem"]),
    ]


def plan() -> List[dict]:
    """The six rows' names, shapes and derived counts; needs no card."""
    rows = []
    for name, shape, cost, peak, smem in _row_specs():
        ms, by = bound_ms(cost["bytes"], cost["ops"], peak)
        rows.append({"name": name, "shape": shape, "bytes": cost["bytes"],
                     "ops": cost["ops"], "peak_ops_per_s": peak,
                     "bound_us": ms * 1e3, "bound_by": by,
                     "smem_per_block_bytes": smem})
    return rows


def derived(row: dict) -> str:
    return (f"bytes={row['bytes']};ops={row['ops']};"
            f"bound_us={row['bound_us']:.4f};bound_by={row['bound_by']};"
            f"smem_per_block_bytes={row['smem_per_block_bytes']};"
            f"vmem_block_bytes={VMEM_NOTE}")


def make_calls(device) -> Dict[str, Tuple[Callable, Callable]]:
    """The reference bench's inputs, drawn from ``default_rng(0)`` in its
    order, and per row one call of the port's op and one of its plain
    version on the same tensors."""
    rng = np.random.default_rng(0)
    t = lambda a, dt=torch.float32: torch.from_numpy(a).to(dt).to(device)
    B, M, dl, K, D = 64, 32, 15, 16, 128
    x = t(rng.standard_normal((B, M, dl)))
    qv = t(rng.standard_normal((B, dl)))
    d = ops.dist_l(x, qv)
    xh = t(rng.standard_normal((B, K, D)))
    qh = t(rng.standard_normal((B, D)))
    Bq, H, S, hd = 1, 4, 512, 64
    qa = t(rng.standard_normal((Bq, H, S, hd)), torch.bfloat16)
    qd = t(rng.standard_normal((Bq, H, hd)), torch.bfloat16)
    kd = t(rng.standard_normal((Bq, H, 4096, hd)), torch.bfloat16)
    ln = torch.full((Bq,), 4096, dtype=torch.int32, device=device)
    return {
        "kernels/dist_l": (lambda: ops.dist_l(x, qv),
                           lambda: ref.dist_l_ref(x, qv)),
        "kernels/ksort_l": (lambda: ops.ksort_l(d, K),
                            lambda: ref.ksort_l_ref(d, K)),
        "kernels/dist_h": (lambda: ops.dist_h(xh, qh),
                           lambda: ref.dist_h_ref(xh, qh)),
        "kernels/fused_filter": (lambda: ops.fused_filter(x, qv, K),
                                 lambda: ref.fused_filter_ref(x, qv, K)),
        "kernels/flash_attention": (
            lambda: ops.flash_attention(qa, qa, qa, causal=True),
            lambda: ref.flash_attention_ref(qa, qa, qa, causal=True)),
        "kernels/decode_attention": (
            lambda: ops.decode_attention(qd, kd, kd, ln),
            lambda: ref.decode_attention_ref(qd, kd, kd, ln)),
    }


def run(calls=None) -> List[dict]:
    """Time every row's op on the card (``calls``: ``make_calls``'s, to
    time tensors the caller has checked); raises without a CUDA
    device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel-footprint bench times kernels on a "
                           "CUDA device; none is available")
    calls = calls or make_calls(torch.device("cuda"))
    rows = plan()
    for row in rows:
        row["us"] = graph_ms(calls[row["name"]][0]) * 1e3
        row["bound_share"] = row["bound_us"] / row["us"]
    return rows


def emit(rows) -> None:
    """Print the ``name,us_per_call,derived`` CSV rows (the reference's
    ``benchmarks/common.emit``)."""
    for row in rows:
        print(f"{row['name']},{row['us']:.3f},{derived(row)}", flush=True)


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the rows as JSON here")
    args = ap.parse_args(argv)
    rows = run()
    emit(rows)
    if args.out:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "nvidia_smi": smi, "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
