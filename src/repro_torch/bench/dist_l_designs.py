"""The Dist.L kernel's two designs side by side on the card.

    python -m repro_torch.bench.dist_l_designs [--out FILE]

``csrc/dist_l.cu`` scores a row a thread, its dl loads unrolled and read
in place. The other design, carried here as ``TILE_SRC`` and built only
by this script, gives each block a contiguous tile of rows: the block
copies the tile's bytes into shared memory with coalesced 16-byte loads
(``ld.global.nc.v4``; the bytes before the first 16-byte boundary and
after the last one element by element), waits at a barrier, and then one
thread sums its row out of shared memory, in f32, ``c`` ascending. The
tile is ``tile`` rows, ``threads`` a block; ``tile_plans`` lists the
tiles timed: one sized from the SM count (one wave) and the fixed 128,
240 and 960.

At the search's three shapes ([1024, 60, 15], [1024, 1, 15], [64, 32,
15]), on f32 and bf16 integer rows, each design's output is held to the
plain version bit for bit and timed with ``graph_ms`` in the same
process, the kept kernel first and last. One JSON line a row: the shape,
the payload, the design, its plan and ms. The script needs a CUDA device
and raises without one."""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from typing import List

import numpy as np
import torch

from repro_torch.kernels import _build, ops, ref

SHAPES = ((1024, 60, 15), (1024, 1, 15), (64, 32, 15))
FIXED_TILES = (128, 240, 960)

TILE_SRC = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// x [rows, dl] (row r's query is q[r / K]); a block owns rows
// [blockIdx.x * tile, + tile). Shared memory holds the tile's bytes at
// the same offset mod 16 as in global memory, so the 16-byte vectors of
// both sides are aligned.
template <class Pay, int DL>
__global__ void dist_l_tile_kernel(const Pay* __restrict__ x,
                                   const float* __restrict__ q,
                                   float* __restrict__ out, long long rows,
                                   int K, int dl_rt, int tile) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int dl = DL > 0 ? DL : dl_rt;
  const long long r0 = (long long)blockIdx.x * tile;
  const int nr = (int)min((long long)tile, rows - r0);
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(x + r0 * dl);
  const int nbytes = nr * dl * (int)sizeof(Pay);
  const int mis = (int)(reinterpret_cast<uintptr_t>(src) & 15);
  unsigned char* dst = sm + mis;
  const int head = min(nbytes, (16 - mis) & 15);
  const int nvec = (nbytes - head) / 16;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  const int4* s4 = reinterpret_cast<const int4*>(src + head);
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) d4[i] = __ldg(s4 + i);
  for (int i = head + 16 * nvec + threadIdx.x; i < nbytes; i += blockDim.x)
    dst[i] = src[i];
  __syncthreads();
  const Pay* xs = reinterpret_cast<const Pay*>(dst);
  for (int j = threadIdx.x; j < nr; j += blockDim.x) {
    const long long r = r0 + j;
    const float* qr = q + (r / K) * dl;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < dl; ++c) {
      const float df = widen(xs[j * dl + c]) - __ldg(qr + c);
      acc += df * df;
    }
    out[r] = acc;
  }
}

template <class Pay>
int run(const void* x, const void* q, void* out, int B, int K, int dl,
        int tile, int threads, void* stream) {
  void (*kern)(const Pay*, const float*, float*, long long, int, int, int) =
      &dist_l_tile_kernel<Pay, 0>;
  if (dl == 15) kern = &dist_l_tile_kernel<Pay, 15>;
  if (dl == 16) kern = &dist_l_tile_kernel<Pay, 16>;
  const long long rows = (long long)B * K;
  const size_t smem = (size_t)tile * dl * sizeof(Pay) + 16;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<(unsigned)((rows + tile - 1) / tile), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Pay*>(x), static_cast<const float*>(q),
      static_cast<float*>(out), rows, K, dl, tile);
  return (int)cudaGetLastError();
}

extern "C" int dist_l_tile_launch(const void* x, const void* q, void* out,
                                  int B, int K, int dl, int tile,
                                  int threads, int bf16, void* stream) {
  return bf16 ? run<__nv_bfloat16>(x, q, out, B, K, dl, tile, threads,
                                   stream)
              : run<float>(x, q, out, B, K, dl, tile, threads, stream);
}
"""


def tile_plans(rows: int, sms: int) -> List[dict]:
    """The tile design's launches timed for ``rows`` rows on a card of
    ``sms`` SMs: the tile that gives one block an SM (rows over SMs, in
    whole warps), then each of ``FIXED_TILES`` that differs from it and
    is no larger than the rows in whole warps. ``threads`` is the tile
    in whole warps, at most 256; ``grid`` the blocks."""
    whole = lambda n: -(-n // 32) * 32
    tiles = [whole(-(-rows // sms))]
    tiles += [t for t in FIXED_TILES if t not in tiles and t <= whole(rows)]
    return [{"tile": t, "threads": min(256, whole(t)),
             "grid": -(-rows // t)} for t in tiles]


def _build_tile() -> ctypes.CDLL:
    h = hashlib.sha256(TILE_SRC.encode()
                       + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()
    lib = _build.BUILD_DIR / f"dist_l_tile-{h[:16]}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = lib.with_suffix(".cu")
        src.write_text(TILE_SRC)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    so.dist_l_tile_launch.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    so.dist_l_tile_launch.restype = ctypes.c_int
    return so


def main(argv=None) -> List[dict]:
    from repro_torch.bench.kernel_footprint import graph_ms
    from repro_torch.kernels._launch import sm_count
    from repro_torch.kernels.dist_l import dist_l_plan
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("dist_l_designs times kernels on a CUDA device; "
                           "none is available")
    dev = torch.device("cuda")
    sms = sm_count(dev)
    tile_lib = _build_tile()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)
    rows_out = []
    for B, K, dl in SHAPES:
        x = rng.integers(-64, 64, (B, K, dl)).astype(np.float32)
        q = torch.from_numpy(
            rng.integers(-64, 64, (B, dl)).astype(np.float32)).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            xt = torch.from_numpy(x).to(dev).to(dt)
            want = ref.dist_l_ref(xt, q)
            out = torch.empty_like(want)

            def tiled(p):
                err = tile_lib.dist_l_tile_launch(
                    xt.data_ptr(), q.data_ptr(), out.data_ptr(), B, K, dl,
                    p["tile"], p["threads"], int(dt == torch.bfloat16),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"dist_l_tile: CUDA error {err}")
                return out
            runs = [("row", dist_l_plan(B * K, sms),
                     lambda: ops.dist_l(xt, q))]
            runs += [("tile", p, (lambda p=p: tiled(p)))
                     for p in tile_plans(B * K, sms)]
            runs.append(runs[0])
            for design, plan, fn in runs:
                got = fn()
                torch.cuda.synchronize()
                row = {"shape": [B, K, dl], "payload": str(dt)[6:],
                       "design": design, "plan": plan,
                       "exact": bool(torch.equal(got, want)),
                       "ms": graph_ms(fn), "card": card}
                print(json.dumps(row), flush=True)
                rows_out.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows_out, f, indent=1)
    bad = [r for r in rows_out if not r["exact"]]
    if bad:
        raise SystemExit(f"{len(bad)} rows differ from the plain version")
    return rows_out


if __name__ == "__main__":
    main()
