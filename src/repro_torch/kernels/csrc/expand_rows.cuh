// expand_rows: where an expand kernel finds slot m of a query row
// (sm_90a). Written for every expand: pq_adc_expand.cu uses it, and the
// pca expand (fused_expand) takes it over unchanged.
//
// An expand scores the M = W * M0 neighbour slots of a row. Slot m's
// payload (PQ codes or low-dim floats) is row `pay_row` of a payload
// table with one row per slot, its validity is `ok`, and `id` is what the
// top-k writes for a winner:
//
//   * Blocks: the payload was gathered beforehand into a [B, M, width]
//     block with a [B, M] validity mask (the reference's op); pay_row =
//     row * M + m and id = m.
//   * Rows: the gather fused in. Slot m is neighbour j = m % M0 of the
//     popped node c = cw[row, m / M0] when its gate exp[row, m / M0] is
//     set, else of node 0 (a gated-off slot reads row 0, as the
//     reference's index_select of c_safe does); the payload is row
//     c * M0 + j of the layer's layout-(3) table [N, M0, width], ok =
//     adj[c, j] >= 0 && gate, and id = adj[c, j], the neighbour itself.
//     cw is read through a row stride, so the popped ids stay a view of
//     the candidate frontier C [B, CAP].
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace expand_rows {

struct Slot {
  size_t pay_row;
  int32_t id;
  bool ok;
};

struct Blocks {
  const uint8_t* valid;  // [B, M]
  int M;
  __device__ __forceinline__ Slot at(int row, int m) const {
    const size_t r = (size_t)row * M + m;
    return {r, m, valid[r] != 0};
  }
  __device__ __forceinline__ int32_t id(int row, int m) const { return m; }
};

struct Rows {
  const int32_t* adj;    // [N, M0]
  const int32_t* cw;     // [B, W], row stride cw_stride
  long long cw_stride;
  const uint8_t* gate;   // [B, W]
  int W, M0;
  // slot m's row of the [N * M0] tables and its gate
  __device__ __forceinline__ size_t node_row(int row, int m, bool& g) const {
    const int w = m / M0;
    g = gate[(size_t)row * W + w] != 0;
    const int32_t c = g ? max(cw[(size_t)row * cw_stride + w], 0) : 0;
    return (size_t)c * M0 + (m - w * M0);
  }
  __device__ __forceinline__ Slot at(int row, int m) const {
    bool g;
    const size_t r = node_row(row, m, g);
    const int32_t nb = adj[r];
    return {r, nb, nb >= 0 && g};
  }
  __device__ __forceinline__ int32_t id(int row, int m) const {
    bool g;
    return adj[node_row(row, m, g)];
  }
};

}  // namespace expand_rows
