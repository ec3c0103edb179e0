// expand_rows: where an expand kernel finds slot m of a query row
// (sm_90a). Every expand reads its slots through one of these sources:
// pq_adc_expand.cu (the PQ expands) and filter_rows.cuh (fused_expand.cu,
// fused_filter.cu: the pca expands and the unmasked filter).
//
// An expand scores the M = W * M0 neighbour slots of a row. Slot m's
// payload (PQ codes or low-dim floats) is row `pay_row` of a payload
// table with one row per slot, its validity is `ok`, `live` says whether
// its payload needs reading at all (false only for the slots of a
// gated-off popped node, which are masked whatever their payload; known
// with the row's address, so a read gated on it waits on nothing more),
// and `id` is what the top-k writes for a winner:
//
//   * Blocks: the payload was gathered beforehand into a [B, M, width]
//     block with a [B, M] validity mask (the reference's op; no mask,
//     every slot valid, when `valid` is null); pay_row = row * M + m and
//     id = m.
//   * Rows: the gather fused in. Slot m is neighbour j = m % M0 of the
//     popped node c = cw[row, m / M0] when its gate exp[row, m / M0] is
//     set, else of node 0 (a gated-off slot reads row 0, as the
//     reference's index_select of c_safe does; a -1 pop with its gate
//     set is clamped to node 0 and scored, as the reference's
//     jnp.maximum(c_w, 0)); the payload is row c * M0 + j of the layer's
//     layout-(3) table [N, M0, width], ok = adj[c, j] >= 0 && gate, and
//     id = adj[c, j], the neighbour itself. cw is read through a row
//     stride, so the popped ids stay a view of the candidate frontier C
//     [B, CAP]. Stacked (the slotted sharded programs: every shard's
//     slots in one launch, as the reference's vmap adds a shard axis to
//     its Pallas grid), the tables are [P, N, M0, ...] and the B rows
//     shard-major: row r reads shard r / shard_b's table, at node offset
//     (r / shard_b) * shard_n (its own node 0 where gated off), and the
//     ids it writes are that shard's local ids. Unstacked, shard_n is 0.
//
// Rows' slots also come as groups() = W groups of group_size() = M0
// slots whose payload rows are contiguous (the popped nodes' [M0, width]
// blocks): group_row() gives a group's first payload row and its gate,
// so a kernel can stage a row's payload node by node and skip the
// gated-off ones (filter_rows.cuh).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace expand_rows {

struct Slot {
  size_t pay_row;
  int32_t id;
  bool ok;
  bool live;
};

struct Blocks {
  const uint8_t* valid;  // [B, M], or null: every slot counts
  int M;
  __device__ __forceinline__ Slot at(int row, int m) const {
    const size_t r = (size_t)row * M + m;
    return {r, m, valid == nullptr || valid[r] != 0, true};
  }
  __device__ __forceinline__ int32_t id(int row, int m) const { return m; }
};

struct Rows {
  const int32_t* adj;    // [N, M0]
  const int32_t* cw;     // [B, W], row stride cw_stride
  long long cw_stride;
  const uint8_t* gate;   // [B, W]
  int W, M0;
  int shard_b;           // rows a shard (B when unstacked)
  long long shard_n;     // nodes a shard's table (0 when unstacked)
  __host__ __device__ int groups() const { return W; }
  __host__ __device__ int group_size() const { return M0; }
  // popped node w's first row of the [P * N * M0] tables and its gate
  // (both words are loaded at once: the id does not wait on the gate)
  __device__ __forceinline__ size_t group_row(int row, int w,
                                              bool& g) const {
    g = gate[(size_t)row * W + w] != 0;
    const int32_t c = max(cw[(size_t)row * cw_stride + w], 0);
    const size_t base = (size_t)(row / shard_b) * (size_t)shard_n;
    return (base + (g ? (size_t)c : 0)) * M0;
  }
  // slot m's row of the [P * N * M0] tables and its gate
  __device__ __forceinline__ size_t node_row(int row, int m, bool& g) const {
    const int w = m / M0;
    return group_row(row, w, g) + (m - w * M0);
  }
  __device__ __forceinline__ Slot at(int row, int m) const {
    bool g;
    const size_t r = node_row(row, m, g);
    const int32_t nb = adj[r];
    return {r, nb, nb >= 0 && g, g};
  }
  __device__ __forceinline__ int32_t id(int row, int m) const {
    bool g;
    return adj[node_row(row, m, g)];
  }
};

// A winner's id for block_topk::write_topk: the source's id of slot m.
template <class Src>
struct SrcId {
  Src src;
  int row;
  __device__ __forceinline__ int32_t operator()(int m) const {
    return src.id(row, m);
  }
};

}  // namespace expand_rows
