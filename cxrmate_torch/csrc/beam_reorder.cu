// Beam reorder + column write on the self-attention K/V cache, in place.
//
// Replaces cxrmate_tpu/ops/beam_reorder.py:58 beam_reorder_write (Pallas, TPU).
// For each group of `beams` rows (one study's beams): row j of the cache takes
// the old row sel[j] of its group, and, when index >= 0, column `index` of row
// j takes the new K/V of source row sel[j]. Pure data movement: bit-exact.
//
// Bound on the H100: bytes - one read and one write of the self K/V cache per
// layer per step.
//
// Design: the TPU kernel snapshots a whole group's [beams, H, T, dh] block
// before writing (beam_reorder.py:43-44); at 1.5 MB in bf16 (T = 256) that
// does not fit in shared memory. Here each block owns one (group, head, tile
// of 32 columns): it copies the tile of all `beams` source rows into shared
// memory with 16-byte loads, synchronises, then writes the permuted rows, the
// new column where `index` falls in its tile. Blocks own disjoint regions, so
// the update is safe in place with no ordering between blocks. K and V are
// done one after the other by the same block.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 32;  // cache columns (time steps) per block

__global__ void __launch_bounds__(kThreads)
beam_reorder_kernel(uint4* __restrict__ ck, uint4* __restrict__ cv, const uint4* __restrict__ nk,
                    const uint4* __restrict__ nv, const int* __restrict__ sel, int index,
                    int beams, int heads, int t_len, int row_vecs) {
  extern __shared__ uint4 tile[];  // [beams][kCols][row_vecs]
  const int t0 = blockIdx.x * kCols, h = blockIdx.y, g = blockIdx.z;
  const int nt = min(kCols, t_len - t0);
  const int per_row = nt * row_vecs;  // 16-byte vectors of one row's tile
  const int total = beams * per_row;
  for (int which = 0; which < 2; ++which) {
    uint4* cache = which ? cv : ck;
    const uint4* fresh = which ? nv : nk;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int j = i / per_row, r = i % per_row;
      const size_t row = (size_t)g * beams + j;
      tile[j * kCols * row_vecs + r] = cache[((row * heads + h) * t_len + t0) * row_vecs + r];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int j = i / per_row, r = i % per_row;
      const int src = sel[g * beams + j];
      const int t = t0 + r / row_vecs;
      const size_t row = (size_t)g * beams + j;
      const size_t src_row = (size_t)g * beams + src;
      cache[((row * heads + h) * t_len + t0) * row_vecs + r] =
          t == index ? fresh[(src_row * heads + h) * row_vecs + r % row_vecs]
                     : tile[src * kCols * row_vecs + r];
    }
    __syncthreads();  // the tile buffer is reused for V
  }
}

}  // namespace

// cache_k/cache_v [R, H, T, dh], new_k/new_v [R, H, dh], sel [R] int32 with
// values in [0, beams); row_bytes = dh * element size, a multiple of 16.
extern "C" int cxr_beam_reorder_write(void* cache_k, void* cache_v, const void* new_k,
                                      const void* new_v, const void* sel, int index, int rows,
                                      int beams, int heads, int t_len, int row_bytes,
                                      void* stream) {
  if (row_bytes % 16 != 0 || rows % beams != 0) return cudaErrorInvalidValue;
  const int row_vecs = row_bytes / 16;
  const size_t smem = (size_t)beams * kCols * row_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_reorder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((t_len + kCols - 1) / kCols, heads, rows / beams);
  beam_reorder_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(cache_k), static_cast<uint4*>(cache_v),
      static_cast<const uint4*>(new_k), static_cast<const uint4*>(new_v),
      static_cast<const int*>(sel), index, beams, heads, t_len, row_vecs);
  return cudaGetLastError();
}
