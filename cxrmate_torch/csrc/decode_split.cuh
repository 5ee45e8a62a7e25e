// One decode-attention call split over the blocks of a thread-block cluster:
// the kernel body that decode_attention.cu (any summation order, fma),
// decode_attention_vpu.cu (separate fp32 multiplies and adds in one fixed
// order), decode_attention_q8.cu (int8 K/V with per-key fp32 scales, fma) and
// fused_cross_attn.cu (the fused step's contract, below) instantiate. Each
// source's note states the contract, the bound and its own order of
// operations.
//
// Two contracts (the template parameter C). Decode: an additive fp32 [B, S]
// mask, a key skipped where it is exactly finfo(float32).min, a read key's
// score q.k x scale + mask, and the probs rounded to T before P.V. Fused (the
// fused decode step's cross-attention, M = 1): an integer [B, S] study mask
// shared by the heads, a key skipped where it is 0, a read key's score q.k x
// scale, and the probs kept fp32. With M = 1 the fused step's [B, D] query and
// context rows (the heads side by side) are the [B, H, 1, 64] layout here.
//
// Grid and cluster. One cluster of n_split <= 8 blocks (the portable cluster
// size) per (b, h), 128 threads a block, launched once per call with
// cudaLaunchKernelEx and cudaLaunchAttributeClusterDimension. S is cut into
// 64-key tiles, dealt to the blocks in turn: block `rank` owns the tiles
// rank, rank + n_split, rank + 2 n_split, ..., which hold at most `chunk`
// keys; its local key i is the key (rank + (i / 64) n_split) 64 + i % 64.
// Dealt so, the unmasked keys of a row, which lie in a few contiguous ranges
// (image slots, the written cache), spread evenly over the cluster's blocks,
// and the blocks' work over the SMs. n_split and chunk come from the wrapper
// (ops/decode_attention.py:decode_schedule), a function of (S, dh) alone.
//
// Per block:
//   0. The mask entries of the block's keys, one bit per key, four
//      neighbouring keys a thread (one 16-byte load where the mask's rows are
//      16-byte aligned), their 32-key words gathered by shuffles: a skipped
//      key's score is set to finfo.min without reading its K row. The tiles
//      that hold an unskipped key are listed; no other tile is visited.
//   1. The listed tiles' K rows, then their V rows, stream through a ring of
//      kRing tiles in shared memory by cp.async (16 bytes a lane, L2 only);
//      a warp copies exactly the rows it later reads (for fp32 and bf16 a
//      lane its own pieces; an int8 row is copied by 4 lanes and read by 8,
//      with a warp barrier between), so the ring needs no block barrier, and
//      kRing tiles are in flight at every step. Scores of
//      the unskipped keys go to shared memory, [m][chunk] fp32; then the
//      local max of each query row.
//   2. cluster.sync(); every block reads the n_split maxima through
//      distributed shared memory (map_shared_rank) and forms the row max.
//      The ring's next tiles, the first V tiles, are in flight meanwhile.
//   3. e = exp(score - max), the local sum of e; cluster.sync(); every block
//      adds the n_split sums in rank order, so all hold the same denominator.
//   4. p = round_to_T(e / sum), as the decode contract asks (the normalised
//      probs, rounded: an online softmax would round unnormalised partials;
//      the fused contract keeps e / sum); the partial context sum_s p[s]
//      v[s] of its keys in fp32, skipped keys' V rows not read.
// int8 K/V (KV = signed char): the K scale of a read key multiplies its dot
// before `scale` and the mask, ((q . kq) ks) scale + mask; its V scale, loaded
// with the score and kept in shared memory, multiplies the normalised prob
// before its one rounding, p = round_to_T((e / sum) vs); the int8 values are
// converted exactly and never scaled. A skipped key reads neither its rows nor
// its two scales.
//   5. The output's m x 64 elements are split over the ranks: each block
//      writes its partial context of an element into the owning rank's
//      shared memory (a remote store); cluster.sync(); each rank adds the
//      n_split partials of its elements in rank order and writes them. No
//      block reads another's memory after that barrier, so none waits for
//      the others to finish.
//
// Why skipping is exact. A skipped key's score is finfo.min: the plain
// version's q.k x scale + finfo.min (the fused contract's q.k x scale + (1 -
// mask) finfo.min alike) rounds to finfo.min for |q.k x scale| <
// 2^103, far above any score of finite bf16/fp32 activations, so its K row is
// never needed. Where the row max is above finfo.min (the row has an
// unmasked key), it is at least one ulp (2^104) above, so a skipped key's
// exp(finfo.min - max) is exactly +0.0 in fp32: it adds nothing to the sum,
// its p is +0.0 and p * v adds nothing to the context, whatever its V row
// holds (finite, as the plain version needs it). Where the max is finfo.min
// (a fully masked row), every skipped key has e = 1, the uniform softmax the
// plain version gives, and every V row of the block's keys is read. The max that
// tells the two apart is the cluster's, so every block decides alike. For int8
// K/V the same holds: the K scale multiplies a finite dot before the mask is
// added, and a skipped key's p is never formed, so neither scale is needed.
#pragma once

#include <algorithm>
#include <cfloat>
#include <cooperative_groups.h>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace cxr {
namespace split {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kDh = 64;        // head dim, the only one the paths have
constexpr int kTile = 64;      // keys per tile: the unit dealt to blocks and skipped
constexpr int kMaxSplit = 8;   // the portable cluster size
constexpr int kMaxM = 4;
// dynamic shared memory a block may take: the H100's 227 KB less 1 KB for
// the kernel's static shared memory
constexpr size_t kMaxSmem = 232448 - 1024;
constexpr float kSkip = -FLT_MAX;  // finfo(float32).min, the port's masked key

constexpr int kRing = 2;       // K/V tiles in flight a block

// The two contracts (see the top of the file): the mask's type, which
// entries skip a key, whether the mask is added to a read key's score and
// whether the probs are rounded to T.
struct Decode {
  using Mask = float;
  static constexpr bool kAddMask = true, kRoundP = true;
  static __host__ __device__ __forceinline__ bool skip(float x) { return x == kSkip; }
};
struct Fused {
  using Mask = int;
  static constexpr bool kAddMask = false, kRoundP = false;
  static __host__ __device__ __forceinline__ bool skip(int x) { return x == 0; }
};

__device__ __forceinline__ void ldg4(const float* p, float (&x)[4]) {
  const float4 w = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
}
__device__ __forceinline__ void ldg4(const int* p, int (&x)[4]) {
  const int4 w = __ldg(reinterpret_cast<const int4*>(p));
  x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
}

// Four neighbouring mask entries at p, n of them inside the row: one 16-byte
// load where vec says the row is 16-byte aligned (then n >= 4).
template <typename M>
__device__ __forceinline__ void load_mask4(const M* p, bool vec, int n, M (&x)[4]) {
  if (vec) {
    ldg4(p, x);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = j < n ? __ldg(p + j) : M(0);
  }
}

// The ring [kRing][kTile][kDh] of K/V values of `elem` bytes (after the V
// pass, the [kWarps][m][kDh] fp32 warp partials in its place), [m][chunk]
// scores, the ranks' partial contexts of the block's own output elements
// (n_split x ceil(m x kDh / n_split) <= m x kDh + kMaxSplit floats), one bit
// per key, the list of tiles to read and, for int8 K/V (elem 1), the V scales
// of the chunk's keys (ops/decode_attention.py:smem_bytes)
inline size_t smem_bytes(int m, int chunk, size_t elem) {
  return std::max(elem * kRing * kTile * kDh, sizeof(float) * kWarps * m * kDh) +
         sizeof(float) * ((size_t)m * chunk + (size_t)m * kDh + kMaxSplit) +
         sizeof(unsigned) * (chunk / 32) + sizeof(int) * (chunk / kTile) +
         (elem == 1 ? sizeof(float) * chunk : 0);
}

// fp32 arithmetic: the vpu kernel's separate, never contracted multiplies and
// adds (kExact), or decode_attention's fma.
template <bool kExact> struct Arith;
template <> struct Arith<true> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float mac(float acc, float a, float b) {
    return __fadd_rn(acc, __fmul_rn(a, b));
  }
};
template <> struct Arith<false> {
  static __device__ __forceinline__ float mul(float a, float b) { return a * b; }
  static __device__ __forceinline__ float add(float a, float b) { return a + b; }
  static __device__ __forceinline__ float sub(float a, float b) { return a - b; }
  static __device__ __forceinline__ float div(float a, float b) { return a / b; }
  static __device__ __forceinline__ float mac(float acc, float a, float b) {
    return fmaf(a, b, acc);
  }
};

// How a key row of 64 K/V values spreads over a warp. A lane reads one
// 16-byte piece of fp32 or bf16, and one 8-byte piece of int8, so that it
// holds 8 values of each query row as in bf16 (16 values would keep 64 fp32
// q values live through the K pass at M = 4, above the 72 registers that fit
// 7 blocks an SM). Rows are copied 16 bytes a lane: an int8 row by 4 lanes,
// two copies a lane a tile instead of four. A warp copies and reads the same
// rows of a tile: read step u of a warp reads the rows of its copy u / kPer.
template <typename KV> struct Rows {
  static constexpr int kBytes = sizeof(KV) == 1 ? 8 : 16;  // bytes a lane reads
  using Piece = typename std::conditional<sizeof(KV) == 1, uint2, uint4>::type;
  static constexpr int kVec = kBytes / sizeof(KV);  // values a lane: 4 fp32, 8 bf16, 8 int8
  static constexpr int kLpk = kDh / kVec;           // lanes a key row: 16, 8, 8
  static constexpr int kKpw = 32 / kLpk;            // key rows a warp read: 2, 4, 4
  static constexpr int kStep = kWarps * kKpw;       // key rows a block read: 8, 16, 16
  static constexpr int kLoads = kTile / kStep;      // reads a lane a tile: 8, 4, 4
  static constexpr int kCopyLpk = kDh * (int)sizeof(KV) / 16;  // lanes copying a row: 16, 8, 4
  static constexpr int kCopyKpw = 32 / kCopyLpk;    // key rows a warp copy: 2, 4, 8
  static constexpr int kCopies = kTile / (kWarps * kCopyKpw);  // copies a lane a tile: 8, 4, 2
  static constexpr int kPer = kCopyKpw / kKpw;      // reads a copy: 1, 1, 2
  // A lane's tile row at copy c is c * kWarps * kCopyKpw + (warp * kCopyKpw +
  // its copy sub-row), at read step u read_step(u) + (warp * kCopyKpw + its
  // read sub-row): for fp32 and bf16 u * kStep + (warp * kKpw + sub).
  __host__ __device__ static constexpr int read_step(int u) {
    return (u / kPer) * kWarps * kCopyKpw + (u % kPer) * kKpw;
  }
};

// A lane's piece of a K/V row as fp32 (int8 -> fp32 is exact: the byte,
// biased by 128, as the low mantissa bits of 2^23, less 2^23 + 128).
__device__ __forceinline__ void unpack_kv(const uint4& v, float* f, float) {
  cxr::unpack16<float>(v, f);
}
__device__ __forceinline__ void unpack_kv(const uint4& v, float* f, __nv_bfloat16) {
  cxr::unpack16<__nv_bfloat16>(v, f);
}
__device__ __forceinline__ void unpack_kv(const uint2& v, float* f, signed char) {
  const unsigned w[2] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = __int_as_float(__byte_perm(w[i], 0x4B000000u, 0x7650 + j)) - 8388736.f;
}

// The V query values of row r a lane li holds: q's values li * V .. li * V +
// V - 1, as 16-byte loads of T.
template <typename T, int V>
__device__ __forceinline__ void load_q(const T* q, int r, int li, float* qf) {
  constexpr int kPer = 16 / sizeof(T);
  const uint4* q4 = reinterpret_cast<const uint4*>(q + r * kDh + li * V);
#pragma unroll
  for (int j = 0; j < V / kPer; ++j) cxr::unpack16<T>(__ldg(q4 + j), qf + j * kPer);
}

// The key of a block's local key index i (its tiles dealt every n_split).
__device__ __forceinline__ int global_key(int i, int rank, int n_split) {
  return (rank + (i / kTile) * n_split) * kTile + i % kTile;
}

__device__ __forceinline__ bool unskipped(const unsigned* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage the block's tile t (the (b, h)'s tile gt) of K or V rows (base) into
// a ring slot: copy c of a lane (row = warp * kCopyKpw + its copy sub-row,
// cl its 16-byte piece of the key row) copies its piece of tile row c *
// kWarps * kCopyKpw + row where it is taken, to the place its warp reads it
// back from. Always one commit group, empty or not, so that every lane counts
// the same groups.
template <typename KV>
__device__ __forceinline__ void stage_tile(uint4* slot, const uint4* base, const unsigned* bits,
                                           int t, int gt, int row, int cl, bool all, int len) {
  using R = Rows<KV>;
#pragma unroll
  for (int c = 0; c < R::kCopies; ++c) {
    const int i = t * kTile + c * kWarps * R::kCopyKpw + row;
    if (all ? i < len : unskipped(bits, i))
      cp_async16(slot + (c * kWarps * R::kCopyKpw + row) * R::kCopyLpk + cl,
                 base + ((size_t)gt * kTile + c * kWarps * R::kCopyKpw + row) * R::kCopyLpk + cl);
  }
  cp_async_commit();
}

// The MM partial dots of a lane summed over the kLpk lanes of its key row by
// a balanced tree over neighbouring lanes (xor 1, 2, 4, ...). For MM = 4 the
// first two levels also scatter the rows (two shuffles, then one), so lane
// li ends with the sum of row 2 (li & 1) + ((li >> 1) & 1) in acc[0]; the
// same tree, the same bits, a third of the shuffles. -> the row it holds.
template <typename A, int MM, int kLpk>
__device__ __forceinline__ int reduce_rows(float (&acc)[MM], int li) {
  int first = 1;
  int held = 0;
  if constexpr (MM == 4) {
    const bool odd = li & 1, hi = li & 2;
    const float s0 = odd ? acc[0] : acc[2], s1 = odd ? acc[1] : acc[3];
    float k0 = odd ? acc[2] : acc[0], k1 = odd ? acc[3] : acc[1];
    k0 = A::add(k0, __shfl_xor_sync(0xffffffffu, s0, 1));
    k1 = A::add(k1, __shfl_xor_sync(0xffffffffu, s1, 1));
    acc[0] = A::add(hi ? k1 : k0, __shfl_xor_sync(0xffffffffu, hi ? k0 : k1, 2));
    held = (odd ? 2 : 0) + (hi ? 1 : 0);
    first = 4;
  } else {
    static_assert(MM == 1, "the kernel is built for MM = 1 and MM = 4");
  }
#pragma unroll
  for (int off = first; off < kLpk; off <<= 1)
    acc[0] = A::add(acc[0], __shfl_xor_sync(0xffffffffu, acc[0], off));
  return held;
}

// q . k over a lane's kVec values: runs of four consecutive values, each
// ((p0 + p1) + p2) + p3, two runs (bf16) added to each other.
template <typename A, int V>
__device__ __forceinline__ float dot_lane(const float* qf, const float* kf) {
  float run[V / 4];
#pragma unroll
  for (int j = 0; j < V / 4; ++j) {
    float acc = A::mul(kf[4 * j], qf[4 * j]);
#pragma unroll
    for (int e = 1; e < 4; ++e) acc = A::mac(acc, kf[4 * j + e], qf[4 * j + e]);
    run[j] = acc;
  }
  return V / 4 == 1 ? run[0] : A::add(run[0], run[1]);
}

// q and the output are T; K and V are KV: T itself, or signed char with the
// fp32 scales ks and vs ([B, H, 1, S]; null otherwise); the mask is C's. bf16
// and int8 K/V: at most 72 registers, so that the 96 clusters of 8 blocks of a
// cross call (8 studies x 12 heads) are resident at once (7 blocks an SM)
template <typename T, typename KV, int MM, bool kExact, typename C = Decode>
__global__ void __launch_bounds__(kThreads, sizeof(KV) <= 2 ? 7 : 3)
decode_split_kernel(const T* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
                    const float* __restrict__ ks, const float* __restrict__ vs,
                    const typename C::Mask* __restrict__ mask, T* __restrict__ o, int heads,
                    int m, int s_len, int chunk, float scale) {
  using Mask = typename C::Mask;
  using A = Arith<kExact>;
  using R = Rows<KV>;
  using P = typename R::Piece;
  constexpr bool kQ8 = std::is_same<KV, signed char>::value;
  constexpr int kSlot = kTile * R::kCopyLpk;  // 16-byte copies of one ring slot
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // clusters in launch order take the heads fastest: on the H100 that
  // spread the rows' unmasked tiles over the SMs more evenly than taking the
  // rows fastest (PERF.md, the split kernels' findings)
  const int bh = blockIdx.x / n_split, b = bh / heads;
  // the block's tiles, its last one (perhaps a part tile) and its keys
  const int tiles = ((s_len + kTile - 1) / kTile - rank + n_split - 1) / n_split;
  const int last = rank + (tiles - 1) * n_split;
  const int len = (tiles - 1) * kTile + min(kTile, s_len - last * kTile);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* ring = reinterpret_cast<uint4*>(smem_raw);  // [kRing][kSlot]
  float* part = reinterpret_cast<float*>(smem_raw);  // [kWarps][m][kDh], once the ring is idle
  // [m][chunk]: scores, then e, then probs
  float* sc = reinterpret_cast<float*>(smem_raw + max(kRing * kSlot * 16, kWarps * m * kDh * 4));
  // output elements [rank * owned, (rank + 1) * owned) are this block's; the
  // partial context of its element e from rank rr lands in gather[rr * owned + e]
  const int owned = (m * kDh + n_split - 1) / n_split;
  float* gather = sc + (size_t)m * chunk;  // [n_split * owned]
  unsigned* bits = reinterpret_cast<unsigned*>(gather + m * kDh + kMaxSplit);  // [chunk / 32]
  int* listed = reinterpret_cast<int*>(bits + chunk / 32);          // [chunk / kTile]
  float* vsc = reinterpret_cast<float*>(listed + chunk / kTile);   // [chunk], int8 K/V only
  __shared__ float red[MM * kWarps];
  __shared__ float xmax[MM], xsum[MM];  // read by the cluster
  __shared__ int n_listed;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / R::kLpk;  // key row within the warp's read
  const int li = lane % R::kLpk;   // the lane's piece of the key row
  const int row = warp * R::kCopyKpw + sub;  // + read_step(u): the lane's key row at step u
  const int crow = warp * R::kCopyKpw + lane / R::kCopyLpk, cl = lane % R::kCopyLpk;  // copies
  const Mask* mb = mask + (size_t)b * s_len;
  const uint4* k4 = reinterpret_cast<const uint4*>(k + (size_t)bh * s_len * kDh);
  const uint4* v4 = reinterpret_cast<const uint4*>(v + (size_t)bh * s_len * kDh);
  const float* ksb = kQ8 ? ks + (size_t)bh * s_len : nullptr;  // the scales are [B, H, 1, S]
  const float* vsb = kQ8 ? vs + (size_t)bh * s_len : nullptr;

  float qf[MM][R::kVec];
#pragma unroll
  for (int r = 0; r < MM; ++r) {
    if (r < m) {
      load_q<T, R::kVec>(q + (size_t)bh * m * kDh, r, li, qf[r]);
    } else {
#pragma unroll
      for (int e = 0; e < R::kVec; ++e) qf[r][e] = 0.f;
    }
  }
  // 0: which keys are read, the local keys 4 tid .. 4 tid + 3 of a round (of
  // one tile, neighbours in S); skipped keys' scores are finfo.min
  const bool vec = (s_len & 3) == 0 && (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  for (int base = 0; base < tiles * kTile; base += 4 * kThreads) {
    const int i = base + 4 * tid;
    unsigned nib = 0;  // bit j: local key i + j is read
    if (i < len) {
      Mask mv[4];
      load_mask4(mb + global_key(i, rank, n_split), vec, len - i, mv);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i + j < len) {
          if (!C::skip(mv[j])) {
            nib |= 1u << j;
          } else {
            for (int r = 0; r < m; ++r) sc[r * chunk + i + j] = kSkip;
          }
        }
    }
    // a 32-key word is the nibbles of 8 neighbouring lanes
    unsigned word = nib << (4 * (lane & 7));
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) word |= __shfl_xor_sync(0xffffffffu, word, off);
    if ((lane & 7) == 0 && i < tiles * kTile) bits[i >> 5] = word;
  }
  __syncthreads();
  if (warp == 0) {  // the tiles that hold an unskipped key, in order
    int count = 0;
    for (int t0 = 0; t0 < tiles; t0 += 32) {
      const int t = t0 + lane;
      const bool some = t < tiles && (bits[2 * t] | bits[2 * t + 1]);
      const unsigned found = __ballot_sync(0xffffffffu, some);
      if (some) listed[count + __popc(found & ((1u << lane) - 1u))] = t;
      count += __popc(found);
    }
    if (lane == 0) n_listed = count;
  }
  __syncthreads();
  const int nt = n_listed;

  // 1: the ring's job j is K of listed tile j (j < nt), then V of listed
  // tile j - nt; kRing jobs are in flight whenever one is read
  auto stage = [&](int j) {
    if (j < 2 * nt) {
      const int t = listed[j < nt ? j : j - nt];
      stage_tile<KV>(ring + (j % kRing) * kSlot, j < nt ? k4 : v4, bits, t,
                     rank + t * n_split, crow, cl, false, len);
    } else {
      cp_async_commit();
    }
  };
#pragma unroll
  for (int j = 0; j < kRing; ++j) stage(j);
  for (int j = 0; j < nt; ++j) {
    cp_async_wait<kRing - 1>();
    if (R::kPer > 1) __syncwarp();  // the warp's other lanes copied some of the pieces
    const P* slot = reinterpret_cast<const P*>(ring + (j % kRing) * kSlot);
    const int t = listed[j];
#pragma unroll
    for (int u = 0; u < R::kLoads; ++u) {
      const int i = t * kTile + R::read_step(u) + row;
      const bool take = unskipped(bits, i);  // else the lane's piece is stale, and unused
      float kf[R::kVec];
      unpack_kv(slot[(R::read_step(u) + row) * R::kLpk + li], kf, KV());
      float acc[MM];
#pragma unroll
      for (int r = 0; r < MM; ++r) acc[r] = dot_lane<A, R::kVec>(qf[r], kf);
      const int r = reduce_rows<A, MM, R::kLpk>(acc, li);
      if (li < MM && take && r < m) {
        const int gk = global_key(i, rank, n_split);
        if constexpr (kQ8) {
          sc[r * chunk + i] =
              A::add(A::mul(A::mul(acc[0], __ldg(ksb + gk)), scale), __ldg(mb + gk));
          if (li == 0) vsc[i] = __ldg(vsb + gk);
        } else if constexpr (C::kAddMask) {
          sc[r * chunk + i] = A::add(A::mul(acc[0], scale), __ldg(mb + gk));
        } else {
          sc[r * chunk + i] = A::mul(acc[0], scale);
        }
      }
    }
    if (R::kPer > 1) __syncwarp();  // the slot is read before it is copied into again
    stage(j + kRing);
  }
  __syncthreads();

  // the local max of each row (order-free)
  {
    float mx[MM];
#pragma unroll
    for (int r = 0; r < MM; ++r) mx[r] = -INFINITY;
    for (int i = tid; i < len; i += kThreads)
#pragma unroll
      for (int r = 0; r < MM; ++r)
        if (r < m) mx[r] = fmaxf(mx[r], sc[r * chunk + i]);
#pragma unroll
    for (int r = 0; r < MM; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
      if (lane == 0) red[r * kWarps + warp] = mx[r];
    }
    __syncthreads();
    if (tid < m) {
      float x = red[tid * kWarps];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) x = fmaxf(x, red[tid * kWarps + w]);
      xmax[tid] = x;
    }
  }

  // 2: the row max over the cluster (in every warp, lane rr reads rank rr's
  // values: one remote round trip)
  cluster.sync();
  float gmax[MM];
#pragma unroll
  for (int r = 0; r < MM; ++r) gmax[r] = -INFINITY;
  if (lane < n_split) {
    const float* xm = cluster.map_shared_rank(xmax, lane);
#pragma unroll
    for (int r = 0; r < MM; ++r)
      if (r < m) gmax[r] = xm[r];
  }
#pragma unroll
  for (int r = 0; r < MM; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      gmax[r] = fmaxf(gmax[r], __shfl_xor_sync(0xffffffffu, gmax[r], off));
  // a row whose max is finfo.min is fully masked: its skipped keys have e = 1
  // and every V row is read (the other rows' skipped keys add p * v = 0)
  bool all = false;
#pragma unroll
  for (int r = 0; r < MM; ++r)
    if (r < m && !(gmax[r] > kSkip)) all = true;

  // 3: e and its sum: thread streams i = tid, tid + 128, ..., the 32 lanes of
  // a warp by a balanced tree over neighbours, the warps left to right
  {
    float ls[MM];
#pragma unroll
    for (int r = 0; r < MM; ++r) ls[r] = 0.f;
    for (int i = tid; i < len; i += kThreads)
#pragma unroll
      for (int r = 0; r < MM; ++r)
        if (r < m) {
          const float e = expf(A::sub(sc[r * chunk + i], gmax[r]));
          sc[r * chunk + i] = e;
          ls[r] = A::add(ls[r], e);
        }
#pragma unroll
    for (int r = 0; r < MM; ++r) {
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        ls[r] = A::add(ls[r], __shfl_xor_sync(0xffffffffu, ls[r], off));
      if (lane == 0) red[r * kWarps + warp] = ls[r];
    }
    __syncthreads();
    if (tid < m) {
      float x = red[tid * kWarps];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) x = A::add(x, red[tid * kWarps + w]);
      xsum[tid] = x;
    }
  }
  cluster.sync();
  // the denominators: the ranks' sums in rank order, the same in every block
  float gsum[MM];
#pragma unroll
  for (int r = 0; r < MM; ++r) gsum[r] = 0.f;
  if (lane < n_split) {
    const float* xs = cluster.map_shared_rank(xsum, lane);
#pragma unroll
    for (int r = 0; r < MM; ++r)
      if (r < m) gsum[r] = xs[r];
  }
#pragma unroll
  for (int r = 0; r < MM; ++r) {
    float x = __shfl_sync(0xffffffffu, gsum[r], 0);
    for (int rr = 1; rr < n_split; ++rr) x = A::add(x, __shfl_sync(0xffffffffu, gsum[r], rr));
    gsum[r] = x;
  }

  // 4: probs rounded to T (int8 K/V: times the key's V scale, then rounded;
  // only for the keys whose V rows are read; the fused contract: e / sum,
  // fp32), then the block's partial context
  for (int i = tid; i < len; i += kThreads) {
    if constexpr (kQ8) {
      if (!all && !unskipped(bits, i)) continue;
      const float w = all ? __ldg(vsb + global_key(i, rank, n_split)) : vsc[i];
#pragma unroll
      for (int r = 0; r < MM; ++r)
        if (r < m)
          sc[r * chunk + i] =
              cxr::to_float(cxr::from_float<T>(A::mul(A::div(sc[r * chunk + i], gsum[r]), w)));
    } else {
#pragma unroll
      for (int r = 0; r < MM; ++r)
        if (r < m) {
          const float p = A::div(sc[r * chunk + i], gsum[r]);
          sc[r * chunk + i] = C::kRoundP ? cxr::to_float(cxr::from_float<T>(p)) : p;
        }
    }
  }
  __syncthreads();

  float cacc[MM][R::kVec];
#pragma unroll
  for (int r = 0; r < MM; ++r)
#pragma unroll
    for (int e = 0; e < R::kVec; ++e) cacc[r][e] = 0.f;
  // V of the listed tiles, whose first jobs are already in flight; a fully
  // masked row instead drains the ring and reads V of every tile
  int first = nt, jobs = 2 * nt;
  if (all) {
    cp_async_wait<0>();
    first = 0;
    jobs = tiles;
#pragma unroll
    for (int j = 0; j < kRing; ++j) {
      if (j < tiles) stage_tile<KV>(ring + j * kSlot, v4, bits, j, rank + j * n_split, crow, cl,
                                    true, len);
      else cp_async_commit();
    }
  }
  for (int j = first; j < jobs; ++j) {
    cp_async_wait<kRing - 1>();
    if (R::kPer > 1) __syncwarp();
    const P* slot = reinterpret_cast<const P*>(ring + (j % kRing) * kSlot);
    const int t = all ? j : listed[j - nt];
#pragma unroll
    for (int u = 0; u < R::kLoads; ++u) {
      const int i = t * kTile + R::read_step(u) + row;
      if (all ? i < len : unskipped(bits, i)) {
        float vf[R::kVec];
        unpack_kv(slot[(R::read_step(u) + row) * R::kLpk + li], vf, KV());
#pragma unroll
        for (int r = 0; r < MM; ++r)
          if (r < m) {
            const float p = sc[r * chunk + i];
#pragma unroll
            for (int e = 0; e < R::kVec; ++e) cacc[r][e] = A::mac(cacc[r][e], p, vf[e]);
          }
      }
    }
    if (R::kPer > 1) __syncwarp();
    if (!all) {
      stage(j + kRing);
    } else if (j + kRing < tiles) {
      stage_tile<KV>(ring + ((j + kRing) % kRing) * kSlot, v4, bits, j + kRing,
                     rank + (j + kRing) * n_split, crow, cl, true, len);
    } else {
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the partials take its place
  // the warp's kKpw key-row streams by a balanced tree over neighbours, then
  // the warps left to right
#pragma unroll
  for (int r = 0; r < MM; ++r)
#pragma unroll
    for (int e = 0; e < R::kVec; ++e)
#pragma unroll
      for (int off = R::kLpk; off < 32; off <<= 1)
        cacc[r][e] = A::add(cacc[r][e], __shfl_xor_sync(0xffffffffu, cacc[r][e], off));
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < MM; ++r)
      if (r < m)
#pragma unroll
        for (int e = 0; e < R::kVec; ++e)
          part[(warp * m + r) * kDh + li * R::kVec + e] = cacc[r][e];
  }
  __syncthreads();
  // 5: the block's partial context, each element to the rank that owns it
  for (int i = tid; i < m * kDh; i += kThreads) {
    float x = part[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x = A::add(x, part[w * m * kDh + i]);
    *cluster.map_shared_rank(gather + rank * owned + i % owned, i / owned) = x;
  }
  cluster.sync();
  // the ranks' partials of the block's own elements, in rank order
  T* ob = o + (size_t)bh * m * kDh;
  for (int e = tid; e < owned && rank * owned + e < m * kDh; e += kThreads) {
    float x = gather[e];
    for (int rr = 1; rr < n_split; ++rr) x = A::add(x, gather[rr * owned + e]);
    ob[rank * owned + e] = cxr::from_float<T>(x);
  }
}

template <typename T, typename KV, int MM, bool kExact, typename C>
cudaError_t launch_mm(const void* q, const void* k, const void* v, const float* ks,
                      const float* vs, const typename C::Mask* mask, void* o, int bh, int heads,
                      int m, int s_len, int n_split, int chunk, float scale, size_t smem,
                      cudaStream_t stream) {
  auto fn = decode_split_kernel<T, KV, MM, kExact, C>;
  if (smem + 1024 > 48 * 1024) {  // the default limit holds the static memory too
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split * bh);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, fn, static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      ks, vs, mask, static_cast<T*>(o), heads, m, s_len, chunk, scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Checks the schedule it is given (the wrapper computes it) and launches. q
// and o are T, k and v KV; ks and vs the int8 K/V's scales (KV = signed
// char), else null; the mask is C's.
template <typename T, typename KV, bool kExact, typename C = Decode>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                   const void* mask, void* o, int bh, int heads, int m, int s_len, int dh,
                   int n_split, int chunk, float scale, cudaStream_t stream) {
  const int tiles = (s_len + kTile - 1) / kTile;
  if (dh != kDh || m < 1 || m > kMaxM || bh < 1 || heads < 1 || bh % heads != 0 ||
      s_len < 1 || n_split < 1 || n_split > kMaxSplit || n_split > tiles ||
      chunk != (tiles + n_split - 1) / n_split * kTile ||
      (sizeof(KV) == 1) != (ks != nullptr && vs != nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(m, chunk, sizeof(KV));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const auto* mk = static_cast<const typename C::Mask*>(mask);
  const float* kf = static_cast<const float*>(ks);
  const float* vf = static_cast<const float*>(vs);
  if (m == 1)
    return launch_mm<T, KV, 1, kExact, C>(q, k, v, kf, vf, mk, o, bh, heads, m, s_len, n_split,
                                          chunk, scale, smem, stream);
  if constexpr (std::is_same<C, Decode>::value)
    return launch_mm<T, KV, 4, kExact, C>(q, k, v, kf, vf, mk, o, bh, heads, m, s_len, n_split,
                                          chunk, scale, smem, stream);
  return cudaErrorInvalidValue;  // the fused contract has M = 1
}

}  // namespace split
}  // namespace cxr
