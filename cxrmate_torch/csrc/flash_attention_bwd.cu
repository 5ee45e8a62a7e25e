// CvT stage attention in training: the two backward passes of flash attention
// (FlashAttention-2), which recompute the probabilities from the forward's
// log-sum-exp rows instead of storing the [Lq, Lk] matrix.
//
// Replaces cxrmate_tpu/ops/flash_attention.py:137 _flash_bwd_dq_kernel
// (pallas_call :264) and :161 _flash_bwd_dkv_kernel (pallas_call :280), the
// backward of flash_attention_grad :197. With S = q k^T * scale, P = exp(S -
// lse), dP = dO V^T and dS = P o (dP - delta) * scale (delta = rowsum(dO o O),
// computed by the caller):
//   dq = dS K            one block per (bh, tile of query rows), K/V streamed
//   dk = dS^T Q, dv = P^T dO   one block per (bh, tile of key rows), Q/dO streamed
// Splitting dq from dk/dv, as the TPU kernel does, needs no atomics: every
// output element is summed by one thread in a fixed order, so the results are
// the same from run to run. Layout [BH, L, D] with D = 64, lse/delta [BH, Lq]
// fp32; each output rounded once to the input type.
//
// Bound on the H100: arithmetic. At CvT-21@384 a training micro-step of 20
// images needs 6 Lq Lk D operations per head for dq and 8 for dk/dv (about 812
// GFLOP together) against a few hundred MB of inputs and outputs.
//
// bf16: Hopper's tensor cores (flash_bwd_tc_kernel, one body for both
// passes; helpers in hopper.cuh). A block of one warpgroup owns 64 rows of a
// resident pair A1, A2 (dq: Q and dO; dk/dv: K and V) and streams 64-row
// tiles of a pair B1, B2 (dq: K and V; dk/dv: Q and dO) through a ring of
// kStages tiles, all loaded by TMA in the 128-byte swizzle and signalled
// through mbarriers, as the forward does; three blocks share an SM, so one's
// exponentials run under another's products. Per tile the warpgroup
// computes X = A1 B1^T and Y = A2 B2^T (wgmma, both operands K-major as
// stored: for dq S and dP, for dk/dv S^T and dP^T, the keys as the M rows),
// then P = exp2(X scale log2e - lse log2e) and dS' = P (Y - delta) on the
// fp32 accumulator fragments, and packs them to bf16 in registers as the A
// fragments of A1' += dS' B1 (dq += dS' K, dk += dS'^T Q) and, for dk/dv,
// A2' += P B2 (dv += P^T dO), with B read through the transposed (MN-major)
// descriptor; the next tile's X and Y go into the same commit group. scale
// is applied once to dq and dk at the end. lse and delta are per accumulator
// row for dq (registers) and per column for dk/dv (the block copies a tile's
// 64 values into a double-buffered shared array one tile ahead).
// Streamed rows past their length (keys past Lk for dq, queries past Lq for
// dk/dv) are zero-filled by TMA and masked to P = 0 in the last tile; their
// lse and delta read as 0, never as memory past the row set (the JAX padding
// rule, cxrmate_tpu/ops/flash_attention.py:258-262). Owned rows past their
// length are never written. Deviation from the TPU kernel, whose p and ds are
// fp32: P and dS are rounded to bf16 before they enter a product, as the
// forward rounds P.
//
// fp32 (parity mode): SIMT, because tensor cores would compute in TF32, which
// misses the 1e-5 fp32 gate. Two threads own one row (a query row for dq, a
// key row for dk/dv), each holding 32 of its 64 dimensions in registers: the
// row's operands and its two (dk/dv) or one (dq) fp32 accumulators. A
// thread's dimensions are the 16-byte chunks 8i + 4h .. 8i + 4h + 3 (h = 0,
// 1), so the two threads of a row read neighbouring chunks of a shared-memory
// row, in different banks. The streamed operand is staged in shared memory as
// fp32 tiles of 32 rows and read as a broadcast; each dot product over 64
// dimensions is two partial sums joined by one shuffle. Rows past Lq or Lk are
// never streamed and never written, as the TPU kernel masks them.
#include "hopper.cuh"

namespace {

constexpr int DP = 64;       // head dim
constexpr int kHalf = 32;    // dims per thread
constexpr int kRows = 64;    // rows owned per block (two threads each)
constexpr int kThreads = 2 * kRows;
constexpr int kTile = 32;    // streamed rows per shared-memory tile

// the j-th of a thread's 32 dims, j = 4 i + e, for thread half h
__device__ __forceinline__ int dim_of(int h, int j) { return 8 * (j >> 2) + 4 * h + (j & 3); }

__device__ __forceinline__ void load_half(const float* row, int h, bool valid, float* out) {
#pragma unroll
  for (int j = 0; j < kHalf; ++j) out[j] = valid ? row[dim_of(h, j)] : 0.f;
}

__device__ __forceinline__ void store_half(float* row, int h, const float* in) {
#pragma unroll
  for (int j = 0; j < kHalf; ++j) row[dim_of(h, j)] = in[j];
}

// Stage rows [r0, r0 + n) of a [*, DP] matrix into a [kTile][DP] tile.
__device__ __forceinline__ void stage(float (*dst)[DP], const float* src, int r0, int n) {
  for (int i = threadIdx.x; i < kTile * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    dst[r][c] = r < n ? src[(size_t)(r0 + r) * DP + c] : 0.f;
  }
}

// The thread's partial dot product of its 32 dims with row `s` of a tile.
__device__ __forceinline__ float partial_dot(const float* mine, const float* s, int h) {
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < kHalf / 4; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(s + 8 * i + 4 * h);
    a = fmaf(mine[4 * i], x.x, a);
    a = fmaf(mine[4 * i + 1], x.y, a);
    a = fmaf(mine[4 * i + 2], x.z, a);
    a = fmaf(mine[4 * i + 3], x.w, a);
  }
  return a;
}

// acc += w * (the thread's 32 dims of row `s` of a tile)
__device__ __forceinline__ void axpy(float* acc, float w, const float* s, int h) {
#pragma unroll
  for (int i = 0; i < kHalf / 4; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(s + 8 * i + 4 * h);
    acc[4 * i] = fmaf(w, x.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(w, x.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(w, x.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(w, x.w, acc[4 * i + 3]);
  }
}

__device__ __forceinline__ float join(float partial) {
  return partial + __shfl_xor_sync(0xffffffffu, partial, 1);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int lq, int lk, float scale) {
  __shared__ __align__(16) float ks[kTile][DP];
  __shared__ __align__(16) float vs[kTile][DP];
  const int bh = blockIdx.x, h = threadIdx.x & 1;
  const int row = blockIdx.y * kRows + (threadIdx.x >> 1);
  const bool valid = row < lq;
  const size_t off = ((size_t)bh * lq + (valid ? row : 0)) * DP;
  float qr[kHalf], dor[kHalf], acc[kHalf];
  load_half(q + off, h, valid, qr);
  load_half(dout + off, h, valid, dor);
#pragma unroll
  for (int j = 0; j < kHalf; ++j) acc[j] = 0.f;
  // an invalid row gets lse = delta = 0 and zero operands: finite, never written
  const float lse_r = valid ? lse[(size_t)bh * lq + row] : 0.f;
  const float delta_r = valid ? delta[(size_t)bh * lq + row] : 0.f;
  const float* kb = k + (size_t)bh * lk * DP;
  const float* vb = v + (size_t)bh * lk * DP;

  for (int t0 = 0; t0 < lk; t0 += kTile) {
    const int n = min(kTile, lk - t0);
    __syncthreads();  // the previous tile is fully consumed
    stage(ks, kb, t0, n);
    stage(vs, vb, t0, n);
    __syncthreads();
    for (int j = 0; j < n; ++j) {  // n is the same for the whole block
      const float s = join(partial_dot(qr, ks[j], h)) * scale;
      const float dp = join(partial_dot(dor, vs[j], h));
      const float p = expf(s - lse_r);
      axpy(acc, p * (dp - delta_r) * scale, ks[j], h);
    }
  }
  if (valid) store_half(dq + off, h, acc);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int lq, int lk,
                     float scale) {
  __shared__ __align__(16) float qs[kTile][DP];
  __shared__ __align__(16) float dos[kTile][DP];
  __shared__ float lses[kTile], deltas[kTile];
  const int bh = blockIdx.x, h = threadIdx.x & 1;
  const int key = blockIdx.y * kRows + (threadIdx.x >> 1);
  const bool valid = key < lk;
  const size_t off = ((size_t)bh * lk + (valid ? key : 0)) * DP;
  float kr[kHalf], vr[kHalf], dka[kHalf], dva[kHalf];
  load_half(k + off, h, valid, kr);
  load_half(v + off, h, valid, vr);
#pragma unroll
  for (int j = 0; j < kHalf; ++j) dka[j] = dva[j] = 0.f;
  const float* qb = q + (size_t)bh * lq * DP;
  const float* dob = dout + (size_t)bh * lq * DP;
  const float* lb = lse + (size_t)bh * lq;
  const float* db = delta + (size_t)bh * lq;

  for (int t0 = 0; t0 < lq; t0 += kTile) {
    const int n = min(kTile, lq - t0);
    __syncthreads();
    stage(qs, qb, t0, n);
    stage(dos, dob, t0, n);
    if (threadIdx.x < kTile) {
      lses[threadIdx.x] = threadIdx.x < n ? lb[t0 + threadIdx.x] : 0.f;
      deltas[threadIdx.x] = threadIdx.x < n ? db[t0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float s = join(partial_dot(kr, qs[i], h)) * scale;
      const float dp = join(partial_dot(vr, dos[i], h));
      const float p = expf(s - lses[i]);
      axpy(dva, p, dos[i], h);
      axpy(dka, p * (dp - deltas[i]) * scale, qs[i], h);
    }
  }
  if (valid) {
    store_half(dk + off, h, dka);
    store_half(dv + off, h, dva);
  }
}

cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int lq, int lk,
                      int d, float scale, cudaStream_t stream) {
  if (d != DP) return cudaErrorInvalidValue;
  const dim3 grid(bh, (lq + kRows - 1) / kRows);
  flash_bwd_dq_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), lq, lk, scale);
  return cudaGetLastError();
}

cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int lq,
                       int lk, int d, float scale, cudaStream_t stream) {
  if (d != DP) return cudaErrorInvalidValue;
  const dim3 grid(bh, (lk + kRows - 1) / kRows);
  flash_bwd_dkv_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), lq, lk,
      scale);
  return cudaGetLastError();
}

// -------------------------------------------------------- bf16 tensor cores
namespace tc {

using namespace hop;

// One warpgroup a block, three blocks an SM (at most 170 registers a
// thread). On an H100 this was the fastest of the block shapes tried for
// both passes, ahead of two or three warpgroups a block sharing the streamed
// tiles (one block an SM) and of one warpgroup at two blocks an SM.
constexpr int kThreads = 128;
constexpr int kMinBlocks = 3;
constexpr int kOwn = 64;                      // rows a block owns
constexpr int kN = 64;                        // rows of a streamed tile
constexpr int kStages = 3;                    // streamed tile pairs in flight
constexpr int kTileBytes = kN * kRowBytes;    // 8 KB
constexpr int kOwnBytes = kOwn * kRowBytes;   // 8 KB
// 1 KB of slack to align the tiles to the 1,024-byte swizzle atom, A1 and A2,
// the ring of B1 and B2 tiles, then the mbarriers (one per stage, one for A)
constexpr size_t kSmemBytes = 1024 + 2 * kOwnBytes + 2 * kStages * kTileBytes + 8 * (kStages + 1);

// kDKV = false: dq (A = Q, dO; B = K, V; out1 = dq). kDKV = true: dk/dv (A =
// K, V; B = Q, dO; out1 = dk, out2 = dv). The accumulator fragment layout is
// hop::pack_a's: a thread holds rows r0 and r0 + 8 of the block's 64, and
// per row 16 of the tile's 64 columns.
template <bool kDKV>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_tc_kernel(const __grid_constant__ CUtensorMap a1map,
                    const __grid_constant__ CUtensorMap a2map,
                    const __grid_constant__ CUtensorMap b1map,
                    const __grid_constant__ CUtensorMap b2map, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ out1,
                    __nv_bfloat16* __restrict__ out2, int lq, int lk, float scale,
                    float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sa1 = base;                         // [64 rows][64], swizzled
  const uint32_t sa2 = sa1 + kOwnBytes;
  const uint32_t sb1 = sa2 + kOwnBytes;              // kStages x [64 rows][64]
  const uint32_t sb2 = sb1 + kStages * kTileBytes;
  const uint32_t full = sb2 + kStages * kTileBytes;  // kStages mbarriers
  const uint32_t abar = full + 8 * kStages;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int bh = blockIdx.y, own0 = blockIdx.x * kOwn;
  const int n_own = kDKV ? lk : lq, n_str = kDKV ? lq : lk;
  const int ntiles = (n_str + kN - 1) / kN;
  const float* lb = lse + (size_t)bh * lq;
  const float* db = delta + (size_t)bh * lq;

  // dk/dv: lse log2e and delta of a Q tile's 64 rows, double-buffered
  __shared__ __align__(16) float st_l[2][kN], st_d[2][kN];
  // thread t's share of tile j's statistics: lse log2e of row t, or delta of
  // row t - 64; 0 past lq
  auto stat_of = [&](int j) -> float {
    const int row = j * kN + (t & 63);
    if (row >= lq) return 0.f;
    return t < 64 ? lb[row] * kLog2e : db[row];
  };
  float st_next = 0.f;
  if constexpr (kDKV) {
    (t < 64 ? st_l : st_d)[0][t & 63] = stat_of(0);
    st_next = stat_of(1);
  }
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + 8 * s, 1);
    mbar_init(abar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(abar, 2 * kOwnBytes);
    tma_load(sa1, &a1map, abar, own0, bh);
    tma_load(sa2, &a2map, abar, own0, bh);
    for (int j = 0; j < kStages && j < ntiles; ++j) {
      mbar_expect_tx(full + 8 * j, 2 * kTileBytes);
      tma_load(sb1 + j * kTileBytes, &b1map, full + 8 * j, j * kN, bh);
      tma_load(sb2 + j * kTileBytes, &b2map, full + 8 * j, j * kN, bh);
    }
  }

  // dq: lse log2e and delta of the thread's two rows (0 past lq)
  const int r0 = own0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  float rl0 = 0.f, rl1 = 0.f, rd0 = 0.f, rd1 = 0.f;
  if constexpr (!kDKV) {
    if (r0 < lq) rl0 = lb[r0] * kLog2e, rd0 = db[r0];
    if (r1 < lq) rl1 = lb[r1] * kLog2e, rd1 = db[r1];
  }

  // A1 and A2 are K-major as stored
  const uint64_t a1desc = smem_desc(sa1, 16, 1024);
  const uint64_t a2desc = smem_desc(sa2, 16, 1024);
  float acc1[32], acc2[32], xs[32], ys[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc1[i] = acc2[i] = 0.f;
  // X = A1 B1^T and Y = A2 B2^T of tile j, issued (not committed)
  auto issue_xy = [&](int j) {
    const int s = j % kStages;
    mbar_wait(full + 8 * s, (j / kStages) & 1);
    const uint64_t b1desc = smem_desc(sb1 + s * kTileBytes, 16, 1024);
    const uint64_t b2desc = smem_desc(sb2 + s * kTileBytes, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(xs, a1desc + 2 * kk, b1desc + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(ys, a2desc + 2 * kk, b2desc + 2 * kk, kk > 0);
  };
  mbar_wait(abar, 0);
  wg_fence();
  issue_xy(0);
  wg_commit();
  wg_wait_all();
  fence_regs(xs);
  fence_regs(ys);

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % kStages;
    const int cbase = j * kN;
    const bool edge = cbase + kN > n_str;  // the last tile, ragged
    const float* sl = st_l[j & 1];
    const float* sd = st_d[j & 1];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {  // elements i, i + 1: columns c, c + 1 of one row
      const int c = 8 * (i >> 2) + 2 * (lane & 3);
      float l0, l1, d0, d1;
      if constexpr (kDKV) {
        const float2 l = *reinterpret_cast<const float2*>(sl + c);
        const float2 d = *reinterpret_cast<const float2*>(sd + c);
        l0 = l.x, l1 = l.y, d0 = d.x, d1 = d.y;
      } else {
        const bool second = (i >> 1) & 1;
        l0 = l1 = second ? rl1 : rl0;
        d0 = d1 = second ? rd1 : rd0;
      }
      float p0 = fast_exp2(fmaf(xs[i], scale_log2, -l0));
      float p1 = fast_exp2(fmaf(xs[i + 1], scale_log2, -l1));
      if (edge) {
        if (cbase + c >= n_str) p0 = 0.f;
        if (cbase + c + 1 >= n_str) p1 = 0.f;
      }
      ys[i] = p0 * (ys[i] - d0);
      ys[i + 1] = p1 * (ys[i + 1] - d1);
      xs[i] = p0;
      xs[i + 1] = p1;
    }
    uint32_t pd[4][4], pp[4][4];
    pack_a(ys, pd);
    if constexpr (kDKV) pack_a(xs, pp);
    // B's tile is MN-major for these products; a k16 step is 16 rows further
    const uint64_t b1t = smem_desc(sb1 + s * kTileBytes, kTileBytes, 1024);
    const uint64_t b2t = smem_desc(sb2 + s * kTileBytes, kTileBytes, 1024);
    wg_fence();
    if constexpr (kDKV) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb(acc2, pp[kk], b2t + (2048 >> 4) * kk);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb(acc1, pd[kk], b1t + (2048 >> 4) * kk);
    // P and dS sit in registers now, so xs and ys are free: the next tile's
    // products go into the same commit group
    if (j + 1 < ntiles) issue_xy(j + 1);
    wg_commit();
    wg_wait_all();
    fence_regs(acc1);
    if constexpr (kDKV) fence_regs(acc2);
    fence_regs(xs);
    fence_regs(ys);

    // tile j + 1's statistics into the other buffer: every thread finished
    // reading it (tile j - 1) before the last barrier
    if constexpr (kDKV) {
      (t < 64 ? st_l : st_d)[(j + 1) & 1][t & 63] = st_next;
      st_next = stat_of(j + 2);
    }
    // every warp is past stage s: refill it
    __syncthreads();
    if (t == 0 && j + kStages < ntiles) {
      const int jn = j + kStages;
      mbar_expect_tx(full + 8 * s, 2 * kTileBytes);
      tma_load(sb1 + s * kTileBytes, &b1map, full + 8 * s, jn * kN, bh);
      tma_load(sb2 + s * kTileBytes, &b2map, full + 8 * s, jn * kN, bh);
    }
  }

  __nv_bfloat16* o1 = out1 + (size_t)bh * n_own * kHeadDim;
  __nv_bfloat16* o2 = out2 + (size_t)bh * n_own * kHeadDim;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int col = 8 * c + 2 * (lane & 3);
    if (r0 < n_own) {
      *reinterpret_cast<__nv_bfloat162*>(o1 + (size_t)r0 * kHeadDim + col) =
          __floats2bfloat162_rn(acc1[4 * c] * scale, acc1[4 * c + 1] * scale);
      if constexpr (kDKV)
        *reinterpret_cast<__nv_bfloat162*>(o2 + (size_t)r0 * kHeadDim + col) =
            __floats2bfloat162_rn(acc2[4 * c], acc2[4 * c + 1]);
    }
    if (r1 < n_own) {
      *reinterpret_cast<__nv_bfloat162*>(o1 + (size_t)r1 * kHeadDim + col) =
          __floats2bfloat162_rn(acc1[4 * c + 2] * scale, acc1[4 * c + 3] * scale);
      if constexpr (kDKV)
        *reinterpret_cast<__nv_bfloat162*>(o2 + (size_t)r1 * kHeadDim + col) =
            __floats2bfloat162_rn(acc2[4 * c + 2], acc2[4 * c + 3]);
    }
  }
}

template <bool kDKV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* out1, void* out2, int bh, int lq,
                   int lk, int d, float scale, cudaStream_t stream) {
  // TMA needs 16-byte aligned bases; the grid's y dimension holds bh
  if (d != kHeadDim || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16 != 0 ||
      bh > 65535)
    return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, dom, km, vm;  // boxes of 64 rows, owned or streamed
  cudaError_t err = make_map(encode, &qm, q, bh, lq, kN);
  if (err == cudaSuccess) err = make_map(encode, &dom, dout, bh, lq, kN);
  if (err == cudaSuccess) err = make_map(encode, &km, k, bh, lk, kN);
  if (err == cudaSuccess) err = make_map(encode, &vm, v, bh, lk, kN);
  if (err != cudaSuccess) return err;
  static bool smem_set = false;
  if (!smem_set) {
    err = cudaFuncSetAttribute(flash_bwd_tc_kernel<kDKV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(((kDKV ? lk : lq) + kOwn - 1) / kOwn, bh);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  __nv_bfloat16* o1 = static_cast<__nv_bfloat16*>(out1);
  __nv_bfloat16* o2 = kDKV ? static_cast<__nv_bfloat16*>(out2) : o1;
  // A1, A2 owned; B1, B2 streamed
  flash_bwd_tc_kernel<kDKV><<<grid, kThreads, kSmemBytes, stream>>>(
      kDKV ? km : qm, kDKV ? vm : dom, kDKV ? qm : km, kDKV ? dom : vm, l, dl, o1, o2, lq, lk,
      scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" int cxr_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, int bh, int lq, int lk, int d, float scale,
                                    void* stream) {
  return launch_dq(q, k, v, dout, lse, delta, dq, bh, lq, lk, d, scale,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, int bh, int lq, int lk, int d, float scale,
                                     void* stream) {
  return tc::launch<false>(q, k, v, dout, lse, delta, dq, nullptr, bh, lq, lk, d, scale,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int bh, int lq, int lk, int d,
                                     float scale, void* stream) {
  return launch_dkv(q, k, v, dout, lse, delta, dk, dv, bh, lq, lk, d, scale,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int bh, int lq, int lk, int d,
                                      float scale, void* stream) {
  return tc::launch<true>(q, k, v, dout, lse, delta, dk, dv, bh, lq, lk, d, scale,
                         static_cast<cudaStream_t>(stream));
}
