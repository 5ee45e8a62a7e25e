// CvT stage attention: unmasked online-softmax ("flash") attention that never
// holds the [Lq, Lk] score matrix in device memory.
//
// Replaces cxrmate_tpu/ops/flash_attention.py:60 flash_attention (Pallas, TPU)
// and, with its log-sum-exp output, :109 _flash_fwd_kernel, the forward of
// flash_attention_grad (pallas_call :218). Layout q [BH, Lq, D], k/v [BH, Lk, D],
// out [BH, Lq, D] with D = 64 (every CvT-21 stage), lse [BH, Lq] fp32 = m + log l.
// Both entries of a dtype launch the same compiled kernel (the lse pointer is
// null for inference), so the training forward's out is bit-identical to
// inference's.
//
// Bound on the H100: arithmetic. At CvT-21@384 (D = 64) one image needs about
// 11.6 GFLOP of attention (4 * Lq * Lk * D per head: stage 0 is 9,216 x 2,304,
// stage 1 2,304 x 576 x 3 heads, stage 2 577 x 145 x 6 heads), while it moves
// only q, k, v and out. The plain version instead writes and reads an fp32
// score matrix of 85 MB per image per layer at stage 0.
//
// bf16: Hopper's tensor cores (flash_fwd_tc_kernel). A block of two
// warpgroups owns 128 query rows, 64 per warpgroup; two blocks share an SM
// (at most 128 registers a thread, 83 KB of shared memory a block). Q's tile
// and a ring of kStages K/V tiles of 64 keys sit in shared memory in the
// 128-byte swizzled layout, loaded by TMA (3-D tensor maps [BH, L, 64], so
// rows past L are zero-filled and never the next head's) and signalled
// through mbarriers. Per tile a warpgroup runs S = Q K^T as four wgmma
// m64n64k16 (A and B from shared memory, both K-major as stored), masks keys
// past Lk to -inf (the last tile only), updates the running max and sum on
// the fp32 accumulator fragments in registers (ex2.approx, the scale folded
// into one FFMA per score), converts P to bf16 in registers (the accumulator
// fragment is the A fragment of the next product) and runs O += P V as four
// wgmma with A from registers and V's tile read through the transposed
// (MN-major) descriptor; the next tile's Q K^T is issued into the same commit
// group, since S's registers are free once P is packed. The second warpgroup
// to finish with a stage refills it (a per-stage count, no block-wide
// barrier), so the two drift apart and one's softmax runs under the other's
// products, and the copies of the next tiles run under both. Deviation from
// the TPU kernel, whose p is fp32: P is rounded to bf16 before P V (the row
// sum l is not).
//
// fp32 (parity mode, the CPU tests' shapes on the card): the SIMT kernel
// (flash_fwd_simt_kernel), because tensor cores would compute in TF32 (about
// three decimal digits), which misses the 1e-5 fp32 gate. One block per (bh,
// tile of 128 query rows), one query row per thread: the row's q and its fp32
// context stay in registers; the block walks the keys in tiles of 32 rows of
// K and V staged in shared memory (converted to fp32 once, read by every
// thread as a broadcast), rescaling the context once per tile. Keys past Lk in
// the ragged last tile get score -1e30 and weight 0, as the TPU kernel masks
// them.
#include "hopper.cuh"

namespace {

using namespace hop;

constexpr int DP = kHeadDim;

// ------------------------------------------------------------------ fp32 SIMT
constexpr int kRows = 128;  // query rows per block, one per thread
constexpr int kKeys = 32;   // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

__global__ void __launch_bounds__(kRows)
flash_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                      int lq, int lk, float scale) {
  __shared__ float ks[kKeys][DP];
  __shared__ float vs[kKeys][DP];
  const int bh = blockIdx.x;
  const int row = blockIdx.y * kRows + threadIdx.x;
  const bool valid = row < lq;

  float qr[DP], acc[DP];
  const float* qp = q + ((size_t)bh * lq + (valid ? row : 0)) * DP;
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    qr[c] = valid ? qp[c] : 0.f;
    acc[c] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const float* kb = k + (size_t)bh * lk * DP;
  const float* vb = v + (size_t)bh * lk * DP;

  for (int t0 = 0; t0 < lk; t0 += kKeys) {
    const int n = min(kKeys, lk - t0);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < kKeys * DP; i += kRows) {
      const int j = i / DP, c = i % DP;
      const bool ok = j < n;
      const size_t off = (size_t)(t0 + j) * DP + c;
      ks[j][c] = ok ? kb[off] : 0.f;
      vs[j][c] = ok ? vb[off] : 0.f;
    }
    __syncthreads();

    float s[kKeys];
    float mt = m;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float a = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) a = fmaf(qr[c], ks[j][c], a);
      s[j] = j < n ? a * scale : kNegInf;
      mt = fmaxf(mt, s[j]);
    }
    const float alpha = expf(m - mt);
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[c] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = expf(s[j] - mt);
      psum += p;
#pragma unroll
      for (int c = 0; c < DP; ++c) acc[c] = fmaf(p, vs[j][c], acc[c]);
    }
    l = l * alpha + psum;
    m = mt;
  }

  if (valid) {
    float* op = o + ((size_t)bh * lq + row) * DP;
#pragma unroll
    for (int c = 0; c < DP; ++c) op[c] = acc[c] / l;
    if (lse != nullptr) lse[(size_t)bh * lq + row] = m + logf(l);
  }
}

// -------------------------------------------------------- bf16 tensor cores
constexpr int kM = 128;                 // query rows per block: two warpgroups of 64
constexpr int kN = 64;                  // keys per K/V tile
constexpr int kStages = 4;              // K/V tiles in flight
constexpr int kThreads = 256;
constexpr int kTileBytes = kN * kRowBytes;  // 8 KB: one K or one V tile
constexpr int kQBytes = kM * kRowBytes;     // 16 KB
// 1 KB of slack to align the tiles to the 1,024-byte swizzle atom, the tiles,
// then the mbarriers (one per stage, one for Q)
constexpr size_t kSmemBytes = 1024 + kQBytes + 2 * kStages * kTileBytes + 8 * (kStages + 1);

// Accumulator fragment of m64nNk16 (fp32), per thread of a warpgroup: element
// i sits at row 16 warp + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
// 2 (lane % 4) + i % 2. A thread holds two rows (r0, r1 = r0 + 8), each shared
// by the four threads of a quad.
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int lq, int lk, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;                            // [128 rows][64], swizzled
  const uint32_t sk = sq + kQBytes;                    // kStages x [64 keys][64]
  const uint32_t sv = sk + kStages * kTileBytes;       // kStages x [64 keys][64]
  const uint32_t full = sv + kStages * kTileBytes;     // kStages mbarriers
  const uint32_t qbar = full + 8 * kStages;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * kM;
  const int ntiles = (lk + kN - 1) / kN;

  __shared__ int passed[kStages];  // warpgroups past a stage's current tile
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      passed[s] = 0;
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, kQBytes);
    tma_load(sq, &qmap, qbar, q0, bh);
    for (int j = 0; j < kStages && j < ntiles; ++j) {
      mbar_expect_tx(full + 8 * j, 2 * kTileBytes);
      tma_load(sk + j * kTileBytes, &kmap, full + 8 * j, j * kN, bh);
      tma_load(sv + j * kTileBytes, &vmap, full + 8 * j, j * kN, bh);
    }
  }

  // Q: this warpgroup's 64 rows, K-major; the k-th 16-wide slice of the head
  // dim starts 32 bytes further (inside the swizzled 128-byte row)
  const uint64_t qdesc = smem_desc(sq + wg * 64 * kRowBytes, 16, 1024);
  float acc[32], sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  // running max of the raw scores and (per thread) sum of exp2(s * scale_log2 - m')
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  // S = Q K^T of tile j into sc, issued (not committed): K's tile is
  // [64 keys][64], K-major as stored
  auto issue_s = [&](int j) {
    const int s = j % kStages;
    mbar_wait(full + 8 * s, (j / kStages) & 1);
    const uint64_t kdesc = smem_desc(sk + s * kTileBytes, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, qdesc + 2 * kk, kdesc + 2 * kk, kk > 0);
  };
  mbar_wait(qbar, 0);
  wg_fence();
  issue_s(0);
  wg_commit();
  wg_wait_all();
  fence_regs(sc);

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % kStages;
    const int kbase = j * kN;
    if (kbase + kN > lk) {  // keys past lk (only in the last tile) to -inf
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (kbase + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1) >= lk) sc[i] = -INFINITY;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if ((i >> 1) & 1) mx1 = fmaxf(mx1, sc[i]);
      else mx0 = fmaxf(mx0, sc[i]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every tile holds at least one key below lk, so mx is finite (the first
    // tile's alpha is 2^-inf = 0)
    const float a0 = fast_exp2((m0 - mx0) * scale_log2);
    const float a1 = fast_exp2((m1 - mx1) * scale_log2);
    const float ms0 = mx0 * scale_log2, ms1 = mx1 * scale_log2;
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool second = (i >> 1) & 1;
      acc[i] *= second ? a1 : a0;
      const float p = fast_exp2(fmaf(sc[i], scale_log2, second ? -ms1 : -ms0));
      if (second) l1 += p;
      else l0 += p;
      sc[i] = p;
    }
    // P in bf16 as the A fragments of four k16 steps over the tile's keys
    uint32_t pa[4][4];
    pack_a(sc, pa);
    // O += P V: V's tile [64 keys][64] is MN-major for this product; the k-th
    // 16 keys start 16 rows (2,048 bytes) further
    const uint64_t vdesc = smem_desc(sv + s * kTileBytes, kTileBytes, 1024);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb(acc, pa[kk], vdesc + (2048 >> 4) * kk);
    // P sits in pa now, so sc is free: the next tile's S = Q K^T goes into the
    // same commit group as this tile's P V
    if (j + 1 < ntiles) issue_s(j + 1);
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    fence_regs(sc);

    // this warpgroup is past stage s; the second of the two to get here refills
    // it, so that the warpgroups drift apart and one's softmax runs under the
    // other's products
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if ((tid & 127) == 0 && atomicAdd(&passed[s], 1) == 1) {
      passed[s] = 0;
      if (j + kStages < ntiles) {
        const int jn = j + kStages;
        mbar_expect_tx(full + 8 * s, 2 * kTileBytes);
        tma_load(sk + s * kTileBytes, &kmap, full + 8 * s, jn * kN, bh);
        tma_load(sv + s * kTileBytes, &vmap, full + 8 * s, jn * kN, bh);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = q0 + wg * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* ob = o + (size_t)bh * lq * DP;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int col = 8 * c + 2 * (lane & 3);
    if (r0 < lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * DP + col) =
          __floats2bfloat162_rn(acc[4 * c] * inv0, acc[4 * c + 1] * inv0);
    if (r1 < lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * DP + col) =
          __floats2bfloat162_rn(acc[4 * c + 2] * inv1, acc[4 * c + 3] * inv1);
  }
  if (lse != nullptr && (lane & 3) == 0) {
    float* lb = lse + (size_t)bh * lq;
    if (r0 < lq) lb[r0] = (m0 * scale_log2 + log2f(l0)) * kLn2;
    if (r1 < lq) lb[r1] = (m1 * scale_log2 + log2f(l1)) * kLn2;
  }
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                      int lq, int lk, float scale, cudaStream_t stream) {
  // TMA needs 16-byte aligned bases; the grid's y dimension holds bh
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0 || bh > 65535)
    return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  cudaError_t err = make_map(encode, &qm, q, bh, lq, kM);
  if (err == cudaSuccess) err = make_map(encode, &km, k, bh, lk, kN);
  if (err == cudaSuccess) err = make_map(encode, &vm, v, bh, lk, kN);
  if (err != cudaSuccess) return err;
  static bool smem_set = false;
  if (!smem_set) {
    err = cudaFuncSetAttribute(flash_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((lq + kM - 1) / kM, bh);
  flash_fwd_tc_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, lq, lk, scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                        int lq, int lk, float scale, cudaStream_t stream) {
  const dim3 grid(bh, (lq + kRows - 1) / kRows);
  flash_fwd_simt_kernel<<<grid, kRows, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, lq, lk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cxr_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                       int bh, int lq, int lk, int d, float scale,
                                       void* stream) {
  if (d != DP) return cudaErrorInvalidValue;
  return launch_simt(q, k, v, o, nullptr, bh, lq, lk, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                        int bh, int lq, int lk, int d, float scale,
                                        void* stream) {
  if (d != DP) return cudaErrorInvalidValue;
  return launch_tc(q, k, v, o, nullptr, bh, lq, lk, scale, static_cast<cudaStream_t>(stream));
}

// The training forward: as above, and lse[bh, row] = m + log(l), fp32.
extern "C" int cxr_flash_attention_lse_f32(const void* q, const void* k, const void* v, void* o,
                                           void* lse, int bh, int lq, int lk, int d,
                                           float scale, void* stream) {
  if (d != DP) return cudaErrorInvalidValue;
  return launch_simt(q, k, v, o, static_cast<float*>(lse), bh, lq, lk, scale,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_flash_attention_lse_bf16(const void* q, const void* k, const void* v, void* o,
                                            void* lse, int bh, int lq, int lk, int d,
                                            float scale, void* stream) {
  if (d != DP) return cudaErrorInvalidValue;
  return launch_tc(q, k, v, o, static_cast<float*>(lse), bh, lq, lk, scale,
                   static_cast<cudaStream_t>(stream));
}
