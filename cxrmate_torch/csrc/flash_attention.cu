// CvT stage attention: unmasked online-softmax ("flash") attention that never
// holds the [Lq, Lk] score matrix in device memory.
//
// Replaces cxrmate_tpu/ops/flash_attention.py:60 flash_attention (Pallas, TPU)
// and, with its log-sum-exp output, :109 _flash_fwd_kernel, the forward of
// flash_attention_grad (pallas_call :218). Layout q [BH, Lq, D], k/v [BH, Lk, D],
// out [BH, Lq, D] with D = 64 (every CvT-21 stage), lse [BH, Lq] fp32; fp32 or
// bf16 in, fp32 arithmetic throughout (scores, running max and sum, context).
// Both entries launch the same compiled kernel (the lse pointer is null for
// inference), so the training forward's out is bit-identical to inference's.
//
// Bound on the H100: arithmetic. At CvT-21@384 (D = 64) one image needs about
// 11.6 GFLOP of attention (4 * Lq * Lk * D per head: stage 0 is 9,216 x 2,304,
// stage 1 2,304 x 576 x 3 heads, stage 2 577 x 145 x 6 heads), while it moves
// only q, k, v and out. The plain version instead writes and reads an fp32
// score matrix of 85 MB per image per layer at stage 0.
//
// Design: one block per (bh, tile of 128 query rows), one query row per
// thread. The row's q and its fp32 context accumulator stay in registers; the
// block walks the keys in tiles of 32 rows of K and V staged in shared memory
// (converted to fp32 once, read by every thread as a broadcast), computing the
// tile's 32 scores, the new running max, and rescaling the accumulator once
// per tile. Keys past Lk in the ragged last tile get score -1e30 and weight 0,
// as the TPU kernel masks them. Simple and exact; wgmma/TMA tiles are later
// work.
#include "common.cuh"

namespace {

constexpr int kRows = 128;  // query rows per block, one per thread
constexpr int kKeys = 32;   // keys per shared-memory tile
constexpr float kNegInf = -1e30f;
constexpr int DP = 64;      // head dim

template <typename T>
__global__ void __launch_bounds__(kRows)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int lq, int lk, float scale) {
  __shared__ float ks[kKeys][DP];
  __shared__ float vs[kKeys][DP];
  const int bh = blockIdx.x;
  const int row = blockIdx.y * kRows + threadIdx.x;
  const bool valid = row < lq;

  float qr[DP], acc[DP];
  const T* qp = q + ((size_t)bh * lq + (valid ? row : 0)) * DP;
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    qr[c] = valid ? cxr::to_float(qp[c]) : 0.f;
    acc[c] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const T* kb = k + (size_t)bh * lk * DP;
  const T* vb = v + (size_t)bh * lk * DP;

  for (int t0 = 0; t0 < lk; t0 += kKeys) {
    const int n = min(kKeys, lk - t0);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < kKeys * DP; i += kRows) {
      const int j = i / DP, c = i % DP;
      const bool ok = j < n;
      const size_t off = (size_t)(t0 + j) * DP + c;
      ks[j][c] = ok ? cxr::to_float(kb[off]) : 0.f;
      vs[j][c] = ok ? cxr::to_float(vb[off]) : 0.f;
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
    T* op = o + ((size_t)bh * lq + row) * DP;
#pragma unroll
    for (int c = 0; c < DP; ++c) op[c] = cxr::from_float<T>(acc[c] / l);
    if (lse != nullptr) lse[(size_t)bh * lq + row] = m + logf(l);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                   int lq, int lk, int d, float scale, cudaStream_t stream) {
  const dim3 grid(bh, (lq + kRows - 1) / kRows);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  if (d != DP) return cudaErrorInvalidValue;
  flash_fwd_kernel<T><<<grid, kRows, 0, stream>>>(qp, kp, vp, op, lse, lq, lk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cxr_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                       int bh, int lq, int lk, int d, float scale,
                                       void* stream) {
  return launch<float>(q, k, v, o, nullptr, bh, lq, lk, d, scale,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                        int bh, int lq, int lk, int d, float scale,
                                        void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, nullptr, bh, lq, lk, d, scale,
                               static_cast<cudaStream_t>(stream));
}

// The training forward: as above, and lse[bh, row] = m + log(l), fp32.
extern "C" int cxr_flash_attention_lse_f32(const void* q, const void* k, const void* v, void* o,
                                           void* lse, int bh, int lq, int lk, int d,
                                           float scale, void* stream) {
  return launch<float>(q, k, v, o, static_cast<float*>(lse), bh, lq, lk, d, scale,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_flash_attention_lse_bf16(const void* q, const void* k, const void* v, void* o,
                                            void* lse, int bh, int lq, int lk, int d,
                                            float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse), bh, lq, lk, d, scale,
                               static_cast<cudaStream_t>(stream));
}
