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
// fp32; fp32 or bf16 in, fp32 arithmetic, each output rounded once to the
// input type.
//
// Bound on the H100: arithmetic. At CvT-21@384 a training micro-step of 20
// images needs 6 Lq Lk D operations per head for dq and 8 for dk/dv (about 812
// GFLOP together) against a few hundred MB of inputs and outputs.
//
// Design: two threads own one row (a query row for dq, a key row for dk/dv),
// each holding 32 of its 64 dimensions in registers: the row's operands and
// its two (dk/dv) or one (dq) fp32 accumulators. A thread's dimensions are
// the 16-byte chunks 8i + 4h .. 8i + 4h + 3 (h = 0, 1), so the two threads of
// a row read neighbouring chunks of a shared-memory row, in different banks.
// The streamed operand is staged in shared memory as fp32 tiles of 32 rows
// and read as a broadcast; each dot product over 64 dimensions is two partial
// sums joined by one shuffle. Rows past Lq or Lk are never streamed and never
// written, as the TPU kernel masks them. SIMT fp32: mma/wgmma tiles are later
// work.
#include "common.cuh"

namespace {

constexpr int DP = 64;       // head dim
constexpr int kHalf = 32;    // dims per thread
constexpr int kRows = 64;    // rows owned per block (two threads each)
constexpr int kThreads = 2 * kRows;
constexpr int kTile = 32;    // streamed rows per shared-memory tile

// the j-th of a thread's 32 dims, j = 4 i + e, for thread half h
__device__ __forceinline__ int dim_of(int h, int j) { return 8 * (j >> 2) + 4 * h + (j & 3); }

template <typename T>
__device__ __forceinline__ void load_half(const T* row, int h, bool valid, float* out) {
#pragma unroll
  for (int j = 0; j < kHalf; ++j) out[j] = valid ? cxr::to_float(row[dim_of(h, j)]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store_half(T* row, int h, const float* in) {
#pragma unroll
  for (int j = 0; j < kHalf; ++j) row[dim_of(h, j)] = cxr::from_float<T>(in[j]);
}

// Stage rows [r0, r0 + n) of a [*, DP] matrix as fp32 into a [kTile][DP] tile.
template <typename T>
__device__ __forceinline__ void stage(float (*dst)[DP], const T* src, int r0, int n) {
  for (int i = threadIdx.x; i < kTile * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    dst[r][c] = r < n ? cxr::to_float(src[(size_t)(r0 + r) * DP + c]) : 0.f;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int lq, int lk,
                    float scale) {
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
  const T* kb = k + (size_t)bh * lk * DP;
  const T* vb = v + (size_t)bh * lk * DP;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int lq, int lk, float scale) {
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
  const T* qb = q + (size_t)bh * lq * DP;
  const T* dob = dout + (size_t)bh * lq * DP;
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

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int lq, int lk,
                      int d, float scale, cudaStream_t stream) {
  if (d != DP) return cudaErrorInvalidValue;
  const dim3 grid(bh, (lq + kRows - 1) / kRows);
  flash_bwd_dq_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), lq, lk, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int lq,
                       int lk, int d, float scale, cudaStream_t stream) {
  if (d != DP) return cudaErrorInvalidValue;
  const dim3 grid(bh, (lk + kRows - 1) / kRows);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), lq, lk,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cxr_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, int bh, int lq, int lk, int d, float scale,
                                    void* stream) {
  return launch_dq<float>(q, k, v, dout, lse, delta, dq, bh, lq, lk, d, scale,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, int bh, int lq, int lk, int d, float scale,
                                     void* stream) {
  return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, lq, lk, d, scale,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int bh, int lq, int lk, int d,
                                     float scale, void* stream) {
  return launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, bh, lq, lk, d, scale,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int bh, int lq, int lk, int d,
                                      float scale, void* stream) {
  return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh, lq, lk, d, scale,
                                   static_cast<cudaStream_t>(stream));
}
