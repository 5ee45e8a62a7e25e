"""Where the time of the split decode kernel goes, phase by phase, on the card.

    python3 -m cxrmate_torch.tools.decode_split_trace    # from a checkout; one NVIDIA GPU

Builds a copy of ``csrc/decode_split.cuh`` in which thread 0 of every block
stamps the device clock (``%globaltimer``) after each phase, with a small
runner program, by ``nvcc`` into ``cxrmate_torch/_build/trace/``, and runs it in bf16
at the decode-attention shapes of ``chip_smoke.py``'s main paths, with the
same masks (``chip_smoke.key_mask``): the four kernels on the body
(``decode_attention_q8`` with int8 K/V and fp32 scales; ``fused_cross_attn``
under the fused contract, its integer study mask, at the fused path's cross
shape). One JSON line per shape and L2 state: the time of a launch
(``warm``: CUDA events over back-to-back launches on the same inputs, whose
K/V largely stay in the 50 MB L2; ``cold``: each launch timed alone after a
512 MB read, which leaves L2 full of clean lines, as a decode step's layer
finds it), the span of the traced launch, blocks resident per SM and
clusters at once (the occupancy API), the median, 90th percentile and largest
time of each phase over the blocks, and the unmasked key tiles each SM was
given. A phase ends at a block barrier or
a cluster barrier, so its time includes the wait for the slowest thread or
block. The stamps are the only difference from the kernel the port runs; an
anchor that is no longer in the source fails the run.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

PHASES = ("mask+list", "K", "max+sync1", "sum+sync2", "p+V", "push+sync3", "out")
# stamp p goes right after its anchor, each of which occurs once in the source
_ANCHORS = (
    "  constexpr int kSlot = kTile * R::kCopyLpk;  // 16-byte copies of one ring slot\n",
    "  const int nt = n_listed;\n",
    "    stage(j + kRing);\n  }\n  __syncthreads();\n",
    "  // values: one remote round trip)\n  cluster.sync();\n",
    "      xsum[tid] = x;\n    }\n  }\n  cluster.sync();\n",
    "  __syncthreads();  // every warp is done with the ring: the partials take its place\n",
    "    *cluster.map_shared_rank(gather + rank * owned + i % owned, i / owned) = x;\n"
    "  }\n  cluster.sync();\n",
    "    ob[rank * owned + e] = cxr::from_float<T>(x);\n  }\n",
)
_STAMP = (
    "__device__ unsigned long long* g_trace;\n"
    "#define STAMP(p) do { if (threadIdx.x == 0) { unsigned long long t_; "
    "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); g_trace[blockIdx.x * 9 + (p)] = t_; "
    "if ((p) == 0) { unsigned s_; asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(s_)); "
    "g_trace[blockIdx.x * 9 + 8] = s_; } } } while (0)\n"
)
_RUNNER = r'''
#include <algorithm>
#include <cstdio>
#include <vector>
#include "split_traced.cuh"
using namespace cxr::split;
#define CK(x) do { cudaError_t e_ = (x); if (e_ != cudaSuccess) { \
  fprintf(stderr, "%s at line %d\n", cudaGetErrorString(e_), __LINE__); return 1; } } while (0)

template <typename KV> KV kv_value(size_t i);
template <> __nv_bfloat16 kv_value<__nv_bfloat16>(size_t i) {
  return __float2bfloat16((float)(i * 104729 % 1000) / 1000.f - 0.5f);
}
template <> signed char kv_value<signed char>(size_t i) { return (signed char)((int)(i * 104729 % 255) - 127); }

static bool g_cold = false;  // a 512 MB read before each timed launch, which is then timed alone

__global__ void flush_read(const int4* p, size_t n, int* sink) {
  int acc = 0;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x)
    acc ^= p[i].x ^ p[i].w;
  if (acc == 0x7fffffff) *sink = acc;  // keeps the loads
}

template <typename KV, int MM, bool kExact, typename C = Decode>
int run(int B, int M, int S, int n, int chunk, const char* mask_path, int reps) {
  const int H = 12, tiles_all = (S + kTile - 1) / kTile, blocks = n * B * H;
  const size_t nq = (size_t)B * H * M * kDh, nk = (size_t)B * H * S * kDh;
  constexpr bool q8 = sizeof(KV) == 1;
  std::vector<__nv_bfloat16> hq(nq);
  std::vector<KV> hk(nk);
  std::vector<float> hs((size_t)B * H * S, 0.01f);
  for (size_t i = 0; i < nq; ++i) hq[i] = __float2bfloat16((float)(i * 7919 % 1000) / 1000.f - 0.5f);
  for (size_t i = 0; i < nk; ++i) hk[i] = kv_value<KV>(i);
  std::vector<typename C::Mask> hm((size_t)B * S);
  FILE* f = fopen(mask_path, "rb");
  if (!f || fread(hm.data(), 4, hm.size(), f) != hm.size()) { fprintf(stderr, "mask %s\n", mask_path); return 1; }
  fclose(f);
  __nv_bfloat16 *q, *o;
  KV *k, *v;
  typename C::Mask* mk;
  float* sc;
  unsigned long long* tr;
  CK(cudaMalloc(&q, nq * 2)); CK(cudaMalloc(&k, nk * sizeof(KV))); CK(cudaMalloc(&v, nk * sizeof(KV)));
  CK(cudaMalloc(&o, nq * 2)); CK(cudaMalloc(&mk, hm.size() * 4)); CK(cudaMalloc(&sc, hs.size() * 4));
  CK(cudaMalloc(&tr, (size_t)blocks * 9 * 8));
  CK(cudaMemcpyToSymbol(g_trace, &tr, sizeof(tr)));
  CK(cudaMemcpy(q, hq.data(), nq * 2, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(k, hk.data(), nk * sizeof(KV), cudaMemcpyHostToDevice));
  CK(cudaMemcpy(v, hk.data(), nk * sizeof(KV), cudaMemcpyHostToDevice));
  CK(cudaMemcpy(mk, hm.data(), hm.size() * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(sc, hs.data(), hs.size() * 4, cudaMemcpyHostToDevice));
  const size_t smem = smem_bytes(M, chunk, sizeof(KV));
  auto fn = decode_split_kernel<__nv_bfloat16, KV, MM, kExact, C>;
  int per_sm = 0, clusters = 0;
  CK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem));
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n; attr[0].val.clusterDim.y = 1; attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks); cfg.blockDim = dim3(kThreads); cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr; cfg.numAttrs = 1;
  CK(cudaOccupancyMaxActiveClusters(&clusters, (void*)fn, &cfg));
  auto once = [&]() { return launch<__nv_bfloat16, KV, kExact, C>(
      q, k, v, q8 ? sc : nullptr, q8 ? sc : nullptr, mk, o, B * H, H, M, S, kDh, n, chunk, 0.125f, 0); };
  for (int i = 0; i < 3; ++i) CK(once());
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  CK(cudaDeviceSynchronize());
  float ms = 0;
  if (!g_cold) {
    cudaEventRecord(e0);
    for (int i = 0; i < reps; ++i) CK(once());
    cudaEventRecord(e1);
    CK(cudaDeviceSynchronize());
    cudaEventElapsedTime(&ms, e0, e1);
  } else {
    static int4* fl = nullptr;
    static int* sink = nullptr;
    const size_t nfl = ((size_t)512 << 20) / 16;
    if (!fl) {
      CK(cudaMalloc(&fl, nfl * 16)); CK(cudaMemset(fl, 0, nfl * 16)); CK(cudaMalloc(&sink, 4));
    }
    for (int i = 0; i < reps; ++i) {
      flush_read<<<1056, 512>>>(fl, nfl, sink);
      cudaEventRecord(e0);
      CK(once());
      cudaEventRecord(e1);
      CK(cudaDeviceSynchronize());
      float one = 0;
      cudaEventElapsedTime(&one, e0, e1);
      ms += one;
    }
  }
  std::vector<unsigned long long> t((size_t)blocks * 9);
  CK(cudaMemcpy(t.data(), tr, t.size() * 8, cudaMemcpyDeviceToHost));
  unsigned long long t0 = ~0ull, t1 = 0;
  for (int b = 0; b < blocks; ++b) { t0 = std::min(t0, t[b * 9]); t1 = std::max(t1, t[b * 9 + 7]); }
  printf("{\"b\": %d, \"m\": %d, \"s\": %d, \"n_split\": %d, \"chunk\": %d, \"blocks\": %d, "
         "\"blocks_per_sm\": %d, \"clusters_at_once\": %d, \"us_per_launch\": %.3f, \"traced_span_us\": %.3f, "
         "\"phases_us\": {", B, M, S, n, chunk, blocks, per_sm, clusters, ms * 1e3 / reps, (t1 - t0) / 1e3);
  const char* names[7] = {"mask+list", "K", "max+sync1", "sum+sync2", "p+V", "push+sync3", "out"};
  for (int p = 0; p < 7; ++p) {
    std::vector<double> d;
    for (int b = 0; b < blocks; ++b) d.push_back((t[b * 9 + p + 1] - t[b * 9 + p]) / 1e3);
    std::sort(d.begin(), d.end());
    printf("%s\"%s\": [%.3f, %.3f, %.3f]", p ? ", " : "", names[p], d[d.size() / 2],
           d[d.size() * 9 / 10], d.back());
  }
  // unmasked tiles of each block (its tiles dealt every n; cluster c is the
  // (row, head) c, heads fastest), summed per SM
  std::vector<int> sm_tiles(1024, 0), sm_blocks(1024, 0);
  for (int blk = 0; blk < blocks; ++blk) {
    const int c = blk / n, r = blk % n, b = c / H;
    int open = 0;
    for (int g = r; g < tiles_all; g += n) {
      bool any = false;
      for (int i = g * kTile; i < std::min(S, g * kTile + kTile); ++i) any |= !C::skip(hm[(size_t)b * S + i]);
      open += any;
    }
    const unsigned sm = (unsigned)t[blk * 9 + 8] % 1024;
    sm_tiles[sm] += open; sm_blocks[sm]++;
  }
  int lo = 1 << 30, hi = 0, used = 0; double sum = 0;
  for (int i = 0; i < 1024; ++i)
    if (sm_blocks[i]) { lo = std::min(lo, sm_tiles[i]); hi = std::max(hi, sm_tiles[i]); sum += sm_tiles[i]; used++; }
  printf("}, \"sms_used\": %d, \"sm_unmasked_tiles\": [%d, %.2f, %d]}\n", used, lo, sum / used, hi);
  cudaFree(q); cudaFree(k); cudaFree(v); cudaFree(o); cudaFree(mk); cudaFree(sc); cudaFree(tr);
  return 0;
}

int main(int argc, char** argv) {
  // argv: cold (0: back-to-back launches, 1: a read flush before each), then groups of
  // B M S n_split chunk kind mask_path (kind 0: decode_attention, 1: vpu, 2: q8,
  // 3: fused_cross_attn, M = 1)
  g_cold = argc > 1 && atoi(argv[1]) != 0;
  for (int a = 2; a + 6 < argc; a += 7) {
    const int B = atoi(argv[a]), M = atoi(argv[a + 1]), S = atoi(argv[a + 2]);
    const int n = atoi(argv[a + 3]), chunk = atoi(argv[a + 4]), kind = atoi(argv[a + 5]);
    const char* mp = argv[a + 6];
    using bf = __nv_bfloat16;
    using i8 = signed char;
    int rc = kind == 3 ? run<bf, 1, false, Fused>(B, M, S, n, chunk, mp, 30)
           : kind == 2 ? (M == 1 ? run<i8, 1, false>(B, M, S, n, chunk, mp, 30)
                                 : run<i8, 4, false>(B, M, S, n, chunk, mp, 30))
           : M == 1 ? (kind ? run<bf, 1, true>(B, M, S, n, chunk, mp, 30) : run<bf, 1, false>(B, M, S, n, chunk, mp, 30))
                    : (kind ? run<bf, 4, true>(B, M, S, n, chunk, mp, 30) : run<bf, 4, false>(B, M, S, n, chunk, mp, 30));
    if (rc) return rc;
    fflush(stdout);
  }
  return 0;
}
'''


def traced_source(src: str) -> str:
    """decode_split.cuh with STAMP(p) after anchor p."""
    for p, anchor in enumerate(_ANCHORS):
        if src.count(anchor) != 1:
            raise RuntimeError(f"decode_split_trace: anchor {p} is not in decode_split.cuh once: "
                               f"{anchor!r}")
        src = src.replace(anchor, anchor + f"  STAMP({p});\n")
    return src.replace('#include "common.cuh"\n', '#include "common.cuh"\n' + _STAMP, 1)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("decode_split_trace needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from cxrmate_torch.ops import _build
    from cxrmate_torch.ops import decode_attention as da

    repo = _build._PKG.parent
    sys.path.insert(0, str(repo))
    import chip_smoke as cs

    out = _build.BUILD_ROOT / "trace"
    out.mkdir(parents=True, exist_ok=True)
    (out / "split_traced.cuh").write_text(traced_source((_build.CSRC / "decode_split.cuh")
                                                        .read_text()))
    (out / "runner.cu").write_text(_RUNNER)
    subprocess.run([_build._nvcc(), *_build.COMPILE_FLAGS[:4], "-I", str(_build.CSRC), "-o",
                    str(out / "runner"), str(out / "runner.cu")], check=True)
    calls = sorted({c for p in cs.main_path_calls(da).values() for c in p["decode"]})
    calls.append(("fused_cross_attn", cs.STUDIES, 1, cs.SLOTS * 576, "slots"))
    kinds = (*cs.SPLIT, "fused_cross_attn")
    args = []
    for i, (kernel, b, m, s, kind) in enumerate(calls):
        path = out / f"mask{i}.bin"
        mask = cs.key_mask(torch, kind, b, s).cpu().numpy()
        if kernel == "fused_cross_attn":  # the study mask: non-zero = open
            (mask == 0).astype(np.int32).tofile(path)
        else:
            mask.astype(np.float32).tofile(path)
        n_split, chunk = da.decode_schedule(s, 64)
        args += [b, m, s, n_split, chunk, kinds.index(kernel), path]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for cold in (0, 1):
        res = subprocess.run([str(out / "runner"), str(cold), *map(str, args)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr, file=sys.stderr)
            return res.returncode
        for line, (kernel, b, m, s, kind) in zip(res.stdout.splitlines(), calls):
            print(json.dumps({"kernel": kernel, "mask": kind, "l2": "cold" if cold else "warm",
                              **json.loads(line)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
