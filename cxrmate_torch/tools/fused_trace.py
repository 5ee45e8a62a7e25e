"""Where the time of ``fused_out_ln_q``'s, ``fused_out_ln_ffn``'s and v1's
(``fused_layer_step``) kernels goes, stage by stage, on the card.

    python3 -m cxrmate_torch.tools.fused_trace [--kernel out_ln_q|out_ln_ffn|layer_step]
                                               [--csrc DIR]    # one NVIDIA GPU

Builds a copy of the kernel's source (``csrc/fused_<kernel>.cu``) and of
``csrc/fused_decode.cuh`` in which thread 0 of every block stamps the device
clock (``%globaltimer``) at the kernel's start, before and after every grid
barrier (a line that is ``grid.sync();`` alone, in the kernel's file or in the
header), at the kernel's end and after the load of its input rows (for
``fused_out_ln_q`` also after the LayerNorm), by ``nvcc`` into
``cxrmate_torch/_build/fused_trace/``. It runs it at the fused main path's
shapes (``chip_smoke.fused_operands``: 8 studies, D = 768, F = 3,072, T = 256,
the step at column 128, S = 2,880 with the all-zero image slots masked), bf16
and fp32. Per kernel and dtype, one JSON line: CUDA-event times of single
launches with L2 flushed before each by a 512 MB write (as a decode step finds
it), the traced span of the last one, and the median and largest time of each
stage over the blocks; then the same with the operands left in L2 (``warm``:
there the events also hold the host's launch, and the span is the device's
time). A block's stamps are taken in the order of their times, so a stamp in a
function of the header counts where it ran; the stages are named from the
number of grid barriers (v1's 8 before and after its redesign). A stage ends at a block or grid barrier, so its time includes the
wait for the slowest thread or block. The stamps are the only difference from
the kernel the port runs; an anchor that is no longer in the sources fails the
run. The anchors hold in the one-warp-an-output form (``dense_pass``) and in
the split-K form alike, so the tool also traces an older checkout's sources:
``--csrc DIR``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

_SLOTS = 64  # stamps a block may take
_START = "  cg::grid_group grid = cg::this_grid();\n"
_END = "    __syncthreads();\n  }\n}\n\ntemplate <typename T>\ncudaError_t launch("
# stamps inside the stages (after the input rows are in shared memory; for
# fused_out_ln_q also after the LayerNorm), in the kernel's file or the header
_EXTRA = {
    "out_ln_q": (r"load_rows<T>\(ctx \+ off,[^;]*;\n\s*__syncthreads\(\);\n",
                 r"layer_norm_rows<T, [^;]*;\n\s*__syncthreads\(\);\n"),
    "out_ln_ffn": (r"load_rows<T>\(cctx \+ off,[^;]*;\n\s*__syncthreads\(\);\n",),
    "layer_step": (),
}
_NAMES = {
    ("out_ln_q", 1): ("load ctx", "Wo pass", "grid sync", "LayerNorm", "Wq pass"),
    ("out_ln_ffn", 3): ("load cctx", "Wo pass", "sync", "LayerNorm 2 + W1 pass", "sync",
                        "W2 pass", "sync", "last LayerNorm"),
    ("layer_step", 8): ("qkv projection", "sync", "self-attention", "sync", "Wo pass", "sync",
                        "LayerNorm 1 + Wcq pass", "sync", "cross-attention", "sync",
                        "Wco pass", "sync", "LayerNorm 2 + W1 pass", "sync", "W2 pass", "sync",
                        "last LayerNorm"),
}
_STAMP = (
    "__device__ unsigned long long* g_trace;\n"
    f"#define STAMP(p) do {{ if (threadIdx.x == 0) {{ unsigned long long t_; "
    "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
    f"g_trace[blockIdx.x * {_SLOTS} + (p)] = t_; }} }} while (0)\n"
)
_SET = "extern \"C\" int cxr_fused_set_trace(void* p) " \
       "{ return cudaMemcpyToSymbol(g_trace, &p, sizeof(p)); }\n"


def traced_sources(kind: str, kernel: str, header: str):
    """(the kernel's source, fused_decode.cuh) with the stamps in place."""
    n = 0

    def fresh():
        nonlocal n
        n += 1
        if n > _SLOTS:
            raise RuntimeError("fused_trace: more stamps than slots")
        return n - 1

    def once(src, anchor, stamp_after=True, regex=False):
        found = re.findall(anchor, src) if regex else [anchor] * src.count(anchor)
        if not found:
            raise RuntimeError(f"fused_trace: anchor not in the sources: {anchor!r}")
        for text in set(found):
            stamp = f"  STAMP({fresh()});\n"
            src = src.replace(text, text + stamp if stamp_after else stamp + text)
        return src

    def syncs(src):
        lines = src.split("\n")
        for i, line in enumerate(lines):
            if line.strip() == "grid.sync();":
                pad = line[:len(line) - len(line.lstrip())]
                lines[i] = f"{pad}STAMP({fresh()}); grid.sync(); STAMP({fresh()});"
        return "\n".join(lines)

    if kernel.count(_START) != 1 or kernel.count(_END) != 1:
        raise RuntimeError("fused_trace: the kernel's start or end anchor is not there once")
    kernel = once(kernel, _START)
    kernel = kernel.replace(_END, _END.replace("  }\n}\n", f"  }}\n  STAMP({fresh()});\n}}\n"))
    for anchor in _EXTRA[kind]:  # in the kernel's file (the old form) or the header
        if re.search(anchor, kernel):
            kernel = once(kernel, anchor, regex=True)
        else:
            header = once(header, anchor, regex=True)
    kernel, header = syncs(kernel), syncs(header)
    header = header.replace('#include "common.cuh"\n', '#include "common.cuh"\n' + _STAMP, 1)
    return kernel + _SET, header


def _names(kind: str, syncs: int, segments: int):
    names = _NAMES.get((kind, syncs))
    if names is None or len(names) != segments:
        return [f"segment {i}" for i in range(segments)]
    return list(names)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=(*_EXTRA, "all"), default="all")
    ap.add_argument("--csrc", help="the kernel sources to trace (default: this checkout's)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fused_trace needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from cxrmate_torch.ops import _build

    repo = _build._PKG.parent
    sys.path.insert(0, str(repo))
    import chip_smoke as cs

    csrc = Path(args.csrc) if args.csrc else _build.CSRC
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    kinds = tuple(_EXTRA) if args.kernel == "all" else (args.kernel,)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    grid = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(128 * 2 ** 20, dtype=torch.int32, device="cuda")
    for kind in kinds:
        out = _build.BUILD_ROOT / "fused_trace" / kind
        out.mkdir(parents=True, exist_ok=True)
        name = f"fused_{kind}.cu"
        kernel, header = traced_sources(kind, (csrc / name).read_text(),
                                        (csrc / "fused_decode.cuh").read_text())
        (out / name).write_text(kernel)
        (out / "fused_decode.cuh").write_text(header)
        subprocess.run([_build._nvcc(), *_build.COMPILE_FLAGS[:6], "-shared", "-I", str(csrc),
                        "-o", str(out / "libtraced.so"), str(out / name)], check=True)
        lib = ctypes.CDLL(str(out / "libtraced.so"))
        trace = torch.zeros(grid * _SLOTS, dtype=torch.int64, device="cuda")
        lib.cxr_fused_set_trace(P(trace.data_ptr()))
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)
        for dtype, sfx in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x = cs.fused_operands(torch, dtype, g)
            b, d = x.hidden.shape
            _, h, t_len, dh = x.cache_k.shape
            s_len, f = x.cross_k.shape[2], x.out_ln_ffn[4].shape[0]
            stream = P(torch.cuda.current_stream().cuda_stream)
            # room for either tree's scratch: the kernels take a pointer
            scratch = torch.empty(8 * 2 ** 20, device="cuda")
            fn = getattr(lib, f"cxr_fused_{kind}_{sfx}")
            if kind == "out_ln_q":
                h1, cq = torch.empty_like(x.hidden), torch.empty_like(x.hidden)
                ptrs = [P(v.data_ptr()) for v in (x.hidden, x.res, *x.out_ln_q, h1, cq, scratch)]
                fn.argtypes = [P] * 11 + [I] * 2 + [F, P]

                def launch():
                    return fn(*ptrs, b, d, 1e-12, stream)
            elif kind == "out_ln_ffn":
                out_ = torch.empty_like(x.hidden)
                ptrs = [P(v.data_ptr()) for v in (x.hidden, x.res, *x.out_ln_ffn, out_, scratch)]
                fn.argtypes = [P] * 14 + [I] * 3 + [F, P]

                def launch():
                    return fn(*ptrs, b, d, f, 1e-12, stream)
            else:
                hid = torch.empty_like(x.hidden)
                arr = (P * 27)(*[v.data_ptr() for v in (
                    x.hidden, x.wqkv, x.bqkv, *x.out_ln_q, *x.out_ln_ffn, x.cache_k, x.cache_v,
                    x.cross_k, x.cross_v, x.self_mask, x.cross_mask, hid, scratch)])
                fn.argtypes = [ctypes.POINTER(P)] + [I] * 8 + [F] * 2 + [P]

                def launch():
                    return fn(arr, b, h, t_len, s_len, d, f, dh, t_len // 2, 1.0 / dh ** 0.5,
                              1e-12, stream)
            for warm in (False, True):
                times = []
                for rep in range(10):
                    if not warm or rep == 0:
                        flush.zero_()
                    if rep == 9:
                        trace.zero_()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    err = launch()
                    end.record()
                    torch.cuda.synchronize()
                    if err:
                        raise RuntimeError(f"fused_trace: {kind} launch failed ({err})")
                    times.append(start.elapsed_time(end) * 1e3)
                t = trace.view(grid, _SLOTS).cpu().numpy().astype(np.int64)
                t = np.sort(np.where(t > 0, t, np.iinfo(np.int64).max), axis=1)
                count = int((t[0] < np.iinfo(np.int64).max).sum())
                t = t[:, :count]
                dt = np.diff(t, axis=1) / 1e3
                names = _names(kind, (count - 2 - len(_EXTRA[kind])) // 2, count - 1)
                stages = [[n, round(float(np.median(dt[:, i])), 3), round(float(dt[:, i].max()), 3)]
                          for i, n in enumerate(names)]
                print(json.dumps({
                    "kernel": f"fused_{kind}", "csrc": str(csrc), "dtype": sfx, "warm": warm,
                    "grid": grid, "event_us": [round(v, 3) for v in times[2:]],
                    "traced_span_us": float((t[:, -1].max() - t[:, 0].min()) / 1e3),
                    "stages_us_name_median_max": stages}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
