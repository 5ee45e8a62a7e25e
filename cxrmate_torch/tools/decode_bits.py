"""Hold two builds of the port's decode, fused qkv and FFN kernels to each other bit for bit.

    python3 -m cxrmate_torch.tools.decode_bits save OUT.pt     # from a checkout; one NVIDIA GPU
    python3 -m cxrmate_torch.tools.decode_bits compare A.pt B.pt

``save`` runs ``decode_attention``, ``decode_attention_vpu`` and
``decode_attention_q8`` (on the same K/V quantised by
``quantize_kv_rowwise``) in fp32 and bf16 on inputs made from fixed seeds
with numpy, at the main paths' cross and self shapes and a few edges of the
split (about 30% of the keys masked, one row fully masked), and
``fused_out_ln_ffn`` and ``fused_qkv_attn`` (its context and the cache
column it writes; T = 256, the step at column 128) at the decoder's widths
(D = 768, F = 3,072) for 1, 8 and 11 studies, and saves the outputs. ``compare`` prints how many of
the saved outputs are bit-equal between two files, and exits 1 if any is
not. Run ``save`` from two checkouts (two builds of ``csrc/``) to show that
a change left a kernel's bits as they were.
"""

from __future__ import annotations

import sys

# (B, M, S): the cross calls at M = 1 and 4, beam-4 and greedy self calls,
# below one tile, one key above 8 full blocks
SHAPES = ((8, 1, 2880), (8, 4, 2880), (32, 1, 256), (32, 1, 511), (8, 1, 383), (8, 4, 37),
          (8, 1, 3073))
KERNELS = ("decode_attention", "decode_attention_vpu", "decode_attention_q8", "fused_out_ln_ffn",
           "fused_qkv_attn")
FFN_ROWS = (1, 8, 11)  # the fused kernels' batches: a row alone, one chunk of 8, a ragged second


def save(path: str) -> int:
    import numpy as np
    import torch

    from cxrmate_torch.ops import decode_attention as da
    from cxrmate_torch.ops import fused_decode as fd

    if not torch.cuda.is_available():
        print("decode_bits needs an NVIDIA GPU", file=sys.stderr)
        return 2
    neg = float(np.finfo(np.float32).min)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b, m, s in SHAPES:
            rs = np.random.RandomState(b * 7 + m * 3 + s)
            q, k, v = (torch.from_numpy(rs.randn(b, 12, n, 64).astype(np.float32)).cuda()
                       for n in (m, s, s))
            mask = torch.from_numpy(np.where(rs.rand(b, s) > 0.3, 0.0, neg).astype(np.float32))
            mask = mask.cuda()
            mask[0] = neg
            q8 = (*da.quantize_kv_rowwise(k), *da.quantize_kv_rowwise(v))
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            for name in KERNELS[:2]:
                out[f"{name} {dtype} B={b} M={m} S={s}"] = \
                    getattr(da, name)(q, k, v, mask, 0.125).cpu()
            out[f"decode_attention_q8 {dtype} B={b} M={m} S={s}"] = \
                da.decode_attention_q8(q, *q8, mask, 0.125).cpu()
        rs = np.random.RandomState(768)
        d, f = 768, 3072

        def rn(*shape, scale=1.0):
            return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).cuda().to(dtype)

        weights = (rn(d, d, scale=0.02), rn(d, scale=0.02), rn(d, scale=0.05) + 0.3,
                   rn(d, scale=0.02), rn(f, d, scale=0.02), rn(f, scale=0.02),
                   rn(d, f, scale=0.02), rn(d, scale=0.02), rn(d, scale=0.05) + 0.3,
                   rn(d, scale=0.02))
        cctx, res = rn(max(FFN_ROWS), d), rn(max(FFN_ROWS), d)
        wqkv, bqkv = rn(3 * d, d, scale=0.02), rn(3 * d, scale=0.02)
        cache = [rn(max(FFN_ROWS), 12, 256, 64, scale=0.5) for _ in range(2)]
        key_mask = torch.ones(max(FFN_ROWS), 256, dtype=torch.int32, device="cuda")
        key_mask[1, 3:9] = 0
        for b in FFN_ROWS:
            out[f"fused_out_ln_ffn {dtype} B={b}"] = \
                fd.fused_out_ln_ffn(cctx[:b], res[:b], *weights, 1e-12).cpu()
            ck, cv = (c[:b].clone() for c in cache)
            ctx = fd.fused_qkv_attn(cctx[:b], wqkv, bqkv, ck, cv, 128, key_mask[:b])
            out[f"fused_qkv_attn {dtype} B={b}"] = torch.cat(
                [ctx, ck[:, :, 128].reshape(b, -1), cv[:, :, 128].reshape(b, -1)], 1).cpu()
    torch.save(out, path)
    print(f"saved {len(out)} outputs to {path}")
    return 0


def compare(a: str, b: str) -> int:
    import torch

    x, y = torch.load(a), torch.load(b)
    differ = [k for k in x if k not in y or not torch.equal(x[k], y[k])]
    print(f"bit-equal: {len(x) - len(differ)} of {len(x)}; differ: {differ}")
    return 1 if differ or set(x) != set(y) else 0


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "save":
        return save(argv[1])
    if len(argv) == 3 and argv[0] == "compare":
        return compare(argv[1], argv[2])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
