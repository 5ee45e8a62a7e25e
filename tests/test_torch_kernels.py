"""The port's five kernels: each plain version against the JAX Pallas kernel
(interpret mode on the CPU, as the JAX package's own tests run it), and on a
card each CUDA kernel against its plain version. Also the routing grammar and
the int8 quantisation beside the kernels.

Tolerances: attention in fp32 1e-5 (the JAX package's own flash bound; 2e-5
for the multiply-reduce and int8 kernels, whose sums run in another order
than the interpreter's), bf16 1e-2 on the card; the beam reorder is data
movement and the quantisation is elementwise, so both are bit-exact.

The file imports neither JAX nor the shared harness at module level, so that
the CUDA tests run on the card's machine as they are (with ``--noconftest``:
tests/conftest.py configures JAX):
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda
"""

import inspect
import types

import numpy as np
import pytest
import torch

from cxrmate_torch.ops import beam_reorder as br
from cxrmate_torch.ops import decode_attention as da
from cxrmate_torch.ops import flash_attention as fa
from cxrmate_torch.ops import fused_decode as fd
from cxrmate_torch.utils.precision import parity_mode
# as in the harness: the full suite runs six xdist workers on eight cores
torch.set_num_threads(2)
NEG = float(np.finfo(np.float32).min)
TOL = dict(rtol=1e-5, atol=1e-5)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture
def cuda_device():
    """The card, for the tests of the CUDA kernels; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _qkv(seed, bh, lq, lk, d):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(bh, n, d).astype(np.float32) for n in (lq, lk, lk))


def _decode_inputs(seed, b, h, m, s, dh):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, m, dh).astype(np.float32)
    k = rs.randn(b, h, s, dh).astype(np.float32)
    v = rs.randn(b, h, s, dh).astype(np.float32)
    mask = np.where(rs.rand(b, s) > 0.25, 0.0, NEG).astype(np.float32)
    mask[-1] = NEG  # a fully masked row: uniform softmax, no NaN
    return q, k, v, mask


def _masked_like_the_paths(seed, b, s, kind):
    """A [b, s] mask for the split kernels' edge cases: ``random`` (a quarter
    of the keys masked), ``chunk`` (random, and every key of the second block
    of decode_schedule masked in every row: it reads nothing while its row
    has unmasked keys elsewhere), ``last`` (random, and the last row's only
    unmasked key is the last key, in the last tile), ``slots`` (row i's first
    (i + 1) image slots of 576 keys open, the rest masked, as a study's
    all-zero slots) or ``dark`` (every key masked). Row 0 is fully masked, as
    in _decode_inputs."""
    rs = np.random.RandomState(seed)
    mask = np.where(rs.rand(b, s) > 0.25, 0.0, NEG).astype(np.float32)
    blocks = da.block_tiles(s, 64)
    if kind == "chunk" and len(blocks) > 1:
        for t in blocks[1]:
            mask[:, t * 64:(t + 1) * 64] = NEG
    elif kind == "last":
        mask[-1] = NEG
        mask[-1, -1] = 0.0
    elif kind == "slots":
        for i in range(b):
            mask[i] = np.where(np.arange(s) < (i + 1) * 576, 0.0, NEG)
    elif kind == "dark":
        mask[:] = NEG
    mask[0] = NEG
    return mask


def _reorder_inputs(seed, groups, beams, h, t_len, dh):
    rs = np.random.RandomState(seed)
    r = groups * beams
    caches = [rs.randn(r, h, t_len, dh).astype(np.float32) for _ in range(2)]
    new = [rs.randn(r, h, dh).astype(np.float32) for _ in range(2)]
    sel = rs.randint(0, beams, r).astype(np.int32)
    sel[:beams] = [1, 1, 0, 1][:beams]  # repeated sources within a group
    return caches, new, sel


# ------------------------------------------------------------- CPU: vs JAX
@pytest.fixture(scope="module")
def jx():
    """The JAX package's Pallas kernels, run in interpret mode below."""
    jnp = pytest.importorskip("jax.numpy")
    from cxrmate_tpu.ops import decode_attention as jda
    from cxrmate_tpu.ops.beam_reorder import beam_reorder_write
    from cxrmate_tpu.ops.flash_attention import flash_attention

    return types.SimpleNamespace(jnp=jnp, flash=flash_attention, decode=jda.decode_attention,
                                 reorder=beam_reorder_write, da=jda)


@pytest.mark.parametrize("lq,lk,d", [(64, 64, 16), (100, 52, 16)])  # second: ragged
def test_flash_plain_matches_jax_kernel(jx, lq, lk, d):
    q, k, v = _qkv(0, 3, lq, lk, d)
    scale = 40 ** -0.5  # CvT passes embed_dim ** -0.5
    want = jx.flash(jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v), scale,
                    block_q=32, block_k=32, interpret=True)
    got = fa.flash_attention(t(q), t(k), t(v), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert fa.flash_attention.launches == 0  # the CPU runs the plain version


@pytest.mark.parametrize("m", [1, 4])
def test_decode_plain_matches_jax_kernel(jx, m):
    q, k, v, mask = _decode_inputs(1, 3, 2, m, 40, 8)
    want = jx.decode(*(jx.jnp.asarray(a) for a in (q, k, v, mask)), 0.35, interpret=True)
    got = da.decode_attention(t(q), t(k), t(v), t(mask), 0.35)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("m", [1, 4])
def test_decode_vpu_plain_matches_jax_kernel(jx, m):
    """2e-5; the last batch row is fully masked and must stay finite."""
    q, k, v, mask = _decode_inputs(6, 4, 2, m, 40, 8)
    want = jx.da.decode_attention_rowgroup_vpu(
        *(jx.jnp.asarray(a) for a in (q, k, v, mask)), 0.35, group=2, interpret=True)
    got = da.decode_attention_vpu(t(q), t(k), t(v), t(mask), 0.35)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert da.decode_attention_vpu.launches == 0  # the CPU runs the plain version


def test_decode_schedule_depends_only_on_s_and_dh():
    """The split's schedule takes (S, dh) and nothing else: no batch, no M,
    no card; the same answer every call."""
    assert list(inspect.signature(da.decode_schedule).parameters) == ["s", "dh"]
    assert da.decode_schedule(2880, 64) == da.decode_schedule(2880, 64) == (8, 384)
    assert da.decode_schedule(256, 64) == (1, 256)
    assert da.decode_schedule(511, 64) == (2, 256)
    assert list(da.block_tiles(576, 64)) == [range(0, 9, 3), range(1, 9, 3), range(2, 9, 3)]
    with pytest.raises(ValueError):
        da.decode_schedule(0, 64)
    with pytest.raises(ValueError):
        da.decode_schedule(256, 128)


@pytest.mark.parametrize("lo,hi", [(1, 1024), (1024, 3200), (3200, 20000)])
def test_decode_schedule_tiles_the_keys(lo, hi):
    """The blocks' key-tiles cover [0, S) without gap or overlap, each block
    holds at least one tile and at most ``chunk`` keys, and a cluster has at
    most MAX_SPLIT blocks."""
    for s in range(lo, hi):
        n_split, chunk = da.decode_schedule(s, 64)
        assert 1 <= n_split <= da.MAX_SPLIT and chunk % da.KEY_TILE == 0
        blocks = da.block_tiles(s, 64)
        assert len(blocks) == n_split and all(1 <= len(b) <= chunk // da.KEY_TILE
                                              for b in blocks)
        assert sorted(t for b in blocks for t in b) == list(range(-(-s // da.KEY_TILE)))


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("itemsize", [2, 4, 1])  # 1: the int8 kernel
def test_decode_max_keys_is_the_shared_memory_limit(m, itemsize):
    """max_keys is the largest S whose block fits in shared memory, for the
    full cluster; one key more does not fit."""
    s = da.max_keys(m, 64, itemsize)
    assert da.decode_schedule(s, 64)[0] == da.MAX_SPLIT
    assert (da.smem_bytes(m, s, 64, itemsize) <= da._SPLIT_SMEM_LIMIT
            < da.smem_bytes(m, s + 1, 64, itemsize))
    assert s > 2880 * 25  # far beyond one block's 232 KB of [M, S] scores


def _split_emulation(q, k, v, mask, scale, scales=None, fused=False):
    """The split kernels' algorithm in plain torch (fp32 scores): per block
    of decode_schedule (its tiles dealt in turn), scores of the keys whose
    mask is not finfo.min only (the others get finfo.min and their K and V
    are never touched), the cluster's max, the blocks' sums of e in rank
    order, probs rounded to the input dtype, partial contexts over the read
    keys, added in rank order. A fully masked row reads every V row. With
    ``scales`` (the int8 kernel's (ks, vs), k and v int8): a read key's dot
    times its K scale before scale and the mask, its prob times its V scale
    before the rounding; a skipped key's scales are never touched. With
    ``fused`` (fused_cross_attn's contract): q and the output are [B, D] rows
    (the heads side by side, M = 1), ``mask`` the integer [B, S] study mask
    (a key is skipped where it is 0, a read key's score is q.k x scale), and
    the probs stay fp32."""
    if fused:
        q = q.reshape(k.shape[0], k.shape[1], 1, k.shape[3])
        read = mask != 0  # [b, s]
        add = torch.zeros(mask.shape)
    else:
        read = mask != NEG
        add = mask
    b, h, m, dh = q.shape
    s = k.shape[2]
    blocks = [torch.cat([torch.arange(t * 64, min(t * 64 + 64, s)) for t in tiles])
              for tiles in da.block_tiles(s, dh)]
    full = ~read.any(1)  # fully masked rows read every V row
    scores = torch.full((b, h, m, s), NEG)
    for bi in range(b):
        keys = read[bi].nonzero()[:, 0]
        dots = q[bi].float() @ k[bi][:, keys].float().transpose(-1, -2)  # only the read keys
        if scales is not None:
            dots = dots * scales[0][bi][..., keys]
        scores[bi][..., keys] = dots * scale + add[bi, keys]
    gmax = torch.stack([scores[..., keys].amax(-1) for keys in blocks]).amax(0)
    e = torch.exp(scores - gmax[..., None])
    total = sum(e[..., keys].sum(-1) for keys in blocks)
    p = e / total[..., None]
    ctx = torch.zeros(b, h, m, dh)
    for bi in range(b):
        keys = torch.arange(s) if full[bi] else read[bi].nonzero()[:, 0]
        pk = p[bi][..., keys]
        if scales is not None:
            pk = pk * scales[1][bi][..., keys]
        if not fused:
            pk = pk.to(q.dtype).float()
        for own in blocks:
            at = torch.isin(keys, own)
            ctx[bi] += pk[..., at] @ v[bi][:, keys[at]].float()
    return ctx.reshape(b, h * dh).to(q.dtype) if fused else ctx.to(q.dtype)


@pytest.mark.parametrize("m,s,kind,kv", [
    pytest.param(*c, "float", id="-".join(map(str, c))) for c in
    [(4, 37, "random"), (1, 511, "random"), (4, 512, "chunk"), (1, 513, "last"),
     (4, 2880, "chunk"), (1, 3073, "last")]] + [
    pytest.param(*c, "int8", id="q8-" + "-".join(map(str, c))) for c in
    [(4, 37, "random"), (1, 513, "last"), (4, 2880, "chunk")]] + [
    pytest.param(*c, "fused", id="fused-" + "-".join(map(str, c))) for c in
    [(1, 37, "random"), (1, 2880, "slots"), (1, 3073, "last"), (1, 2880, "dark")]])
def test_split_without_masked_keys_matches_plain(m, s, kind, kv):
    """Skipping the masked keys and splitting S is exact: the emulated split
    on K/V whose masked rows are NaN (never read) equals the plain version
    on clean K/V within 1e-5 in fp32, the fully masked row (uniform) too.
    For int8 K/V (the q8 kernel): the masked keys' int8 rows random and
    their K and V scales NaN, against decode_attention_q8_plain. For the
    fused contract (fused_cross_attn): [B, D] rows, the integer study mask
    (``slots``: whole image slots of 576 keys open, as the fused path's;
    ``dark``: every study fully masked), fp32 probs, against
    fused_cross_attn_plain."""
    q, k, v, _ = _decode_inputs(12, 3, 2, m, s, 64)
    mask = _masked_like_the_paths(13, 3, s, kind)
    q, k, v, mask = t(q), t(k), t(v), t(mask)
    poisoned = (mask == NEG)[:, None, :, None] & (mask != NEG).any(1)[:, None, None, None]
    if kv == "float":
        got = _split_emulation(q, k.masked_fill(poisoned, float("nan")),
                               v.masked_fill(poisoned, float("nan")), mask, 0.125)
        want = da.decode_attention_plain(q, k, v, mask, 0.125)
    elif kv == "fused":
        rows, study = q.reshape(3, -1), (mask != NEG).int()
        got = _split_emulation(rows, k.masked_fill(poisoned, float("nan")),
                               v.masked_fill(poisoned, float("nan")), study, 0.125, fused=True)
        want = fd.fused_cross_attn_plain(rows, k, v, study)
    else:
        (kq, ks), (vq, vs) = da.quantize_kv_rowwise(k), da.quantize_kv_rowwise(v)
        noise = torch.from_numpy(np.random.RandomState(14).randint(-127, 128, (2,) + kq.shape)
                                 .astype(np.int8))
        keys = poisoned[..., 0][:, :, None, :].expand(ks.shape)
        got = _split_emulation(q, torch.where(poisoned, noise[0], kq),
                               torch.where(poisoned, noise[1], vq), mask, 0.125,
                               (ks.masked_fill(keys, float("nan")),
                                vs.masked_fill(keys, float("nan"))))
        want = da.decode_attention_q8_plain(q, kq, ks, vq, vs, mask, 0.125)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


def test_quantize_kv_rowwise_bit_equal_to_jax(jx):
    """Scales and int8 values equal JAX's bit for bit: an all-zero row (scale
    1.0), exact .5 ties (round half to even) and a row at full scale."""
    x = np.random.RandomState(7).randn(2, 3, 16, 8).astype(np.float32)
    x[0, 0, 3] = 0.0
    x[0, 1, 2] = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 63.5], np.float32)
    x[1, 2, 5] = np.array([-127, 127, 126.5, -126.5, 3.5, 4.5, 0, 1], np.float32)
    want_q, want_s = jx.da.quantize_kv_rowwise(jx.jnp.asarray(x))
    got_q, got_s = da.quantize_kv_rowwise(t(x))
    assert got_q.dtype == torch.int8 and tuple(got_s.shape) == (2, 3, 1, 16)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert got_s[0, 0, 0, 3] == 1.0 and got_s[0, 1, 0, 2] == 1.0


@pytest.mark.parametrize("m", [1, 4])
def test_decode_q8_plain_matches_jax_kernel(jx, m):
    """2e-5 on unit-scale data, from the same quantised cache; the last batch
    row is fully masked and must stay finite."""
    q, k, v, mask = _decode_inputs(8, 4, 2, m, 40, 8)
    kq, ks = da.quantize_kv_rowwise(t(k))
    vq, vs = da.quantize_kv_rowwise(t(v))
    want = jx.da.decode_attention_rowgroup_q8(
        *(jx.jnp.asarray(a.numpy() if torch.is_tensor(a) else a)
          for a in (q, kq, ks, vq, vs, mask)), 0.35, group=2, interpret=True)
    got = da.decode_attention_q8(t(q), kq, ks, vq, vs, t(mask), 0.35)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert da.decode_attention_q8.launches == 0


def test_decode_q8_plain_within_quantisation_bounds():
    """Against exact attention on the unquantised K/V, unit-normal data: the
    JAX test's bounds (max < 0.1, RMS < 0.02)."""
    q, k, v, _ = _decode_inputs(9, 2, 4, 1, 192, 64)
    mask = np.zeros((2, 192), np.float32)
    kq, ks = da.quantize_kv_rowwise(t(k))
    vq, vs = da.quantize_kv_rowwise(t(v))
    got = da.decode_attention_q8(t(q), kq, ks, vq, vs, t(mask), 0.125)
    want = da.decode_attention_plain(t(q), t(k), t(v), t(mask), 0.125)
    err = (got - want).abs()
    assert err.max() < 0.1 and err.pow(2).mean().sqrt() < 0.02


def test_resolve_decode_kernel_matches_jax_grammar(jx, monkeypatch):
    """The same specs pass and fail as in the JAX package; None reads the
    environment at call time; :G is validated and changes no routing."""
    good = ("", "0", "1", "rowgrid", "rowgroup", "rowgroup:4", "vpu-rowgroup:2",
            "cross-rowgroup:4", "cross-rowgrid", "cross-vpu-rowgroup", "cross-rowgroup-q8",
            "cross-rowgroup-q8:8")
    bad = ("rowgroup-q8:4", "q8", "cross-", "cross-q8", "rowgroup:", "rowgroup:x",
           "cross-rowgroup-q8:", "CROSS-rowgroup:4")
    for spec in good:
        assert da.resolve_decode_kernel(spec) == jx.da.resolve_decode_kernel(spec)
    for spec in bad:
        for fn in (da.resolve_decode_kernel, jx.da.resolve_decode_kernel):
            with pytest.raises(ValueError, match="invalid CXRMATE_DECODE_KERNEL"):
                fn(spec)
    monkeypatch.setenv("CXRMATE_DECODE_KERNEL", "cross-rowgroup-q8:2")
    assert da.resolve_decode_kernel(None) == "cross-rowgroup-q8:2"
    monkeypatch.setenv("CXRMATE_DECODE_KERNEL", "rowgroup-q8")
    with pytest.raises(ValueError):
        da.resolve_decode_kernel(None)
    monkeypatch.delenv("CXRMATE_DECODE_KERNEL")
    assert da.resolve_decode_kernel(None) == ""
    routes = {spec: (da.uses_vpu(spec, False), da.uses_vpu(spec, True), da.is_q8(spec))
              for spec in good}
    assert routes["vpu-rowgroup:2"] == (True, True, False)
    assert routes["cross-vpu-rowgroup"] == (False, True, False)
    assert routes["cross-rowgroup-q8:8"] == (False, False, True)
    assert all(r == (False, False, False) for s, r in routes.items()
               if "vpu" not in s and "q8" not in s)


@pytest.mark.parametrize("index", [5, 0, 15, -1])
def test_beam_reorder_plain_matches_jax_kernel_bit_exact(jx, index):
    (ck, cv), (nk, nv), sel = _reorder_inputs(2, 3, 4, 2, 16, 8)
    want_k, want_v = jx.reorder(*(jx.jnp.asarray(a) for a in (ck, cv, nk, nv, sel)),
                                jx.jnp.asarray(index, jx.jnp.int32), beams=4, interpret=True)
    tk, tv = t(ck), t(cv)
    br.beam_reorder_write(tk, tv, t(nk), t(nv), t(sel), index, 4)  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(want_v))


# ---------------------------------------------- card: kernel vs plain version
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
# CvT stage 2 (ragged in Lq and Lk, three key tiles); one ragged tile; a
# multi-tile Lk that is not a multiple of the tile; CvT stage 1
@pytest.mark.parametrize("lq,lk", [(577, 145), (300, 52), (300, 200), (2304, 576)])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, tol, lq, lk):
    q, k, v = (t(a).to(cuda_device, dtype) for a in _qkv(3, 6, lq, lk, 64))
    with parity_mode():
        got = fa.flash_attention(q, k, v, 384 ** -0.5)
        want = fa.flash_attention_plain(q, k, v, 384 ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_entries_give_bit_equal_out_on_card(cuda_device, dtype):
    """Inference and the training forward launch one compiled kernel: the
    same out, bit for bit; lse within 1e-5 of the plain log-sum-exp."""
    q, k, v = (t(a).to(cuda_device, dtype) for a in _qkv(4, 6, 577, 145, 64))
    with parity_mode():
        out = fa.flash_attention(q, k, v, 384 ** -0.5)
        out_lse, lse = fa.flash_attention_fwd_lse(q, k, v, 384 ** -0.5)
        _, want = fa.flash_attention_fwd_lse_plain(q, k, v, 384 ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(out, out_lse)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


# the main paths' widths, then decode_schedule's edges: S below one tile,
# one key below, at and above full blocks (511-513: 2 blocks of 256 keys, then
# 3 of 192; 3071-3073: 8 of 384, then of 448), every key of one block masked
# while its row has unmasked keys elsewhere, and a row whose only unmasked key
# is in the last tile
SPLIT_SHAPES = [(1, 2880, "random"), (4, 2880, "random"), (1, 256, "random"),
                (1, 511, "random"), (4, 1, "random"), (1, 37, "random"), (4, 511, "chunk"),
                (1, 512, "random"), (4, 513, "last"), (1, 3071, "chunk"), (4, 3072, "random"),
                (1, 3073, "last"), (4, 2880, "chunk")]


def _split_inputs(seed, m, s, kind, device, dtype):
    q, k, v, mask = _decode_inputs(seed, 3, 12, m, s, 64)
    if kind != "random":
        mask = _masked_like_the_paths(seed + 1, 3, s, kind)
    return (*(t(a).to(device, dtype) for a in (q, k, v)), t(mask).to(device))


def _kernel_args(kernel, q, k, v):
    """The K/V arguments of a decode kernel: (k, v), or for the int8 kernel
    the quantised (kq, ks, vq, vs) of the fp32 K/V."""
    if kernel != "decode_attention_q8":
        return k, v
    (kq, ks), (vq, vs) = da.quantize_kv_rowwise(k.float()), da.quantize_kv_rowwise(v.float())
    return kq, ks, vq, vs


def _poison(kv, mask, seed):
    """The K/V arguments with every masked key of a row that has an unmasked
    key poisoned: K/V rows NaN, or for the int8 kernel random int8 rows and
    NaN scales. A kernel that reads any of them spreads the NaN."""
    poisoned = (mask == NEG)[:, None, :, None] & (mask != NEG).any(1)[:, None, None, None]
    if len(kv) == 2:
        return tuple(x.masked_fill(poisoned, float("nan")) for x in kv)
    g = torch.Generator(device=mask.device).manual_seed(seed)
    kq, ks, vq, vs = kv
    keys = poisoned[..., 0][:, :, None, :].expand(ks.shape)
    noise = [torch.randint(-127, 128, kq.shape, generator=g, device=mask.device,
                           dtype=torch.int8) for _ in range(2)]
    return (torch.where(poisoned, noise[0], kq), ks.masked_fill(keys, float("nan")),
            torch.where(poisoned, noise[1], vq), vs.masked_fill(keys, float("nan")))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("m,s,kind", SPLIT_SHAPES)
def test_decode_kernel_matches_plain_on_card(cuda_device, dtype, tol, m, s, kind):
    q, k, v, mask = _split_inputs(4, m, s, kind, cuda_device, dtype)
    with parity_mode():
        got = da.decode_attention(q, k, v, mask, 0.125)
        want = da.decode_attention_plain(q, k, v, mask, 0.125)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("m,s,kind", SPLIT_SHAPES)
def test_decode_vpu_kernel_matches_plain_on_card(cuda_device, dtype, tol, m, s, kind):
    q, k, v, mask = _split_inputs(10, m, s, kind, cuda_device, dtype)
    got = da.decode_attention_vpu(q, k, v, mask, 0.125)
    want = da.decode_attention_vpu_plain(q, k, v, mask, 0.125)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # a row's bits do not depend on the batch it is in: each row alone
    for i in range(q.shape[0]):
        alone = da.decode_attention_vpu(q[i:i + 1], k[i:i + 1], v[i:i + 1], mask[i:i + 1],
                                        0.125)
        assert torch.equal(alone, got[i:i + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["decode_attention", "decode_attention_vpu",
                                    "decode_attention_q8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,s,kind", [(4, 2880, "chunk"), (1, 513, "last"), (4, 37, "random")])
def test_decode_kernels_never_read_masked_keys_on_card(cuda_device, kernel, dtype, m, s, kind):
    """K and V rows of masked keys set to NaN in the rows that have an
    unmasked key (int8: the rows random, the K and V scales NaN): the
    output's bits do not change (a read would spread the NaN). The fully
    masked row 0 reads every V row, which stays clean."""
    q, k, v, mask = _split_inputs(14, m, s, kind, cuda_device, dtype)
    run = getattr(da, kernel)
    kv = _kernel_args(kernel, q, k, v)
    clean = run(q, *kv, mask, 0.125)
    dirty = run(q, *_poison(kv, mask, 14), mask, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(clean, dirty)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["decode_attention", "decode_attention_vpu",
                                    "decode_attention_q8"])
def test_decode_kernels_take_the_largest_s_on_card(cuda_device, kernel):
    """The largest S the cluster's shared memory holds at M = 4 runs and
    agrees with the plain version (bf16, 1e-2); one key more raises."""
    q8 = kernel == "decode_attention_q8"
    s = da.max_keys(4, 64, 1 if q8 else 2)
    g = torch.Generator(device=cuda_device).manual_seed(15)
    q, k, v = (torch.randn(1, 12, n, 64, generator=g, device=cuda_device).to(torch.bfloat16)
               for n in (4, s, s))
    kv = _kernel_args(kernel, q, k, v)
    mask = t(_masked_like_the_paths(16, 2, s, "chunk")[1:]).to(cuda_device)
    got = getattr(da, kernel)(q, *kv, mask, 0.125)
    want = getattr(da, kernel + "_plain")(q, *kv, mask, 0.125)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    k1 = torch.zeros(1, 12, s + 1, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="exceeds"):
        getattr(da, kernel)(q, *_kernel_args(kernel, q, k1, k1),
                            torch.zeros(1, s + 1, device=cuda_device), 0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("m,s,kind", SPLIT_SHAPES)
def test_decode_q8_kernel_matches_plain_on_card(cuda_device, dtype, tol, m, s, kind):
    q, k, v, mask = _split_inputs(11, m, s, kind, cuda_device, torch.float32)
    q = q.to(dtype)
    kv = _kernel_args("decode_attention_q8", q, k, v)
    with parity_mode():
        got = da.decode_attention_q8(q, *kv, mask, 0.125)
        want = da.decode_attention_q8_plain(q, *kv, mask, 0.125)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("index", [70, 0, -1])
def test_beam_reorder_kernel_matches_plain_on_card(cuda_device, dtype, index):
    (ck, cv), (nk, nv), sel = _reorder_inputs(5, 8, 4, 12, 80, 64)
    args = [t(a).to(cuda_device, dtype) for a in (ck, cv, nk, nv)]
    sel = t(sel).to(cuda_device)
    got = [a.clone() for a in args[:2]]
    want = [a.clone() for a in args[:2]]
    br.beam_reorder_write(*got, args[2], args[3], sel, index, 4)
    br.beam_reorder_write_plain(*want, args[2], args[3], sel, index, 4)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    """On CUDA tensors a wrapper launches its kernel or raises; it never falls
    back to the plain version."""
    f16 = torch.zeros(2, 8, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(f16, f16, f16, 0.125)
    q = torch.zeros(2, 8, 128, device=cuda_device)  # head dim above 64
    with pytest.raises(ValueError, match="D = 64"):
        fa.flash_attention(q, q, q, 0.125)
    odd = torch.zeros(2 * 8 * 64 + 1, device=cuda_device, dtype=torch.bfloat16)[1:].view(2, 8, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):  # TMA reads the bf16 tiles
        fa.flash_attention(odd, odd, odd, 0.125)
    q = torch.zeros(2, 12, 1, 64, device=cuda_device)
    kv = torch.zeros(2, 12, 10, 64, device=cuda_device)
    with pytest.raises(ValueError, match="mask"):
        da.decode_attention(q, kv, kv, torch.zeros(2, 11, device=cuda_device), 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(q, kv.transpose(2, 3).contiguous().transpose(2, 3), kv,
                            torch.zeros(2, 10, device=cuda_device), 0.125)
    with pytest.raises(ValueError, match="dtype"):
        da.decode_attention_vpu(q, kv.half(), kv.half(), torch.zeros(2, 10, device=cuda_device),
                                0.125)
    scales = torch.ones(2, 12, 1, 10, device=cuda_device)
    with pytest.raises(ValueError, match="int8"):
        da.decode_attention_q8(q, kv, scales, kv, scales, torch.zeros(2, 10, device=cuda_device),
                               0.125)
    with pytest.raises(ValueError, match="scales"):
        da.decode_attention_q8(q, kv.to(torch.int8), scales[:, :, 0], kv.to(torch.int8), scales,
                               torch.zeros(2, 10, device=cuda_device), 0.125)
    cache = torch.zeros(8, 2, 16, 64, device=cuda_device)
    new = torch.zeros(8, 2, 64, device=cuda_device)
    sel = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        br.beam_reorder_write(cache, cache.clone(), new, new, sel, 0, 4)
    with pytest.raises(ValueError, match="index"):
        br.beam_reorder_write(cache, cache.clone(), new, new, sel.int(), 16, 4)
