"""The port's three kernels: each plain version against the JAX Pallas kernel
(interpret mode on the CPU, as the JAX package's own tests run it), and on a
card each CUDA kernel against its plain version.

Tolerances: attention in fp32 1e-5 (the JAX package's own flash bound),
bf16 1e-2 on the card; the beam reorder is data movement, so bit-exact.

The file imports neither JAX nor the shared harness at module level, so that
the CUDA tests run on the card's machine as they are (with ``--noconftest``:
tests/conftest.py configures JAX):
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda
"""

import types

import numpy as np
import pytest
import torch

from cxrmate_torch.ops import beam_reorder as br
from cxrmate_torch.ops import decode_attention as da
from cxrmate_torch.ops import flash_attention as fa
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
    from cxrmate_tpu.ops.beam_reorder import beam_reorder_write
    from cxrmate_tpu.ops.decode_attention import decode_attention
    from cxrmate_tpu.ops.flash_attention import flash_attention

    return types.SimpleNamespace(jnp=jnp, flash=flash_attention, decode=decode_attention,
                                 reorder=beam_reorder_write)


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
@pytest.mark.parametrize("lq,lk", [(577, 145), (300, 52)])  # CvT stage 2; ragged
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, tol, lq, lk):
    q, k, v = (t(a).to(cuda_device, dtype) for a in _qkv(3, 6, lq, lk, 64))
    with parity_mode():
        got = fa.flash_attention(q, k, v, 384 ** -0.5)
        want = fa.flash_attention_plain(q, k, v, 384 ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("m,s", [(1, 2880), (4, 2880), (1, 256)])
def test_decode_kernel_matches_plain_on_card(cuda_device, dtype, tol, m, s):
    q, k, v, mask = _decode_inputs(4, 3, 12, m, s, 64)
    q, k, v = (t(a).to(cuda_device, dtype) for a in (q, k, v))
    mask = t(mask).to(cuda_device)
    with parity_mode():
        got = da.decode_attention(q, k, v, mask, 0.125)
        want = da.decode_attention_plain(q, k, v, mask, 0.125)
    torch.cuda.synchronize()
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
    q = torch.zeros(2, 12, 1, 64, device=cuda_device)
    kv = torch.zeros(2, 12, 10, 64, device=cuda_device)
    with pytest.raises(ValueError, match="mask"):
        da.decode_attention(q, kv, kv, torch.zeros(2, 11, device=cuda_device), 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(q, kv.transpose(2, 3).contiguous().transpose(2, 3), kv,
                            torch.zeros(2, 10, device=cuda_device), 0.125)
    cache = torch.zeros(8, 2, 16, 64, device=cuda_device)
    new = torch.zeros(8, 2, 64, device=cuda_device)
    sel = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        br.beam_reorder_write(cache, cache.clone(), new, new, sel, 0, 4)
    with pytest.raises(ValueError, match="index"):
        br.beam_reorder_write(cache, cache.clone(), new, new, sel.int(), 16, 4)
