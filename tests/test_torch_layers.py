"""Each op of cxrmate_torch/ops/layers.py against its JAX op, fp32 on the CPU.

The port takes PyTorch layouts (linear [out, in], NCHW/OIHW convolutions);
the JAX ops take [in, out] and NHWC/HWIO, so the inputs are transposed here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxrmate_tpu.ops import layers as J
from cxrmate_torch.ops import layers as T
from tests.test_torch_harness import TOL, t

rs = np.random.RandomState(0)


def test_linear():
    x, w, b = rs.randn(3, 5, 24), rs.randn(24, 40) * 0.1, rs.randn(40)
    x, w, b = (a.astype(np.float32) for a in (x, w, b))
    want = J.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    got = T.linear(t(x), t(w.T), t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # bias-free (the projection head)
    want = J.linear({"w": jnp.asarray(w)}, jnp.asarray(x))
    np.testing.assert_allclose(T.linear(t(x), t(w.T)).numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layout", ["2-D", "3-D", "3-D transposed view", "4-D",
                                    "4-D permuted view"])
def test_bf16_linear_adds_the_bias_before_its_one_rounding(layout):
    """bf16 in, fp32 product and bias, one rounding, as the JAX linear: the
    port's bits against JAX's, whatever the input's layout (CvT's q/k/v take
    the tokens of a convolution output, a transposed view). The two fp32 sums
    may differ in order, so the share of equal bits is held, beside the share
    against the product rounded before the bias."""
    x = rs.randn(2, 3, 40, 48).astype(np.float32)
    w = (rs.randn(48, 36) / np.sqrt(48)).astype(np.float32)
    b = rs.randn(36).astype(np.float32)
    xt = t(x).bfloat16()
    xt = {"2-D": xt[0, 0], "3-D": xt[0], "3-D transposed view": xt[0].transpose(-1, -2)[:, :48],
          "4-D": xt, "4-D permuted view": xt.permute(1, 0, 2, 3)}[layout]
    if layout == "3-D transposed view":  # [3, 40, 48] read as [3, 48, 40]: a 40-wide input
        w = w[:40]
    wt, bt = t(w.T).bfloat16(), t(b).bfloat16()
    got = T.linear(xt, wt, bt)
    bf = jnp.bfloat16
    want = J.linear({"w": jnp.asarray(w).astype(bf), "b": jnp.asarray(b).astype(bf)},
                    jnp.asarray(xt.float().numpy()).astype(bf))
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).bfloat16()
    twice = (torch.nn.functional.linear(xt.float(), wt.float()).bfloat16().float()
             + bt.float()).bfloat16()
    same, same_twice = float((got == want).float().mean()), float((got == twice).float().mean())
    assert same >= 0.99 and same_twice < 0.9, (same, same_twice)


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layer_norm(eps):
    x = (rs.randn(4, 7, 32) * 3 + 1).astype(np.float32)
    g, b = rs.randn(32).astype(np.float32), rs.randn(32).astype(np.float32)
    want = J.layer_norm({"scale": jnp.asarray(g), "bias": jnp.asarray(b)}, jnp.asarray(x), eps)
    np.testing.assert_allclose(T.layer_norm(t(x), t(g), t(b), eps).numpy(), np.asarray(want), **TOL)


def test_batch_norm_infer():
    x = rs.randn(2, 6, 5, 5).astype(np.float32)  # NCHW
    g, b = rs.randn(6).astype(np.float32), rs.randn(6).astype(np.float32)
    mean, var = rs.randn(6).astype(np.float32), rs.uniform(0.5, 1.5, 6).astype(np.float32)
    want = J.batch_norm_infer({"scale": jnp.asarray(g), "bias": jnp.asarray(b)},
                              {"mean": jnp.asarray(mean), "var": jnp.asarray(var)},
                              jnp.asarray(x.transpose(0, 2, 3, 1)), 1e-5)
    got = T.batch_norm_infer(t(x), t(g), t(b), t(mean), t(var), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), **TOL)


@pytest.mark.parametrize("cin,cout,k,stride,pad,groups,bias", [
    (3, 16, 7, 4, 2, 1, True),    # stage-0 patch embedding
    (16, 16, 3, 2, 1, 16, False),  # depthwise k/v projection
    (16, 16, 3, 1, 1, 16, False),  # depthwise q projection
])
def test_conv2d(cin, cout, k, stride, pad, groups, bias):
    x = rs.randn(2, cin, 17, 17).astype(np.float32)
    w = (rs.randn(cout, cin // groups, k, k) * 0.2).astype(np.float32)  # OIHW
    b = rs.randn(cout).astype(np.float32) if bias else None
    want = J.conv2d(jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(x.transpose(0, 2, 3, 1)),
                    stride, pad, groups, None if b is None else jnp.asarray(b))
    got = T.conv2d(t(x), t(w), None if b is None else t(b), stride, pad, groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), **TOL)


def test_gelu():
    x = (rs.randn(1000) * 4).astype(np.float32)
    np.testing.assert_allclose(T.gelu(t(x)).numpy(), np.asarray(J.gelu(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_attention(masked):
    q, k, v = (rs.randn(2, 3, n, 8).astype(np.float32) for n in (5, 9, 9))
    mask = None
    if masked:
        mask = np.where(rs.rand(2, 1, 1, 9) > 0.3, 0.0, np.finfo(np.float32).min).astype(np.float32)
    want = J.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3,
                       None if mask is None else jnp.asarray(mask))
    got = T.attention(t(q), t(k), t(v), 0.3, None if mask is None else t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_split_merge_heads():
    x = rs.randn(2, 5, 12).astype(np.float32)
    want = J.split_heads(jnp.asarray(x), 3)
    got = T.split_heads(t(x), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(T.merge_heads(got).numpy(), np.asarray(J.merge_heads(want)))


def test_cast_floats_casts_bn_statistics():
    from cxrmate_torch.ops.layers import BatchNorm2d
    from cxrmate_torch.utils.precision import cast_floats

    bn = BatchNorm2d(4, 1e-5, device="cpu", dtype=torch.float32)
    cast_floats(bn, torch.bfloat16)
    assert {p.dtype for p in bn.parameters()} == {torch.bfloat16}
    assert {b.dtype for b in bn.buffers() if b.is_floating_point()} == {torch.bfloat16}
    assert bn.num_batches_tracked.dtype == torch.long  # an integer buffer keeps its type
