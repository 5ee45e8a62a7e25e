"""CvT encoder of the port against the JAX package, fp32 on the CPU: each
stage's trunk output, the cls token, ``cvt_encode`` and ``encode_images``
(hidden states and the zero-image mask)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cxrmate_tpu.models import cvt as jcvt
from cxrmate_tpu.models import encoder_decoder as jed
from cxrmate_torch.models import cvt as tcvt
from cxrmate_torch.models import encoder_decoder as ted
from tests.test_torch_harness import TOL, jax_config, jax_variables, pixels, t, torch_model

_TUPLES = [f.name for f in dataclasses.fields(jax_config().encoder)
           if isinstance(getattr(jax_config().encoder, f.name), tuple)]


@pytest.fixture(scope="module")
def models():
    return jax_variables(), torch_model()


@pytest.fixture(scope="module")
def images():
    return pixels(3, studies=2, slots=2).reshape(4, 3, 64, 64)


@pytest.mark.parametrize("stages", [1, 2])
def test_stage_outputs(models, images, stages):
    """The trunk cut after ``stages`` stages (the JAX side runs a config with
    the first ``stages`` stages) equals the port's per-stage output."""
    variables, model = models
    enc_cfg = jax_config().encoder
    cut = dataclasses.replace(enc_cfg, **{n: getattr(enc_cfg, n)[:stages] for n in _TUPLES})
    params = dict(variables["params"]["encoder"],
                  stages=variables["params"]["encoder"]["stages"][:stages])
    stats = {"stages": variables["batch_stats"]["stages"][:stages]}
    want, _, _ = jax.jit(lambda p, s, x: jcvt.cvt_forward(p, s, x, cut))(params, stats, images)
    x = t(images)
    for s in range(stages):
        got, _, x = tcvt.cvt_stage(model.encoder, s, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_trunk_and_cls_token(models, images):
    variables, model = models
    enc = variables["params"]["encoder"]
    want, want_cls, _ = jax.jit(
        lambda p, s, x: jcvt.cvt_forward(p, s, x, jax_config().encoder)
    )(enc, variables["batch_stats"], images)
    got, got_cls = tcvt.cvt_forward(model.encoder, t(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), **TOL)


def test_encode_images_hidden_and_mask(models):
    variables, model = models
    px = pixels(4, studies=2, slots=2)
    want_h, want_m, _ = jax.jit(
        lambda v, x: jed.encode_images(v, x, jax_config()))(variables, jnp.asarray(px))
    got_h, got_m = ted.encode_images(model, t(px))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert got_m.dtype.is_floating_point is False and got_m[-1].sum() < got_m[0].sum()
    # cvt_encode: study 0's images, projected, are study 0's encoder states
    per_image = tcvt.cvt_encode(model.encoder, t(px[0]))
    np.testing.assert_allclose(per_image.reshape(-1, 32).numpy(), np.asarray(want_h[0]), **TOL)
