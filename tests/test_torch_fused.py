"""The fused decoder-layer step of the port (``cxrmate_torch.ops.fused_decode``
and the ``use_fused`` path through ``bert_step`` and ``generate``) against the
JAX package, on the CPU, and on a card each of its four CUDA kernels against
its plain version.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_fused_decode.py`` does. One interpreted run of the JAX
``fused_layer_step_v2`` per dtype serves two checks: a spy on ``pallas_call``
keeps the operands and results of its four calls, so the whole layer (a) and
each of the port's four plain stages, fed the JAX stage's own operands (b), are
held to it. Every stage is exposed that way: none is held through (a) only.

Tolerances: fp32 rtol = atol = 1e-5 (another summation order, ``torch.erf``
against the Pallas body's rational erf, which is within 1.5e-7); bf16 5e-2,
the JAX test's own bound (the rounding points match, the fp32 sums inside do
not); greedy token ids identical.

The file imports neither JAX nor the shared harness at module level, so the
CUDA tests run on the card's machine as they are:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused.py -m cuda
"""

import copy
import importlib
import types
import warnings

import numpy as np
import pytest
import torch

from cxrmate_torch.models import bert as tb
from cxrmate_torch.ops import fused_decode as fd
from cxrmate_torch.utils.precision import parity_mode

torch.set_num_threads(2)  # as in the harness: six xdist workers on eight cores
B, T_LEN, S, INDEX = 4, 10, 7, 5  # the shapes of tests/test_fused_decode.py:46-57
STAGES = ("fused_qkv_attn", "fused_out_ln_q", "fused_cross_attn", "fused_out_ln_ffn")
DTYPES = {"f32": (torch.float32, 1e-5), "bf16": (torch.bfloat16, 5e-2)}


def t(x, dtype=None) -> torch.Tensor:
    out = torch.from_numpy(np.array(x, dtype=np.float32 if dtype is not None else None))
    return out if dtype is None else out.to(dtype)


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def jx():
    """JAX, the JAX package's fused step and the shared harness."""
    jax = pytest.importorskip("jax")
    from cxrmate_tpu.ops import fused_decode as jfd

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, fd=jfd, pl=jfd.pl,
                                 h=importlib.import_module("tests.test_torch_harness"))


def layer_inputs(seed=0):
    """One step's operands for one layer of the harness's tiny decoder (hidden
    32, 4 heads of 8): a masked query row (row 0 must not attend to itself) and
    a random cross mask."""
    rs = np.random.RandomState(seed)
    x = {"hidden": rs.randn(B, 32), "cache_k": rs.randn(B, 4, T_LEN, 8),
         "cache_v": rs.randn(B, 4, T_LEN, 8), "cross_k": rs.randn(B, 4, S, 8),
         "cross_v": rs.randn(B, 4, S, 8)}
    key_mask = (rs.rand(B, T_LEN) > 0.3).astype(np.int32)
    key_mask[:, INDEX] = 1
    key_mask[0, INDEX] = 0
    x["key_mask"] = key_mask * (np.arange(T_LEN) <= INDEX)
    x["cross_mask"] = (rs.rand(B, S) > 0.2).astype(np.int32)
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in x.items()}


@pytest.fixture(scope="module", params=list(DTYPES))
def layer_run(request, jx):
    """One interpreted run of the JAX fused_layer_step_v2 on the tiny layer,
    with the operands and results of its four pallas_calls kept."""
    dtype, tol = DTYPES[request.param]
    jdtype = jx.jnp.float32 if dtype == torch.float32 else jx.jnp.bfloat16
    x = layer_inputs()
    jlayer = jx.jax.tree_util.tree_map(
        lambda a: jx.jnp.asarray(a, jdtype), jx.h.jax_variables()["params"]["decoder"]["layers"][0])
    calls, real = [], jx.pl.pallas_call

    def spy(kernel, *a, **kw):
        inner = real(kernel, *a, **kw)

        def run(*args):
            out = inner(*args)
            calls.append((kernel.func.__name__, args, out))
            return out

        return run

    floats = {k: jx.jnp.asarray(v, jdtype) for k, v in x.items() if v.dtype == np.float32}
    jx.pl.pallas_call = spy
    try:
        out = jx.fd.fused_layer_step_v2(
            floats["hidden"], jlayer, floats["cache_k"], floats["cache_v"], floats["cross_k"],
            floats["cross_v"], jx.jnp.asarray(INDEX, jx.jnp.int32), jx.jnp.asarray(x["key_mask"]),
            jx.jnp.asarray(x["cross_mask"]), eps=1e-12, interpret=True)
    finally:
        jx.pl.pallas_call = real
    assert [c[0] for c in calls] == ["_qkv_attn_kernel_v2", "_out_ln_q_kernel",
                                     "_cross_attn_kernel_v2", "_out_ln_ffn_kernel"]
    layer = copy.deepcopy(jx.h.torch_model().decoder.bert.encoder.layer[0]).to(dtype)
    tx = {k: t(v, dtype) if v.dtype == np.float32 else t(v) for k, v in x.items()}
    return types.SimpleNamespace(dtype=dtype, tol=tol, x=tx, layer=layer, out=out, calls=calls)


def heads_to_rows(a):
    """[H, B, dh] (the Pallas bodies' per-head outputs) -> [B, H * dh]."""
    a = np.asarray(a, np.float32)
    return a.transpose(1, 0, 2).reshape(a.shape[1], -1)


# ------------------------------------------------- (a) the layer, against JAX
def test_layer_matches_jax_kernels(layer_run):
    r, x = layer_run, layer_run.x
    want_h, want_k, want_v = r.out
    ck, cv = x["cache_k"].clone(), x["cache_v"].clone()
    got = fd.fused_layer_step_v2(x["hidden"], r.layer, ck, cv, x["cross_k"], x["cross_v"], INDEX,
                                 x["key_mask"], x["cross_mask"], eps=1e-12)
    close(got, want_h, r.tol)
    close(ck, want_k, r.tol)  # the whole cache: column INDEX written, the rest as it was
    close(cv, want_v, r.tol)
    others = [c for c in range(T_LEN) if c != INDEX]
    assert torch.equal(ck[:, :, others], x["cache_k"][:, :, others])
    assert torch.equal(cv[:, :, others], x["cache_v"][:, :, others])
    assert got.dtype == r.dtype and not any(getattr(fd, s).launches for s in STAGES)


# ------------------------- (b) each plain stage on the JAX stage's own operands
@pytest.mark.parametrize("stage", STAGES)
def test_stage_matches_jax_pallas_call(layer_run, stage):
    r, x = layer_run, layer_run.x
    p = fd.prepare_fused_params(types.SimpleNamespace(bert=types.SimpleNamespace(
        encoder=types.SimpleNamespace(layer=[r.layer]))), 4)[0]
    _, args, out = r.calls[STAGES.index(stage)]
    if stage == "fused_qkv_attn":
        ck, cv = x["cache_k"].clone(), x["cache_v"].clone()
        got = fd.fused_qkv_attn(x["hidden"], p["wqkv"], p["bqkv"], ck, cv, INDEX, x["key_mask"])
        close(got, heads_to_rows(out[0]), r.tol)
        close(ck[:, :, INDEX].reshape(B, -1), heads_to_rows(out[1]), r.tol)
        close(cv[:, :, INDEX].reshape(B, -1), heads_to_rows(out[2]), r.tol)
    elif stage == "fused_out_ln_q":
        h1, cq = fd.fused_out_ln_q(t(args[0], r.dtype), t(args[1], r.dtype), *p["out_ln_q"], 1e-12)
        close(h1, out[0], r.tol)
        close(cq, out[1], r.tol)
    elif stage == "fused_cross_attn":
        got = fd.fused_cross_attn(t(heads_to_rows(args[0]), r.dtype), x["cross_k"], x["cross_v"],
                                  x["cross_mask"])
        close(got, heads_to_rows(out), r.tol)
    else:
        got = fd.fused_out_ln_ffn(t(args[0], r.dtype), t(args[1], r.dtype), *p["out_ln_ffn"],
                                  1e-12)
        close(got, out, r.tol)


def test_fully_masked_row_is_uniform_and_finite():
    """A row with no open key at all (and a masked new token) is the uniform
    softmax over all T + 1 columns, whatever the unwritten columns hold."""
    rs = np.random.RandomState(3)
    hidden, wqkv, bqkv = t(rs.randn(2, 16), torch.float32), t(rs.randn(48, 16) * 0.2,
                                                            torch.float32), torch.zeros(48)
    ck, cv = t(rs.randn(2, 2, 6, 8), torch.float32), t(rs.randn(2, 2, 6, 8), torch.float32)
    mask = torch.tensor([[0, 0, 0, 0, 0, 0], [1, 1, 1, 0, 0, 0]], dtype=torch.int32)
    v_old = cv.clone()
    got = fd.fused_qkv_attn(hidden, wqkv, bqkv, ck, cv, 2, mask)
    v_new = (hidden @ wqkv.t())[:, 32:]
    want = (v_old[0].sum(1).reshape(-1) + v_new[0]) / 7.0
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    cross = fd.fused_cross_attn(hidden, ck, cv, torch.zeros(2, 6, dtype=torch.int32))
    np.testing.assert_allclose(cross.numpy(), cv.mean(2).reshape(2, -1).numpy(), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------ (c) the slice
def test_generate_fused_ids_identical(jx):
    """The tiny multi model of tests/test_fused_decode.py (2 decoder layers, 12
    new tokens), weights carried across by state_dict_from_jax, from pixels to
    ids: the port's fused path gives the ids of JAX's fused path and of the
    port's own unfused path."""
    from cxrmate_tpu import configs as jcfg
    from cxrmate_tpu.generate import GenerationConfig as JGen
    from cxrmate_tpu.generate import generate as jax_generate
    from cxrmate_tpu.models import bert as jb
    from cxrmate_tpu.models import encoder_decoder as jed
    from cxrmate_tpu.models.cvt import init_cvt_variables
    from cxrmate_torch import configs as tcfg
    from cxrmate_torch.ckpt.hf import load_model_state, state_dict_from_jax
    from cxrmate_torch.generate.decode import GenerationConfig, generate
    from cxrmate_torch.models import encoder_decoder as ted

    enc = dict(embed_dim=(8, 12, 16), num_heads=(1, 2, 2), depth=(1, 1, 3),
               drop_path_rate=(0.0, 0.0, 0.0), projection_size=16)
    dec = dict(vocab_size=64, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=32, max_position_embeddings=64, cross_attention_hidden_size=16)
    cfg = jcfg.EncoderDecoderConfig(encoder=jcfg.CvtConfig(**enc),
                                    decoder=jcfg.BertDecoderConfig(**dec),
                                    variant="multi", image_size=32)
    cvt = init_cvt_variables(jx.jax.random.PRNGKey(0), cfg.encoder)
    variables = {"params": {"encoder": cvt["params"],
                            "decoder": jb.init_bert_params(jx.jax.random.PRNGKey(1), cfg.decoder)},
                 "batch_stats": cvt["batch_stats"]}
    model = ted.EncoderDecoder(tcfg.EncoderDecoderConfig(
        encoder=tcfg.CvtConfig(**enc), decoder=tcfg.BertDecoderConfig(**dec), variant="multi",
        image_size=32), device="cpu", dtype=torch.float32)
    load_model_state(model, state_dict_from_jax(variables, cfg.encoder, cfg.decoder))
    pixels = np.random.RandomState(0).randn(2, 2, 3, 32, 32).astype(np.float32)
    pixels[1, 1] = 0.0  # a padding image slot: masked cross keys
    kw = dict(max_new_tokens=12, bos_token_id=1, eos_token_id=2, pad_token_id=4,
              special_token_ids=(3,))
    prompt = np.full((2, 1), 1, np.int32)

    enc_hidden, enc_mask, _ = jed.encode_images(variables, jx.jnp.asarray(pixels), cfg)
    jx.fd.INTERPRET = True
    try:
        want = np.asarray(jax_generate(variables, cfg, JGen(**kw), enc_hidden, enc_mask,
                                       jx.jnp.asarray(prompt), jx.jnp.ones_like(prompt),
                                       use_fused=True))
    finally:
        jx.fd.INTERPRET = False
    with torch.no_grad():
        hidden, mask = ted.encode_images(model, t(pixels))
    args = (model, GenerationConfig(**kw), hidden, mask, t(prompt), torch.ones(2, 1))
    fused = generate(*args, use_fused=True).numpy()
    assert fused.shape == (2, 13)
    np.testing.assert_array_equal(fused, want)
    np.testing.assert_array_equal(fused, generate(*args).numpy())


# ------------------------------------------------- (d) bert_step's fused gate
@pytest.fixture(scope="module")
def step_setup(jx):
    rs = np.random.RandomState(17)
    b, s, p_len, t_len = 3, 12, 2, 6
    enc_mask = np.ones((b, s), np.int32)
    enc_mask[1, s // 2:] = 0
    out = {"b": b, "t_len": t_len, "p_len": p_len, "enc_mask": t(enc_mask),
           "enc": t(rs.randn(b, s, 32).astype(np.float32)),
           "ids": t(rs.randint(5, jx.h.VOCAB, (b, t_len)).astype(np.int32))}
    for variant in ("multi", "longitudinal"):
        out[variant] = jx.h.torch_model(variant=variant).decoder
    return out


def _prefilled(model, s):
    cache = tb.init_cache(model.config, s["b"], s["t_len"], s["enc"].shape[1])
    p = s["p_len"]
    pos = torch.arange(p).expand(s["b"], p)
    return tb.bert_prefill(model, cache, s["ids"][:, :p], torch.ones(s["b"], p, dtype=torch.int32),
                           torch.zeros(s["b"], p, dtype=torch.int32), pos, s["enc"],
                           s["enc_mask"])[1]


def _steps(model, s, **kw):
    cache, logits = _prefilled(model, s), []
    for idx in range(s["p_len"], s["t_len"]):
        key_mask = (torch.arange(s["t_len"]) <= idx).int().expand(s["b"], -1).contiguous()
        out, _ = tb.bert_step(model, cache, s["ids"][:, idx], torch.zeros(s["b"], dtype=torch.int32),
                              torch.full((s["b"],), idx), idx, key_mask, s["enc_mask"], **kw)
        logits.append(out)
    return torch.stack(logits, 1), cache


@pytest.mark.parametrize("prepared", [False, True], ids=["built-per-step", "prepared-once"])
def test_step_fused_logits_match_unfused(step_setup, prepared):
    model = step_setup["multi"]
    want, want_cache = _steps(model, step_setup, decode_kernel="")
    prep = fd.prepare_fused_params(model, model.config.num_attention_heads) if prepared else None
    got, got_cache = _steps(model, step_setup, use_fused=True, fused_prepared=prep,
                            decode_kernel="")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    for a, b in zip(got_cache.self_k + got_cache.self_v, want_cache.self_k + want_cache.self_v):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["lora", "deferred_write"])
def test_step_falls_through_to_unfused(step_setup, monkeypatch, case):
    """LoRA and a deferred write take the unfused path without a word, as in
    the JAX package (models/bert.py:465)."""
    def boom(*a, **kw):
        raise AssertionError("the fused step ran")

    monkeypatch.setattr(fd, "fused_layer_step_v2", boom)
    model = step_setup["longitudinal" if case == "lora" else "multi"]
    kw = {"deferred_write": True} if case == "deferred_write" else {}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        want, _ = _steps(model, step_setup, decode_kernel="", **kw)
        got, _ = _steps(model, step_setup, use_fused=True, decode_kernel="", **kw)
    assert torch.equal(got, want)
    with pytest.raises(AssertionError, match="the fused step ran"):
        _steps(step_setup["multi"], step_setup, use_fused=True, decode_kernel="")


def test_step_warns_when_a_decode_kernel_is_set_too(step_setup):
    model = step_setup["multi"]
    want, _ = _steps(model, step_setup, use_fused=True, decode_kernel="")
    with pytest.warns(RuntimeWarning, match="ignored on the fused decode path"):
        got, _ = _steps(model, step_setup, use_fused=True, decode_kernel="cross-rowgroup-q8")
    assert torch.equal(got, want)  # the spec changed nothing, and no cross_q8 was asked for


def test_supports_and_prepare(step_setup):
    plain = step_setup["multi"].bert.encoder.layer[0]
    lora = step_setup["longitudinal"].bert.encoder.layer[0]
    k64 = torch.zeros(2, 4, 8, 64, dtype=torch.bfloat16)
    wide = types.SimpleNamespace(
        attention=plain.attention,
        intermediate=types.SimpleNamespace(dense=types.SimpleNamespace(weight=torch.empty(1024, 256))))
    assert fd.supports(wide, k64, k64)
    assert not fd.supports(types.SimpleNamespace(attention=lora.attention,
                                                 intermediate=wide.intermediate), k64, k64)
    assert not fd.supports(wide, k64.half(), k64.half())                      # dtype
    assert not fd.supports(wide, torch.zeros(2, 4, 8, 8), torch.zeros(2, 4, 8, 8))  # head dim
    assert not fd.supports(wide, k64, torch.zeros(2, 4, 60000, 64, dtype=torch.bfloat16))  # S
    with pytest.raises(ValueError, match="no LoRA"):
        fd.prepare_fused_params(step_setup["longitudinal"], 4)
    prep = fd.prepare_fused_params(step_setup["multi"], 4)
    assert len(prep) == 2 and tuple(prep[0]["wqkv"].shape) == (96, 32)
    q = plain.attention.self.query
    assert torch.equal(prep[0]["wqkv"][:32], q.weight) and torch.equal(prep[0]["bqkv"][:32], q.bias)
    assert len(prep[0]["out_ln_q"]) == 6 and len(prep[0]["out_ln_ffn"]) == 10


# ---------------------------------------------- (e) card: kernel vs plain version
@pytest.fixture
def cuda_device():
    """The card, for the tests of the CUDA kernels; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def card_operands(dev, dtype, b=8, d=768, f=3072, h=12, t_len=256, s=2880, seed=5):
    """Main-path shapes. LayerNorm gains near 0.3 keep the outputs inside
    (-2, 2), where one bf16 ulp is below the 1e-2 tolerance."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    def gain():
        return (0.3 + 0.05 * torch.randn(d, generator=g, device=dev)).to(dtype)

    key_mask = torch.ones(b, t_len, dtype=torch.int32, device=dev)
    key_mask[1, 3:9] = 0
    cross_mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    for i in range(b):
        cross_mask[i, (1 + i % 5) * 576:] = 0
    return types.SimpleNamespace(
        hidden=rn(b, d), res=rn(b, d), wqkv=rn(3 * d, d, scale=0.02), bqkv=rn(3 * d, scale=0.02),
        cache_k=rn(b, h, t_len, 64, scale=0.5), cache_v=rn(b, h, t_len, 64, scale=0.5),
        cross_k=rn(b, h, s, 64), cross_v=rn(b, h, s, 64), key_mask=key_mask,
        cross_mask=cross_mask,
        out_ln_q=(rn(d, d, scale=0.02), rn(d, scale=0.02), gain(), rn(d, scale=0.02),
                  rn(d, d, scale=0.02), rn(d, scale=0.02)),
        out_ln_ffn=(rn(d, d, scale=0.02), rn(d, scale=0.02), gain(), rn(d, scale=0.02),
                    rn(f, d, scale=0.02), rn(f, scale=0.02), rn(d, f, scale=0.02),
                    rn(d, scale=0.02), gain(), rn(d, scale=0.02)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("index", [1, 128, 255])
def test_qkv_attn_kernel_matches_plain_on_card(cuda_device, dtype, tol, index):
    x = card_operands(cuda_device, dtype)
    x.key_mask[0] = 0  # a fully masked row: uniform over all T + 1 columns
    caches = [(x.cache_k.clone(), x.cache_v.clone()) for _ in range(2)]
    with parity_mode():
        got = fd.fused_qkv_attn(x.hidden, x.wqkv, x.bqkv, *caches[0], index, x.key_mask)
        want = fd.fused_qkv_attn_plain(x.hidden, x.wqkv, x.bqkv, *caches[1], index, x.key_mask)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    others = [c for c in range(x.cache_k.shape[2]) if c != index]
    for (a, b), old in zip(zip(*caches), (x.cache_k, x.cache_v)):
        torch.testing.assert_close(a[:, :, index].float(), b[:, :, index].float(), rtol=tol, atol=tol)
        assert torch.equal(a[:, :, others], old[:, :, others])  # nothing else touched


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b", [8, 11])  # 11: a second, ragged chunk of rows
def test_dense_kernels_match_plain_on_card(cuda_device, dtype, tol, b):
    x = card_operands(cuda_device, dtype, b=b)
    with parity_mode():
        got = fd.fused_out_ln_q(x.hidden, x.res, *x.out_ln_q, 1e-12)
        want = fd.fused_out_ln_q_plain(x.hidden, x.res, *x.out_ln_q, 1e-12)
        got_ffn = fd.fused_out_ln_ffn(x.hidden, x.res, *x.out_ln_ffn, 1e-12)
        want_ffn = fd.fused_out_ln_ffn_plain(x.hidden, x.res, *x.out_ln_ffn, 1e-12)
    torch.cuda.synchronize()
    for a, w in ((got[0], want[0]), (got[1], want[1]), (got_ffn, want_ffn)):
        torch.testing.assert_close(a.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_cross_attn_kernel_matches_plain_on_card(cuda_device, dtype, tol):
    x = card_operands(cuda_device, dtype)
    x.cross_mask[2] = 0  # a fully masked study
    with parity_mode():
        got = fd.fused_cross_attn(x.hidden, x.cross_k, x.cross_v, x.cross_mask)
        want = fd.fused_cross_attn_plain(x.hidden, x.cross_k, x.cross_v, x.cross_mask)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_fused_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    """On CUDA tensors a wrapper launches its kernel or raises."""
    x = card_operands(cuda_device, torch.float32, b=2, t_len=16, s=32)
    with pytest.raises(ValueError, match="index"):
        fd.fused_qkv_attn(x.hidden, x.wqkv, x.bqkv, x.cache_k, x.cache_v, 16, x.key_mask)
    with pytest.raises(ValueError, match="fused_qkv_attn: needs contiguous"):
        fd.fused_qkv_attn(x.hidden, x.wqkv, x.bqkv, x.cache_k, x.cache_v, 3, x.key_mask.long())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fd.fused_out_ln_q(x.hidden.half(), x.res.half(), *(p.half() for p in x.out_ln_q), 1e-12)
    with pytest.raises(ValueError, match="fused_cross_attn: needs contiguous"):
        fd.fused_cross_attn(x.hidden, x.cross_k, x.cross_v.transpose(1, 2), x.cross_mask)
    with pytest.raises(ValueError, match="fused_out_ln_ffn: needs contiguous"):
        ffn = list(x.out_ln_ffn)
        ffn[4] = ffn[4].t().contiguous().t()  # w1 not contiguous
        fd.fused_out_ln_ffn(x.hidden, x.res, *ffn, 1e-12)
