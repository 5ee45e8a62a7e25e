"""The fused decoder-layer step of the port (``cxrmate_torch.ops.fused_decode``
and the ``use_fused`` path through ``bert_step`` and ``generate``) against the
JAX package, on the CPU, and on a card each of its five CUDA kernels (v2's
four, v1's one) against its plain version.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_fused_decode.py`` does. One interpreted run of the JAX
``fused_layer_step_v2`` per dtype serves two checks: a spy on ``pallas_call``
keeps the operands and results of its four calls, so the whole layer (a) and
each of the port's four plain stages, fed the JAX stage's own operands (b), are
held to it. Every stage is exposed that way: none is held through (a) only.

v1 (``fused_layer_step``, one kernel, no path calls it) is held to one
interpreted run of the JAX ``fused_layer_step`` per dtype at the same shapes,
hidden_out and both whole caches, and in fp32 to the port's v2 plain version.

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
from cxrmate_torch.ops import decode_attention as da
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


# -------------------------------------------- (b2) v1: the one-kernel layer step
@pytest.fixture(scope="module", params=list(DTYPES))
def v1_run(request, jx):
    """One interpreted run of the JAX fused_layer_step (v1) on the tiny layer
    and the same operands as layer_run, and the port's layer in that dtype."""
    dtype, tol = DTYPES[request.param]
    jdtype = jx.jnp.float32 if dtype == torch.float32 else jx.jnp.bfloat16
    x = layer_inputs()
    jlayer = jx.jax.tree_util.tree_map(
        lambda a: jx.jnp.asarray(a, jdtype), jx.h.jax_variables()["params"]["decoder"]["layers"][0])
    floats = {k: jx.jnp.asarray(v, jdtype) for k, v in x.items() if v.dtype == np.float32}
    out = jx.fd.fused_layer_step(
        floats["hidden"], jlayer, floats["cache_k"], floats["cache_v"], floats["cross_k"],
        floats["cross_v"], jx.jnp.asarray(INDEX, jx.jnp.int32), jx.jnp.asarray(x["key_mask"]),
        jx.jnp.asarray(x["cross_mask"]), eps=1e-12, interpret=True)
    layer = copy.deepcopy(jx.h.torch_model().decoder.bert.encoder.layer[0]).to(dtype)
    tx = {k: t(v, dtype) if v.dtype == np.float32 else t(v) for k, v in x.items()}
    return types.SimpleNamespace(dtype=dtype, tol=tol, x=tx, layer=layer, out=out)


def test_v1_matches_jax_kernel(v1_run):
    """hidden_out and both whole caches (column INDEX written, the rest as it
    was), with study 0's query masked (it must not attend to itself)."""
    r, x = v1_run, v1_run.x
    ck, cv = x["cache_k"].clone(), x["cache_v"].clone()
    got, got_k, got_v = fd.fused_layer_step(x["hidden"], r.layer, ck, cv, x["cross_k"],
                                            x["cross_v"], INDEX, x["key_mask"], x["cross_mask"])
    assert got_k is ck and got_v is cv  # written in place
    for g, w in zip((got, ck, cv), r.out):
        close(g, w, r.tol)
    others = [c for c in range(T_LEN) if c != INDEX]
    assert torch.equal(ck[:, :, others], x["cache_k"][:, :, others])
    assert got.dtype == r.dtype and fd.fused_layer_step.launches == 0


def test_v1_plain_matches_v2_plain_in_fp32(jx):
    """In fp32 v1 and v2 round at no point in between: the same function."""
    x = {k: t(v, torch.float32) if v.dtype == np.float32 else t(v)
         for k, v in layer_inputs().items()}
    layer = jx.h.torch_model().decoder.bert.encoder.layer[0]
    caches = [(x["cache_k"].clone(), x["cache_v"].clone()) for _ in range(2)]
    args = (x["cross_k"], x["cross_v"], INDEX, x["key_mask"], x["cross_mask"])
    got, _, _ = fd.fused_layer_step_plain(x["hidden"], layer, *caches[0], *args)
    want = fd.fused_layer_step_v2(x["hidden"], layer, *caches[1], *args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    for a, b in zip(caches[0], caches[1]):
        assert torch.equal(a, b)


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
    # S: the cross kernel's own limit, a cluster's share of the keys in one block
    s_cross = da.max_keys(1, 64, 2)
    meta = dict(dtype=torch.bfloat16, device="meta")
    assert fd.supports(wide, k64, torch.empty(2, 4, s_cross, 64, **meta))
    assert not fd.supports(wide, k64, torch.empty(2, 4, s_cross + 1, 64, **meta))
    assert not fd.supports(wide, k64, torch.empty(2, 4, 10 ** 6, 64, **meta))
    # v1's one kernel: the same gate, its own shared-memory limit
    assert fd.supports(wide, k64, k64, version=1)
    assert not fd.supports(types.SimpleNamespace(attention=lora.attention,
                                                 intermediate=wide.intermediate), k64, k64,
                           version=1)
    assert not fd.supports(wide, torch.zeros(2, 4, 8, 8), torch.zeros(2, 4, 8, 8), version=1)
    # its cross stage keeps the scores in scratch, so S is not bounded by one
    # block; T is, by the self-attention's scores in shared memory
    t_max = (fd._SMEM_LIMIT // 4 - 3 * 64 - 16 * 64) // 4 * 4 - 1

    def cache(n):  # shapes only: the gate reads no data
        return torch.empty(1, 4, n, 64, dtype=torch.bfloat16, device="meta")

    assert fd.supports(wide, k64, cache(10 ** 6), version=1)
    assert fd.supports(wide, cache(t_max), k64, version=1)
    assert not fd.supports(wide, cache(t_max + 1), k64, version=1)
    with pytest.raises(ValueError, match="no LoRA"):
        fd.prepare_fused_params(step_setup["longitudinal"], 4)
    # the FFN kernel's split-K passes keep its shared memory: 8 x (D + max(D, F)) fp32
    for d, f in ((768, 3072), (32, 64), (1024, 1024), (2048, 5184), (2048, 5200), (4096, 2048)):
        assert fd._smem_out_ln_ffn(d, f) == 4 * 8 * (d + max(d, f))
    prep = fd.prepare_fused_params(step_setup["multi"], 4)
    assert len(prep) == 2 and tuple(prep[0]["wqkv"].shape) == (96, 32)
    q = plain.attention.self.query
    assert torch.equal(prep[0]["wqkv"][:32], q.weight) and torch.equal(prep[0]["bqkv"][:32], q.bias)
    assert len(prep[0]["out_ln_q"]) == 6 and len(prep[0]["out_ln_ffn"]) == 10


@pytest.mark.parametrize("d,f,grid,itemsize", [
    pytest.param(d, f, g, None, id=f"{d}-{f}-{g}")
    for d, f, g in [(768, 3072, 132), (768, 3072, 114), (32, 64, 132), (32, 64, 114)]] + [
    pytest.param(d, None, g, e, id=f"qkv-{d}-{g}-{e}")
    for d in (768, 32) for g in (132, 114) for e in (2, 4)] + [
    pytest.param(d, kind, g, e, id=f"{kind}-{d}-{g}-{e}")
    for kind in ("lnq", "v1") for d in (768, 32) for g in (132, 114) for e in (2, 4)] + [
    pytest.param(b, "cross", g, s, id=f"cross-{b}-{s}-{g}")
    for b, s in ((8, 2880), (11, 2880), (8, 1), (8, 65), (1, 3073)) for g in (132, 114)])
def test_ffn_ownership_map_covers_every_unit_once(d, f, grid, itemsize):
    """fused_out_ln_ffn's split-K passes: on a grid of 132 or 114 blocks (the
    H100 SXM's and PCIe's SMs), at the decoder's widths and the tiny
    config's, in fp32 and bf16, every (output, K-slice) of Wo, W1 and W2 is
    owned by exactly one (block, warp), each of a block's warps has a unit
    where the block has 16, W2's units are cut evenly over the blocks, and
    the slices are a function of the input width and dtype alone. The qkv
    cases (``f`` None): fused_qkv_attn's projection over the [3D, D] weight
    likewise, each block's outputs its even share of the 3D. ``lnq``:
    fused_out_ln_q's Wo and Wq passes likewise (each block its even share of
    the D outputs of both); ``v1``: fused_layer_step's six passes (F = 4D).
    ``cross`` (``d`` the batch, ``itemsize`` S): v1's cross stage deals each
    (study, head)'s 64-key tiles to its decode_schedule parts, every tile to
    exactly one (block, warp), a part to one pair of warps of one block, its
    tiles those of block_tiles, to the pair's two warps in turn, a (study,
    head)'s parts on different blocks, and the items spread over the blocks
    evenly (at most one more on a block than on another)."""

    def per_block(owned, n):
        return [[u for u in owned if u[0] == blk] for blk in range(n)]

    if f == "cross":
        b, s = d, itemsize
        n_split, _ = da.decode_schedule(s, 64)
        deal = fd.cross_deal(b, 12, s, grid)
        tiles = -(-s // 64)
        assert sorted((u, t) for _, _, u, _, t in deal) == [
            (u, t) for u in range(b * 12) for t in range(tiles)]
        items, dealt = {}, {}
        for blk, w, u, p, t in deal:
            items.setdefault((u, p), set()).add((blk, w % 8))
            dealt.setdefault((u, p), []).append((t, w // 8))
        assert all(len(pair) == 1 for pair in items.values())  # a pair of warps an item
        items = {k: next(iter(pair)) for k, pair in items.items()}
        assert len(items) == b * 12 * n_split  # more than 8 a block: the pairs take turns
        rounds = -(-len(items) // (8 * grid))
        assert max(list(items.values()).count(slot) for slot in set(items.values())) <= rounds
        parts = da.block_tiles(s, 64)  # the part's tiles, to the pair's warps in turn
        assert all(got == [(t, j % 2) for j, t in enumerate(parts[p])]
                   for (_, p), got in dealt.items())
        for u in range(b * 12):  # a (study, head)'s parts on different blocks
            assert len({items[(u, p)][0] for p in range(n_split)}) == n_split
        load = [sum(1 for blk, _ in items.values() if blk == g) for g in range(grid)]
        assert max(load) - min(load) <= 1 and all(w < 8 for _, w in items.values())
        return
    if f in ("lnq", "v1"):
        units = (fd.lnq_units(d, itemsize, grid) if f == "lnq"
                 else fd.layer_step_units(d, 4 * d, itemsize, grid))
        shapes = {"wqkv": (3 * d, d), "wo": (d, d), "wq": (d, d), "wcq": (d, d), "wco": (d, d),
                  "w1": (4 * d, d), "w2": (d, 4 * d)}
        for name, owned in units.items():
            n_out, n_in = shapes[name]
            ks = fd.pass_slices(n_in, itemsize)
            assert sorted((o, k) for _, _, o, k in owned) == [
                (o, k) for o in range(n_out) for k in range(ks)], name
            for blk, mine in enumerate(per_block(owned, grid)):
                if name != "w2":  # each block its even share of the outputs
                    assert {o for _, _, o, _ in mine} == set(
                        range(n_out * blk // grid, n_out * (blk + 1) // grid)), (name, blk)
                assert len({w for _, w, _, _ in mine}) == min(16, len(mine)), (name, blk)
        return

    if f is None:
        units = fd.qkv_units(d, itemsize, grid)
        ks = fd.pass_slices(d, itemsize)
        assert ks == -(-d * itemsize // 512)
        got = sorted((o, k) for _, _, o, k in units)
        assert got == [(o, k) for o in range(3 * d) for k in range(ks)]
        for blk, mine in enumerate(per_block(units, grid)):
            outs = {o for _, _, o, _ in mine}  # the block's even share of the outputs
            assert outs == set(range(3 * d * blk // grid, 3 * d * (blk + 1) // grid))
            assert len({w for _, w, _, _ in mine}) == min(16, len(mine))
        return
    for itemsize in (2, 4):
        units = fd.ffn_units(d, f, itemsize, grid)
        for name, n_out, n_in in (("wo", d, d), ("w1", f, d), ("w2", d, f)):
            ks = fd.pass_slices(n_in, itemsize)
            assert ks == -(-n_in * itemsize // 512)
            got = sorted((o, k) for _, _, o, k in units[name])
            assert got == [(o, k) for o in range(n_out) for k in range(ks)], name
            for blk in range(grid):  # a block's warps all work where it has 16 units
                mine = [w for b, w, _, _ in units[name] if b == blk]
                assert len(set(mine)) == min(16, len(mine)), (name, blk)
            if name == "w2":  # one even run a block
                assert max(map(len, per_block(units[name], grid))) <= -(-len(got) // grid)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qkv_attn_rows_bit_equal_alone_and_in_batches_on_card(cuda_device, dtype):
    """The split-K projection sums in a fixed order: a row's ctx and its new
    cache column are the same bits alone, in a batch of 8 and in one of 11;
    the B = 11 call leaves every other column as it was."""
    x = card_operands(cuda_device, dtype, b=11)

    def run(lo, hi):
        ck, cv = x.cache_k[lo:hi].clone(), x.cache_v[lo:hi].clone()
        ctx = fd.fused_qkv_attn(x.hidden[lo:hi], x.wqkv, x.bqkv, ck, cv, 128, x.key_mask[lo:hi])
        return ctx, ck, cv

    ctx, ck, cv = run(0, 11)
    want = (ctx, ck[:, :, 128], cv[:, :, 128])
    for lo, hi in [(0, 8)] + [(i, i + 1) for i in range(11)]:
        got, k, v = run(lo, hi)
        for w, g in zip(want, (got, k[:, :, 128], v[:, :, 128])):
            assert torch.equal(w[lo:hi], g)
    others = [c for c in range(x.cache_k.shape[2]) if c != 128]
    assert torch.equal(ck[:, :, others], x.cache_k[:, :, others])
    assert torch.equal(cv[:, :, others], x.cache_v[:, :, others])


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
    """Within tol of the plain versions; the FFN kernel's rows and
    fused_out_ln_q's are bit-equal alone, in a batch of 8 and in a batch of
    11 (split-K in a fixed order)."""
    x = card_operands(cuda_device, dtype, b=b)
    with parity_mode():
        got = fd.fused_out_ln_q(x.hidden, x.res, *x.out_ln_q, 1e-12)
        want = fd.fused_out_ln_q_plain(x.hidden, x.res, *x.out_ln_q, 1e-12)
        got_ffn = fd.fused_out_ln_ffn(x.hidden, x.res, *x.out_ln_ffn, 1e-12)
        want_ffn = fd.fused_out_ln_ffn_plain(x.hidden, x.res, *x.out_ln_ffn, 1e-12)
    first8 = fd.fused_out_ln_ffn(x.hidden[:8], x.res[:8], *x.out_ln_ffn, 1e-12)
    alone = torch.cat([fd.fused_out_ln_ffn(x.hidden[i:i + 1], x.res[i:i + 1], *x.out_ln_ffn,
                                           1e-12) for i in range(b)])
    q8 = fd.fused_out_ln_q(x.hidden[:8], x.res[:8], *x.out_ln_q, 1e-12)
    q1 = [fd.fused_out_ln_q(x.hidden[i:i + 1], x.res[i:i + 1], *x.out_ln_q, 1e-12)
          for i in range(b)]
    torch.cuda.synchronize()
    for a, w in ((got[0], want[0]), (got[1], want[1]), (got_ffn, want_ffn)):
        torch.testing.assert_close(a.float(), w.float(), rtol=tol, atol=tol)
    assert torch.equal(first8, got_ffn[:8]) and torch.equal(alone, got_ffn)
    for i in range(2):  # fused_out_ln_q's h1 and cq likewise
        assert torch.equal(q8[i], got[i][:8])
        assert torch.equal(torch.cat([r[i] for r in q1]), got[i])


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
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 2880, 3073, "largest"])
def test_cross_attn_masked_rows_unread_on_card(cuda_device, dtype, tol, s):
    """The cross kernel on the cluster split reads no K or V row of a masked
    key while its study has an open one: NaN there leaves the output's bits
    unchanged; within tol of the plain version; a fully masked study (row 1)
    finite. A quarter of the keys masked, and for S >= 128 a whole tile."""
    if s == "largest":
        s = da.max_keys(1, 64, torch.finfo(dtype).bits // 8)
    b = 1 if s > 3073 else 4
    g = torch.Generator(device=cuda_device).manual_seed(s)
    cq = torch.randn(b, 768, generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn(b, 12, s, 64, generator=g, device=cuda_device).to(dtype) for _ in range(2))
    mask = (torch.rand(b, s, generator=g, device=cuda_device) >= 0.25).int()
    if s >= 128:
        mask[:, 64:128] = 0
    if b > 1:
        mask[1] = 0
    poison = (mask == 0)[:, None, :, None] & (mask != 0).any(1)[:, None, None, None]
    with parity_mode():
        got = fd.fused_cross_attn(cq, k, v, mask)
        dirty = fd.fused_cross_attn(cq, k.masked_fill(poison, float("nan")),
                                    v.masked_fill(poison, float("nan")), mask)
        want = fd.fused_cross_attn_plain(cq, k, v, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all() and torch.equal(got, dirty)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="exceeds"):
        over = da.max_keys(1, 64, torch.finfo(dtype).bits // 8) + 1
        fd.fused_cross_attn(cq[:1], *(torch.empty(1, 12, over, 64, dtype=dtype,
                                                  device=cuda_device) for _ in range(2)),
                            torch.ones(1, over, dtype=torch.int32, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("index", [1, 255])
def test_layer_step_kernel_matches_plain_on_card(cuda_device, dtype, tol, index):
    """v1 at full width: hidden_out within tol, the written column within tol
    of the plain version's, every other column bit-exact; a study with no
    open self key and one with no open cross key stay finite."""
    x = card_operands(cuda_device, dtype)
    x.key_mask[0] = 0
    x.cross_mask[2] = 0
    prep = {"wqkv": x.wqkv, "bqkv": x.bqkv, "out_ln_q": x.out_ln_q, "out_ln_ffn": x.out_ln_ffn}
    caches = [(x.cache_k.clone(), x.cache_v.clone()) for _ in range(2)]
    args = (x.cross_k, x.cross_v, index, x.key_mask, x.cross_mask)
    with parity_mode():
        got, _, _ = fd.fused_layer_step(x.hidden, None, *caches[0], *args, prepared=prep)
        want, _, _ = fd.fused_layer_step_plain(x.hidden, None, *caches[1], *args, prepared=prep)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    others = [c for c in range(x.cache_k.shape[2]) if c != index]
    for a, b, old in zip(caches[0], caches[1], (x.cache_k, x.cache_v)):
        torch.testing.assert_close(a[:, :, index].float(), b[:, :, index].float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(a[:, :, others], old[:, :, others])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_step_rows_bit_equal_and_masked_cross_rows_unread_on_card(cuda_device, dtype):
    """v1's split-K passes and cross parts add in a fixed order: a row's
    output is the same bits alone, in a batch of 8 and in one of 11; NaN in
    the K and V rows of masked cross keys (of the studies with an open one)
    leaves every output bit as it was."""
    x = card_operands(cuda_device, dtype, b=11)
    x.cross_mask[3, :64] = 0  # a whole tile of an open slot masked
    prep = {"wqkv": x.wqkv, "bqkv": x.bqkv, "out_ln_q": x.out_ln_q, "out_ln_ffn": x.out_ln_ffn}

    def run(lo, hi, ck=x.cross_k, cv=x.cross_v):
        k, v = x.cache_k[lo:hi].clone(), x.cache_v[lo:hi].clone()
        return fd.fused_layer_step(x.hidden[lo:hi], None, k, v, ck[lo:hi], cv[lo:hi], 128,
                                   x.key_mask[lo:hi], x.cross_mask[lo:hi], prepared=prep)[0]

    want = run(0, 11)
    assert torch.equal(run(0, 8), want[:8])
    assert torch.equal(torch.cat([run(i, i + 1) for i in range(11)]), want)
    poison = (x.cross_mask == 0)[:, None, :, None]
    dirty = run(0, 11, x.cross_k.masked_fill(poison, float("nan")),
                x.cross_v.masked_fill(poison, float("nan")))
    torch.cuda.synchronize()
    assert torch.equal(dirty, want)


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
