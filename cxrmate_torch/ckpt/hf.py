"""HF checkpoint directories: load a state dict, and carry JAX parameters across.

``load_hf_pretrained_dir`` reads ``pytorch_model.bin`` (or ``model.safetensors``
when the ``safetensors`` package imports), unwrapping a wrapped state dict;
``load_torch_checkpoint`` reads a checkpoint file (a Lightning ``.ckpt``).
``state_dict_from_jax`` is the
port's own numpy-only copy of ``cxrmate_tpu/ckpt/hf_convert.py:178
export_encoder_decoder``: the JAX package's parameter pytree -> the torch-layout
state dict that the released checkpoints use. ``load_model_state`` maps such a
state dict onto the port's HF-named modules. ``shard_state_dict`` cuts such a
state dict (or the model's own) to one rank's shard under tensor parallelism
(``parallel.mesh.shard_dim``), and ``gather_state_dict`` puts the shards back
together.

A LoRA decoder is PEFT-wrapped in the released longitudinal checkpoints: every
decoder key carries ``base_model.model.`` after ``decoder.``, and the wrapped
q/k linears hold ``base_layer`` and ``lora_A/lora_B.default`` leaves. The
port's modules keep the leaves' names (``ops.layers.LoraLinear``) and not the
prefix: ``load_model_state`` strips it and ``model_state_dict`` puts it back.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

WEIGHTS_BIN = "pytorch_model.bin"
WEIGHTS_SAFETENSORS = "model.safetensors"


def _unwrap(blob):
    for key in ("state_dict", "model_state_dict"):
        if isinstance(blob, dict) and key in blob:
            return blob[key]
    return blob


def load_torch_checkpoint(path: str) -> Dict:
    """The state dict of a torch checkpoint file (``.ckpt``, ``.pth``,
    ``.bin``), on the CPU, unwrapped from ``state_dict`` (Lightning) or
    ``model_state_dict`` (CheXbert): the file form of
    ``cxrmate_tpu/ckpt/orbax_io.py:315 load_torch_checkpoint``.

    It loads with ``weights_only=False``, as the JAX package does: the file
    is one the user's config names (a warm start's Lightning ``.ckpt``), and
    Lightning pickles more than tensors (hyper-parameters, loop state), which
    the safe loader refuses. Unpickling runs code, so pass only files you
    trust."""
    return _unwrap(torch.load(path, map_location="cpu", weights_only=False))


def load_hf_pretrained_dir(path: str) -> Dict[str, torch.Tensor]:
    """State dict of an HF checkpoint directory, on the CPU. A
    ``pytorch_model.bin`` that keeps its state dict under ``state_dict``
    (Lightning) or ``model_state_dict`` (CheXbert) is unwrapped, as
    ``cxrmate_tpu/ckpt/orbax_io.py:315 load_torch_checkpoint`` does."""
    bin_path = os.path.join(path, WEIGHTS_BIN)
    if os.path.exists(bin_path):
        return _unwrap(torch.load(bin_path, map_location="cpu", weights_only=True))
    st_path = os.path.join(path, WEIGHTS_SAFETENSORS)
    if os.path.exists(st_path):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise RuntimeError(
                f"{st_path} needs the `safetensors` package, which is not installed") from e
        return load_file(st_path)
    raise FileNotFoundError(f"no {WEIGHTS_BIN} or {WEIGHTS_SAFETENSORS} under {path}")


def save_hf_pretrained_dir(path: str, state_dict: Dict[str, torch.Tensor], config,
                           tokenizer=None) -> None:
    """Write ``pytorch_model.bin`` and a ``config.json`` with the nested
    encoder/decoder fields that ``models.api.config_from_hf_dir`` reads, and
    with a ``tokenizer`` its ``tokenizer.json`` (``ByteLevelBPETokenizer.save``):
    a directory that ``CXRMate.from_hf_checkpoint`` loads."""
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu().contiguous() for k, v in state_dict.items()},
               os.path.join(path, WEIGHTS_BIN))
    enc, dec = config.encoder, config.decoder
    hf = {
        "model_type": "vision-encoder-decoder",
        "encoder": {
            "num_channels": enc.num_channels,
            "patch_sizes": list(enc.patch_sizes), "patch_stride": list(enc.patch_stride),
            "patch_padding": list(enc.patch_padding), "embed_dim": list(enc.embed_dim),
            "num_heads": list(enc.num_heads), "depth": list(enc.depth),
            "mlp_ratio": list(enc.mlp_ratio), "qkv_bias": list(enc.qkv_bias),
            "cls_token": list(enc.cls_token), "kernel_qkv": list(enc.kernel_qkv),
            "padding_kv": list(enc.padding_kv), "stride_kv": list(enc.stride_kv),
            "padding_q": list(enc.padding_q), "stride_q": list(enc.stride_q),
            "drop_path_rate": list(enc.drop_path_rate),
            "layer_norm_eps": enc.layer_norm_eps, "projection_size": enc.projection_size,
        },
        "decoder": {
            "vocab_size": dec.vocab_size, "hidden_size": dec.hidden_size,
            "num_hidden_layers": dec.num_hidden_layers,
            "num_attention_heads": dec.num_attention_heads,
            "intermediate_size": dec.intermediate_size,
            "max_position_embeddings": dec.max_position_embeddings,
            "type_vocab_size": dec.type_vocab_size, "layer_norm_eps": dec.layer_norm_eps,
            "pad_token_id": dec.pad_token_id, "is_decoder": True, "add_cross_attention": True,
        },
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f, indent=1)
    if tokenizer is not None:
        tokenizer.save(os.path.join(path, "tokenizer.json"))


PEFT_PREFIX = "decoder.base_model.model."


def _strip_peft(key: str) -> str:
    return "decoder." + key[len(PEFT_PREFIX):] if key.startswith(PEFT_PREFIX) else key


def lora_rank(sd: Dict) -> Optional[int]:
    """Rank of the state dict's LoRA factors; None if it holds none."""
    for k, v in sd.items():
        if k.endswith(".lora_A.default.weight"):
            return int(v.shape[0])
    return None


def head_is_tied(sd: Dict[str, torch.Tensor]) -> bool:
    """True unless the checkpoint holds an LM projection that differs from the
    word embeddings (safetensors checkpoints drop the tied alias)."""
    def get(name):
        return sd.get("decoder." + name, sd.get(PEFT_PREFIX + name))

    head = get("cls.predictions.decoder.weight")
    if head is None:
        return True
    return torch.equal(torch.as_tensor(head),
                       torch.as_tensor(get("bert.embeddings.word_embeddings.weight")))


def model_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict under the released checkpoints' key names: a
    LoRA decoder's keys get the PEFT prefix."""
    sd = model.state_dict()
    if lora_rank(sd) is None:
        return dict(sd)
    return {PEFT_PREFIX + k[len("decoder."):] if k.startswith("decoder.") else k: v
            for k, v in sd.items()}


def export_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A model state dict (the port's names) -> the torch-layout state dict
    of numpy arrays that ``cxrmate_tpu/ckpt/hf_convert.py:178
    export_encoder_decoder`` writes, key for key: a LoRA decoder's keys get
    the PEFT prefix, the LM head's ``decoder.bias`` alias and (tied) its
    weight are written, BatchNorm's ``num_batches_tracked`` is not."""
    dp = PEFT_PREFIX if lora_rank(sd) is not None else "decoder."
    out = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.startswith("decoder.") and dp != "decoder.":
            k = dp + k[len("decoder."):]
        out[k] = v.detach().cpu().numpy()
    head = f"{dp}cls.predictions."
    out.setdefault(head + "decoder.weight", out[f"{dp}bert.embeddings.word_embeddings.weight"])
    out[head + "decoder.bias"] = out[head + "bias"]
    return out


def load_model_state(model: nn.Module, sd: Dict) -> None:
    """Load an HF-layout state dict (tensors or numpy arrays) into the port's
    encoder-decoder, strictly, after dropping what the port does not hold:
    the ``decoder.bias`` alias of ``cls.predictions.bias`` and, for a tied
    head, the projection weight. The PEFT prefix of a LoRA decoder's keys is
    stripped. BatchNorm's ``num_batches_tracked`` counters load when the
    state dict has them (a checkpoint trained with torch); without them (the
    JAX package's export) the model's own are kept."""
    tied = not hasattr(model.decoder.cls.predictions, "decoder")
    drop = ("decoder.cls.predictions.decoder.bias",)
    if tied:
        drop += ("decoder.cls.predictions.decoder.weight",)
    clean = {k: torch.as_tensor(np.asarray(v)) if isinstance(v, np.ndarray) else v
             for k, v in ((_strip_peft(k), v) for k, v in sd.items()) if k not in drop}
    missing, unexpected = model.load_state_dict(clean, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise RuntimeError(f"state dict does not fit the model: missing {missing[:8]}, "
                           f"unexpected {unexpected[:8]}")


def shard_state_dict(sd: Dict, model_rank: int, model: int, config) -> Dict:
    """Model rank ``model_rank``'s shard of a whole state dict (tensors or
    numpy arrays; the port's names or a released checkpoint's) of a decoder
    of ``config`` (``BertDecoderConfig``) split over ``model`` ranks: each
    key that ``parallel.mesh.shard_dim`` splits cut to its
    ``[r * n / model, (r + 1) * n / model)`` slice along that dimension (a
    view), every other key as it is. AdamW's moments, keyed by parameter
    name, cut the same way."""
    from cxrmate_torch.parallel.mesh import shard_dim

    out = {}
    for k, v in sd.items():
        dim = shard_dim(k, config, model)
        if dim is None:
            out[k] = v
            continue
        n = v.shape[dim] // model
        out[k] = v[(slice(None),) * dim + (slice(model_rank * n, (model_rank + 1) * n),)]
    return out


def gather_state_dict(shards: Sequence[Dict], config) -> Dict:
    """The inverse of :func:`shard_state_dict`: the shards of every model
    rank, in model-rank order, -> the whole state dict (each split key
    concatenated along its dimension, the others taken from the first)."""
    from cxrmate_torch.parallel.mesh import shard_dim

    out = {}
    for k, v in shards[0].items():
        dim = shard_dim(k, config, len(shards))
        if dim is None:
            out[k] = v
        elif isinstance(v, np.ndarray):
            out[k] = np.concatenate([s[k] for s in shards], axis=dim)
        else:
            out[k] = torch.cat([s[k] for s in shards], dim=dim)
    return out


def state_dict_from_jax(variables: Dict, enc_cfg, dec_cfg) -> Dict[str, np.ndarray]:
    """The JAX package's ``{'params': {'encoder', 'decoder'}, 'batch_stats'}``
    pytree (numpy leaves) -> an HF-layout state dict of numpy arrays, key for
    key and value for value what ``export_encoder_decoder`` writes, the PEFT
    names of a LoRA decoder included. A pytree whose ``encoder`` params are
    missing or empty gives the decoder's keys alone."""
    del dec_cfg  # the mapping reads every layer from the pytree itself
    out: Dict[str, np.ndarray] = {}

    def put_lin(key, p):
        out[f"{key}.weight"] = np.asarray(p["w"]).T
        if "b" in p:
            out[f"{key}.bias"] = np.asarray(p["b"])

    def put_ln(key, p):
        out[f"{key}.weight"] = np.asarray(p["scale"])
        out[f"{key}.bias"] = np.asarray(p["bias"])

    def put_encoder(enc, stats):
        for s in range(enc_cfg.num_stages):
            st = f"encoder.cvt.encoder.stages.{s}"
            emb = f"{st}.embedding.convolution_embeddings"
            sp = enc["stages"][s]
            out[f"{emb}.projection.weight"] = np.asarray(sp["embed"]["w"]).transpose(3, 2, 0, 1)
            out[f"{emb}.projection.bias"] = np.asarray(sp["embed"]["b"])
            put_ln(f"{emb}.normalization", sp["embed"]["ln"])
            if enc_cfg.cls_token[s]:
                out[f"{st}.cls_token"] = np.asarray(sp["cls_token"])
            for l, lp in enumerate(sp["layers"]):
                ly = f"{st}.layers.{l}"
                at = f"{ly}.attention.attention"
                ls = stats["stages"][s]["layers"][l]
                for name, hf in (("q", "query"), ("k", "key"), ("v", "value")):
                    cp = f"{at}.convolution_projection_{hf}.convolution_projection"
                    out[f"{cp}.convolution.weight"] = (
                        np.asarray(lp["attn"][f"conv_{name}"]["w"]).transpose(3, 2, 0, 1))
                    put_ln(f"{cp}.normalization", lp["attn"][f"bn_{name}"])
                    out[f"{cp}.normalization.running_mean"] = np.asarray(ls[f"bn_{name}"]["mean"])
                    out[f"{cp}.normalization.running_var"] = np.asarray(ls[f"bn_{name}"]["var"])
                    put_lin(f"{at}.projection_{hf}", lp["attn"][name])
                put_lin(f"{ly}.attention.output.dense", lp["attn"]["out"])
                put_lin(f"{ly}.intermediate.dense", lp["mlp"]["fc1"])
                put_lin(f"{ly}.output.dense", lp["mlp"]["fc2"])
                put_ln(f"{ly}.layernorm_before", lp["ln_before"])
                put_ln(f"{ly}.layernorm_after", lp["ln_after"])
        put_ln("encoder.projection_head.layer_norm", enc["projection_head"]["ln"])
        out["encoder.projection_head.projection.weight"] = (
            np.asarray(enc["projection_head"]["proj"]["w"]).T)

    if variables["params"].get("encoder"):  # a decoder-only pytree: the decoder's keys
        put_encoder(variables["params"]["encoder"], variables["batch_stats"])

    dec = variables["params"]["decoder"]
    lora = any("lora_a" in layer["self"][n] for layer in dec["layers"] for n in ("q", "k"))
    dp = PEFT_PREFIX if lora else "decoder."
    e = dec["embeddings"]
    out[f"{dp}bert.embeddings.word_embeddings.weight"] = np.asarray(e["word"])
    out[f"{dp}bert.embeddings.position_embeddings.weight"] = np.asarray(e["position"])
    out[f"{dp}bert.embeddings.token_type_embeddings.weight"] = np.asarray(e["token_type"])
    put_ln(f"{dp}bert.embeddings.LayerNorm", e["ln"])
    for l, layer in enumerate(dec["layers"]):
        ly = f"{dp}bert.encoder.layer.{l}"
        for name, hf in (("q", "query"), ("k", "key")):
            p = layer["self"][name]
            base = {k: v for k, v in p.items() if k in ("w", "b")}
            if "lora_a" in p:
                put_lin(f"{ly}.attention.self.{hf}.base_layer", base)
                out[f"{ly}.attention.self.{hf}.lora_A.default.weight"] = np.asarray(p["lora_a"]).T
                out[f"{ly}.attention.self.{hf}.lora_B.default.weight"] = np.asarray(p["lora_b"]).T
            else:
                put_lin(f"{ly}.attention.self.{hf}", base)
        put_lin(f"{ly}.attention.self.value", layer["self"]["v"])
        put_lin(f"{ly}.attention.output.dense", layer["self"]["out"])
        put_ln(f"{ly}.attention.output.LayerNorm", layer["self"]["ln"])
        if "cross" in layer:
            put_lin(f"{ly}.crossattention.self.query", layer["cross"]["q"])
            put_lin(f"{ly}.crossattention.self.key", layer["cross"]["k"])
            put_lin(f"{ly}.crossattention.self.value", layer["cross"]["v"])
            put_lin(f"{ly}.crossattention.output.dense", layer["cross"]["out"])
            put_ln(f"{ly}.crossattention.output.LayerNorm", layer["cross"]["ln"])
        put_lin(f"{ly}.intermediate.dense", layer["mlp"]["fc1"])
        put_lin(f"{ly}.output.dense", layer["mlp"]["fc2"])
        put_ln(f"{ly}.output.LayerNorm", layer["mlp"]["ln"])
    put_lin(f"{dp}cls.predictions.transform.dense", dec["lm_head"]["transform"])
    put_ln(f"{dp}cls.predictions.transform.LayerNorm", dec["lm_head"]["ln"])
    head = dec["lm_head"]["decoder"]
    out[f"{dp}cls.predictions.decoder.weight"] = (
        np.asarray(head["w"]).T if "w" in head else np.asarray(e["word"]))
    out[f"{dp}cls.predictions.bias"] = np.asarray(head["b"])
    out[f"{dp}cls.predictions.decoder.bias"] = out[f"{dp}cls.predictions.bias"]
    return out
