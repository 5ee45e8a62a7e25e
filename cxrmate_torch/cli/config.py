"""Config system: YAML with ``defaults:`` composition + CLI overrides.

The port's copy of ``cxrmate_tpu/cli/config.py``: the reference's
dlhpcstarter behaviour (hydra-style ``defaults:`` lists composing onto a base
YAML, flattened into a namespace whose keys parameterise the task). The YAML
is read by ``cli/yaml_subset.py`` (PyYAML is not a dependency of the port),
which types every value as ``yaml.safe_load`` does and refuses what it does
not take, so every config parses to the JAX package's values.

One field is the port's own: ``device`` ("cuda" by default; "cpu" runs the
stages on the CPU, where every kernel wrapper takes its plain version). Two
are read with another meaning: ``xla_cache_dir`` has no counterpart
(``stages.main`` warns once), and ``mesh_data``/``mesh_model`` lay out the
process group the stages run in as the JAX package's (data x model) mesh
(``parallel.mesh.make_mesh``: ``mesh_model`` divides the world size and
splits the decoder over each model group; ``mesh_data`` unset or the world
size over ``mesh_model``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, Dict, List, Optional

from cxrmate_torch.cli import yaml_subset


def load_config(path: str, _seen: Optional[set] = None) -> Dict[str, Any]:
    """Load a YAML config, recursively composing its ``defaults:`` list. ``_self_``
    marks where the file's own keys apply (later wins)."""
    _seen = _seen or set()
    path = os.path.abspath(path)
    assert path not in _seen, f"config cycle at {path}"
    _seen.add(path)
    with open(path) as f:
        try:
            raw = yaml_subset.load(f.read()) or {}
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    defaults: List[str] = raw.pop("defaults", ["_self_"])
    if "_self_" not in defaults:
        defaults = defaults + ["_self_"]
    merged: Dict[str, Any] = {}
    for item in defaults:
        if item == "_self_":
            merged.update(raw)
        else:
            base = os.path.join(os.path.dirname(path), f"{item}.yaml")
            merged.update(load_config(base, _seen))
    return merged


def apply_overrides(config: Dict[str, Any], overrides: List[str]) -> Dict[str, Any]:
    """key=value overrides (YAML-parsed values)."""
    out = dict(config)
    for ov in overrides:
        key, _, val = ov.partition("=")
        parsed = yaml_subset.load(val)
        if isinstance(parsed, str):
            # YAML 1.1 doesn't parse '1e-4' as a float; accept scientific notation
            try:
                parsed = float(parsed) if any(c in parsed for c in ".eE") else parsed
            except ValueError:
                pass
        out[key.strip()] = parsed
    return out


@dataclasses.dataclass
class TaskConfig:
    """Flat task configuration (the union of keys the reference configs use).

    Unknown keys in a YAML are accepted and ignored (``from_dict`` filters):
    the reference's Lightning-cosmetic flags (``deterministic``,
    ``enable_progress_bar``, ``weights_summary``, ``module``, ``definition``)
    have no counterpart. Fields, defaults and properties are the JAX
    package's (see its comments for each knob), plus ``device``."""

    task: str = "mimic_cxr"
    variant: str = "multi"  # single | multi | gt_prompt | gen_prompt | scst | scst_gt
    exp_dir: str = "experiments"
    dataset_dir: str = "datasets"
    ckpt_zoo_dir: str = "checkpoints"
    tokenizer_dir: Optional[str] = None
    trial: int = 0

    max_images_per_study: int = 5
    # image-slot padding of the collate: "batch" pads each batch to its own
    # largest image count (the reference's pad_sequence), "max" to
    # max_images_per_study; padded slots are all-zero images, masked out
    pad_images: str = "batch"
    # iterate eval/test splits in image-count order (stable sort) so batches
    # are image-slot homogeneous; never for generated-prompt datasets
    eval_sort_by_images: bool = True
    # eval/test decode batch: about this many beam rows per decode call
    # (batch = eval_decode_rows // num_beams, capped at the dataset size;
    # ragged tails padded by repeating the last study); for generated-prompt
    # datasets it sizes the lane allocation instead. 0: decode at mbatch_size
    eval_decode_rows: int = 96
    decoder_max_len: int = 256
    num_test_beams: int = 4
    sections_to_evaluate: tuple = ("report",)

    lr: float = 5e-5
    max_epochs: int = 32
    mbatch_size: int = 8
    accumulated_mbatch_size: int = 32
    every_n_epochs: int = 1  # validate + checkpoint every N epochs
    # fraction of the epoch between mid-epoch validations (Lightning semantics)
    val_check_interval: Optional[float] = None
    monitor: str = "val_report_chexbert_f1_macro"
    monitor_mode: str = "max"
    # checkpoints retained per monitored metric (<= 0 keeps every checkpoint)
    save_top_k: int = 1
    precision: str = "bf16"
    num_workers: int = 5

    # warm-start modes (reference tools/stages.py:52-85, priority order:
    # explicit ckpt path > other experiment dir > HF checkpoint > fresh init)
    warm_start_ckpt_path: Optional[str] = None
    warm_start_exp_dir: Optional[str] = None
    warm_start_monitor: str = "val_report_chexbert_f1_macro"
    warm_start_monitor_mode: str = "max"
    warm_start_name: Optional[str] = None
    multi_ckpt_name: Optional[str] = None
    # test-time checkpoint selection (reference tools/stages.py:93-105)
    test_ckpt_name: Optional[str] = None
    test_epoch: Optional[int] = None
    test_ckpt_path: Optional[str] = None
    # resume modes (reference tools/stages.py:88)
    resume_last: bool = False
    resume_epoch: Optional[int] = None
    resume_ckpt_path: Optional[str] = None
    fast_dev_run: bool = False  # 1-batch/1-epoch dry run

    # the (data x model) layout of the process group: mesh_model ranks a
    # model group (the decoder split over them), mesh_data unset or N / M
    mesh_data: Optional[int] = None
    mesh_model: int = 1
    # pad every TF batch to the static decoder/prompt budgets instead of the
    # batch's longest (pad keys and labels are masked)
    static_tf_pad: bool = False

    # model preset: "cxrmate" (CvT-21@384 + 6L BERT) or "tiny" (smoke tests)
    model_preset: str = "cxrmate"
    image_size: int = 384
    # on-disk decoded-image cache of the loaders ("auto" -> <exp_dir>/.image_cache;
    # null turns it off)
    image_cache_dir: Optional[str] = "auto"
    # the JAX package's XLA compilation cache; nothing in the port reads it
    xla_cache_dir: Optional[str] = None
    # where the stages run: "cuda" (the default; there is no CPU fallback) or "cpu"
    device: str = "cuda"

    @property
    def resolved_xla_cache_dir(self) -> Optional[str]:
        if not self.xla_cache_dir:
            return None
        if self.xla_cache_dir == "auto":
            return os.path.join(self.exp_dir, ".xla_cache")
        return self.xla_cache_dir

    @property
    def resolved_image_cache_dir(self) -> Optional[str]:
        """``image_cache_dir`` with "auto" resolved under ``exp_dir`` (shared
        across tasks/variants/trials of one experiments root) and falsy values
        normalised to None (cache off)."""
        if not self.image_cache_dir:
            return None
        if self.image_cache_dir == "auto":
            return os.path.join(self.exp_dir, ".image_cache")
        return self.image_cache_dir

    @property
    def exp_dir_trial(self) -> str:
        return os.path.join(self.exp_dir, self.task, self.variant, f"trial_{self.trial}")

    @property
    def accumulate_steps(self) -> int:
        return max(1, self.accumulated_mbatch_size // self.mbatch_size)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TaskConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in fields}
        if "sections_to_evaluate" in kwargs and isinstance(kwargs["sections_to_evaluate"], list):
            kwargs["sections_to_evaluate"] = tuple(kwargs["sections_to_evaluate"])
        return cls(**kwargs)


VALID_VARIANTS = ("single", "multi", "gt_prompt", "gen_prompt", "scst", "scst_gt")


def parse_args(argv=None) -> TaskConfig:
    p = argparse.ArgumentParser("cxrmate_torch")
    p.add_argument("--config", "-c", required=True)
    p.add_argument("--train", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--trial", type=int, default=0)
    p.add_argument("overrides", nargs="*", help="key=value overrides")
    args = p.parse_args(argv)
    if not os.path.exists(args.config):
        p.error(f"config file not found: {args.config}")
    cfg = apply_overrides(load_config(args.config), args.overrides)
    cfg["trial"] = args.trial
    if cfg.get("variant") not in VALID_VARIANTS:
        p.error(f"variant must be one of {VALID_VARIANTS}, got {cfg.get('variant')!r}")
    task = TaskConfig.from_dict(cfg)
    task._train = args.train  # type: ignore[attr-defined]
    task._test = args.test  # type: ignore[attr-defined]
    return task
