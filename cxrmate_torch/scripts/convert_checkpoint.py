"""Convert checkpoints between the HF directory layout and the port's training checkpoints.

  HF -> port:  python -m cxrmate_torch.scripts.convert_checkpoint \
                   --src HF_DIR --dst OUT_DIR --variant multi
  port -> HF:  python -m cxrmate_torch.scripts.convert_checkpoint \
                   --src CKPT_DIR --dst sd.npz --export

The port of ``scripts/convert_checkpoint.py``, in the port's formats. The
first direction reads a released checkpoint directory (safetensors or
bin) and writes ``OUT_DIR/state.pt`` holding the model's state dict, which
``ckpt.checkpoints.restore_model`` reads (and the CLI's
``warm_start_ckpt_path``). The model is the variant's (``config.json`` where
the directory has one, else the variant's preset at ``--vocab-size``), with
LoRA factors only where the checkpoint holds them. ``--export`` reads a
training checkpoint's ``state.pt`` and writes the torch-layout state dict
(``export_encoder_decoder``'s keys and arrays) as an ``.npz``. Both run on
the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from cxrmate_torch.ckpt import checkpoints as ck
from cxrmate_torch.ckpt import hf


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--variant", default="multi", choices=["single", "multi", "longitudinal"])
    p.add_argument("--vocab-size", type=int, default=30000)
    p.add_argument("--export", action="store_true", help="port checkpoint -> torch-layout npz")
    args = p.parse_args(argv)

    if args.export:
        blob = torch.load(os.path.join(args.src, ck.STATE_FILE), map_location="cpu",
                          weights_only=True)
        sd = hf.export_state_dict(blob["model"])
        np.savez(args.dst, **sd)
        print(f"wrote {len(sd)} tensors to {args.dst}")
        return args.dst

    from cxrmate_torch.cli.stages import model_from_state_dict
    from cxrmate_torch.models.api import config_from_hf_dir

    sd = hf.load_hf_pretrained_dir(args.src)
    model = model_from_state_dict(sd, config_from_hf_dir(args.src, args.variant, args.vocab_size),
                                  "cpu")
    os.makedirs(args.dst, exist_ok=True)
    torch.save({"model": model.state_dict()}, os.path.join(args.dst, ck.STATE_FILE))
    print(f"converted {args.src} -> {args.dst}")
    return args.dst


if __name__ == "__main__":
    main()
