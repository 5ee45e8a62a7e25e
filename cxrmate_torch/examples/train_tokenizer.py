"""Train the byte-level BPE tokenizer on MIMIC-CXR report sections.

    python -m cxrmate_torch.examples.train_tokenizer --dataset-dir D --out DIR [--vocab-size 30000]

The port of ``examples/train_tokenizer.py``, without pandas: the train
split of the merged index, one row per study, its findings then its
impressions with the missing ones dropped, BPE at ``--vocab-size`` with the
specials [UNK][BOS][EOS][SEP][PAD][MASK] and the four prompt specials;
writes ``DIR/tokenizer.json``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from cxrmate_torch.data import table as tb
from cxrmate_torch.data.index import build_merged_index
from cxrmate_torch.tokenizer import ByteLevelBPETokenizer, train_bpe


def train_texts(dataset_dir: str) -> List[str]:
    """The train split's findings, then its impressions, one row per study,
    missing sections dropped (the JAX example's pandas selection)."""
    df = build_merged_index(dataset_dir)
    train = df[df["split"] == "train"].drop_duplicates("study_id")
    return [v for col in ("findings", "impression")
            for v in train[col][~tb.isna(train[col])].tolist()]


def main(argv: Optional[List[str]] = None) -> ByteLevelBPETokenizer:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--vocab-size", type=int, default=30000)
    args = p.parse_args(argv)
    tok = train_bpe(train_texts(args.dataset_dir), vocab_size=args.vocab_size,
                    additional_special_tokens=["[NPF]", "[NPI]", "[PMT]", "[PMT-SEP]"])
    tok.save(args.out + "/")
    print(f"saved {len(tok)}-token tokenizer to {args.out}")
    return tok


if __name__ == "__main__":
    main()
