from cxrmate_torch.tokenizer.bpe import ByteLevelBPETokenizer, train_bpe
from cxrmate_torch.tokenizer.wordpiece import WordPieceTokenizer

__all__ = ["ByteLevelBPETokenizer", "WordPieceTokenizer", "train_bpe"]
