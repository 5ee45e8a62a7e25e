from cxrmate_torch.tokenizer.bpe import ByteLevelBPETokenizer
from cxrmate_torch.tokenizer.wordpiece import WordPieceTokenizer

__all__ = ["ByteLevelBPETokenizer", "WordPieceTokenizer"]
