from cxrmate_torch.tokenizer.bpe import ByteLevelBPETokenizer

__all__ = ["ByteLevelBPETokenizer"]
