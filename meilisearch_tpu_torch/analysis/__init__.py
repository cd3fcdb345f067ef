from .tokenizer import Token, TokenKind, SeparatorKind, Tokenizer, normalize_word

__all__ = ["Token", "TokenKind", "SeparatorKind", "Tokenizer", "normalize_word"]
