from .levenshtein import osa_distances, pack_words

__all__ = ["osa_distances", "pack_words"]
