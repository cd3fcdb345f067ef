from .store import VectorSearcher

__all__ = ["VectorSearcher"]
