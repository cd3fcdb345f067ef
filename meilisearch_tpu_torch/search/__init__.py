from .executor import Search, SearchResult

__all__ = ["Search", "SearchResult"]
