from .settings import Settings, TypoTolerance, Pagination, Faceting, MinWordSizeForTypos
from .errors import EngineError, ErrorCode

__all__ = [
    "Settings",
    "TypoTolerance",
    "Pagination",
    "Faceting",
    "MinWordSizeForTypos",
    "EngineError",
    "ErrorCode",
]
