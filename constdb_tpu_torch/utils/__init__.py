from .tables import I64Dict, StrTable, nonnull_mask

__all__ = ["I64Dict", "StrTable", "nonnull_mask"]
