from .columns import Columns
from .keyspace import KeySpace

__all__ = ["Columns", "KeySpace"]
