from .semantics import (
    ENC_COUNTER, ENC_BYTES, ENC_DICT, ENC_SET, ENC_MV, ENC_LIST, ENC_TENSOR, ENC_NAMES,
    VALUE_ENCS, lww_wins, elem_alive, key_alive, merge_envelope,
)

__all__ = [
    "ENC_COUNTER", "ENC_BYTES", "ENC_DICT", "ENC_SET", "ENC_MV", "ENC_LIST", "ENC_TENSOR",
    "ENC_NAMES", "VALUE_ENCS",
    "lww_wins", "elem_alive", "key_alive", "merge_envelope",
]
