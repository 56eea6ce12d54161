from .message import (
    Msg, Nil, NoReply, Simple, Err, Bulk, Int, Arr,
    NIL, NO_REPLY, OK, msg_size, mkcmd, as_bytes, as_int, as_uint,
)
from .codec import encode_msg, encode_into, RespParser

__all__ = [
    "Msg", "Nil", "NoReply", "Simple", "Err", "Bulk", "Int", "Arr",
    "NIL", "NO_REPLY", "OK", "msg_size", "mkcmd", "as_bytes", "as_int", "as_uint",
    "encode_msg", "encode_into", "RespParser",
]
