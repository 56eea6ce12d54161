"""Error types for the constdb PyTorch port (a copy of constdb_tpu/errors.py).

Capability parity with the reference's error enum (reference src/lib.rs:145-181
`CstError`), re-expressed as a Python exception hierarchy.  Errors that map to
client-visible RESP errors implement `resp_error()`.
"""

from __future__ import annotations


class CstError(Exception):
    """Base error. `resp_error()` returns the RESP error text for clients."""

    def resp_error(self) -> bytes:
        return str(self).encode()


class WrongArity(CstError):
    def __init__(self, cmd: str = ""):
        super().__init__(f"wrong number of arguments for '{cmd}'" if cmd else "wrong number of arguments")


class InvalidType(CstError):
    def __init__(self) -> None:
        super().__init__("WRONGTYPE Operation against a key holding the wrong kind of value")


class UnknownCmd(CstError):
    def __init__(self, name: str):
        self.name = name
        super().__init__(f"unknown command '{name}'")


class UnknownSubCmd(CstError):
    def __init__(self, sub: str, cmd: str):
        super().__init__(f"unknown subcommand '{sub}' for '{cmd}'")


class InvalidRequestMsg(CstError):
    def __init__(self, why: str):
        super().__init__(f"invalid request: {why}")


class InvalidSnapshot(CstError):
    def __init__(self, offset: int):
        self.offset = offset
        super().__init__(f"invalid snapshot at offset {offset}")


class InvalidSnapshotChecksum(CstError):
    def __init__(self) -> None:
        super().__init__("snapshot checksum mismatch")


class ConnBroken(CstError):
    def __init__(self, addr: str = ""):
        super().__init__(f"connection broken: {addr}")


class ReplicateCommandsLost(CstError):
    """The peer's resume uuid fell out of its repl-log: must full-resync."""

    def __init__(self, addr: str = ""):
        super().__init__(f"replicate commands lost from {addr}")


class ReplicaNodeAlreadyExist(CstError):
    def __init__(self, addr: str = ""):
        super().__init__(f"replica already exists: {addr}")


class SystemError_(CstError):
    def __init__(self, why: str = "system error"):
        super().__init__(why)
