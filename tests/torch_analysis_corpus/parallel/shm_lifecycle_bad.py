"""Seeded SHM-LIFECYCLE violations (never imported)."""
from multiprocessing import shared_memory


def leaky(payload: bytes) -> str:
    shm = shared_memory.SharedMemory(create=True,    # SHM-LIFECYCLE:
                                     size=len(payload))  # no guard
    shm.buf[: len(payload)] = payload
    return shm.name


def guarded(payload: bytes) -> str:
    shm = shared_memory.SharedMemory(create=True, size=len(payload))
    try:                                             # clean: handler
        shm.buf[: len(payload)] = payload            # closes + unlinks
        return shm.name
    except BaseException:
        shm.close()
        shm.unlink()
        raise


def transferred(payload: bytes):
    # documented ownership hand-off  # lint: ignore[SHM-LIFECYCLE]
    shm = shared_memory.SharedMemory(create=True, size=len(payload))
    return shm
