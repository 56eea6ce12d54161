"""Seeded ASYNC-BLOCK violations (never imported)."""
import socket
import time


async def handler(path, fut):
    time.sleep(1)                       # ASYNC-BLOCK: time.sleep
    s = socket.socket()                 # ASYNC-BLOCK: sync socket
    with open(path) as f:               # ASYNC-BLOCK: sync file IO
        data = f.read()
    got = fut.result()                  # ASYNC-BLOCK: blocking future wait
    return s, data, got


async def outer(path):
    def nested_helper():                # runs on the loop when called
        return open(path).read()        # ASYNC-BLOCK: nested sync helper
    return nested_helper()


async def fine(reader):
    return await reader.read(1024)      # clean: async IO
