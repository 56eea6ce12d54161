"""NATIVE-CONTRACT corpus (aof direction): a record-type table drifted
from the port's native/aof.cpp NATIVE-AOF-TABLE marker block
(constdb_tpu_torch/native/aof.cpp).

The real persist/oplog.py REC_* constants must match the C scanner's
record types exactly — a value drift means each side classifies the
other's records as corruption (the crc gate rejects unknown rtypes).
This mirror seeds every failure mode: a drifted value, a Python-only
record type, and a C-side type with no Python twin.
"""

REC_BATCH = 1   # matches the native table — stays clean
REC_FRAME = 9   # drift: native/aof.cpp declares frame=2
REC_CHUNK = 7   # missing-from-table: the C scanner rejects it
# REC_WMARK deliberately absent -> unknown-record-type (the C scanner
# emits wmark=3 records the Python decoder cannot replay)
