"""CPU reference MergeEngine: the per-row loop the CUDA engine must match.

Semantics per crdt/semantics.py; this is also the measured CPU baseline for
bench.py (the equivalent of the reference's single-key merge path,
src/db.rs:31-43 → src/object.rs:63-83 → per-type merges).
"""

from __future__ import annotations

import logging

from ..crdt import semantics as S
from ..store.keyspace import KeySpace
from .base import ColumnarBatch, MergeStats
from .hostbatch import HOST_MICRO_MAX, HOST_ROW_MIN

log = logging.getLogger(__name__)


class CpuMergeEngine:
    name = "cpu"
    # host-only engine: nothing ever defers, so the streaming surface
    # (engine/base.py MergeEngine) is trivial
    needs_flush = False

    def merge_many(self, store: KeySpace,
                   batches: list) -> MergeStats:
        # op-stream micro-batches (the serve/stream coalescers' flushes)
        # take the vectorized host strategy — bit-identical to the per-row
        # loop below (engine/hostbatch.py docstring; differential-tested in
        # tests/test_host_combine.py and the coalescer suites), dozens of
        # times cheaper at a few hundred rows.  Bulk snapshot groups keep
        # the per-row reference path: this engine IS the measured baseline
        # and the verification oracle for those.
        total_rows = sum(b.n_rows for b in batches)
        if total_rows <= HOST_MICRO_MAX and \
                not all(b.rows_unique_per_slot for b in batches):
            # ...except TINY runs (a read-heavy pipeline's interleaved
            # write clusters, an idle stream flush): below ~2 dozen rows
            # the vectorized pass's numpy fixed costs exceed the whole
            # per-row loop, and the loop IS the reference the vectorized
            # path is differential-pinned against — routing by size can
            # never change bytes, only wall time (measured crossover
            # ~30 rows)
            if total_rows > HOST_ROW_MIN:
                from .hostbatch import merge_host_batches
                return merge_host_batches(store, batches)
        st = MergeStats()
        for b in batches:
            st += self.merge(store, b)
        return st

    def flush(self, store: KeySpace) -> None:
        return None

    def merge(self, store: KeySpace, batch: ColumnarBatch) -> MergeStats:
        st = MergeStats()
        n = batch.n_keys
        st.keys_seen = n

        # map batch key position -> local kid (-1 = type conflict, skip)
        kid_of = [-1] * n
        for i in range(n):
            key = batch.keys[i]
            enc = int(batch.key_enc[i])
            kid = store.key_index.lookup(key)
            if kid < 0:
                kid = store.create_key(key, enc, int(batch.key_ct[i]), int(batch.key_dt[i]))
                store.keys.mt[kid] = batch.key_mt[i]
                st.keys_created += 1
            elif store.enc_of(kid) != enc:
                # parity: reference db.rs:31-43 logs and skips on conflict
                log.error("type conflict merging key %r: local=%s incoming=%s",
                          key, store.enc_of(kid), enc)
                st.type_conflicts += 1
                continue
            else:
                ct, mt, dt = store.envelope(kid)
                ct, mt, dt = S.merge_envelope(ct, mt, dt, int(batch.key_ct[i]),
                                              int(batch.key_mt[i]), int(batch.key_dt[i]))
                store.keys.ct[kid], store.keys.mt[kid], store.keys.dt[kid] = ct, mt, dt
            kid_of[i] = kid
            exp = int(batch.key_expire[i])
            if exp > int(store.keys.expire[kid]):
                store.keys.expire[kid] = exp
            if enc == S.ENC_BYTES and batch.reg_val[i] is not None:
                store.register_merge(kid, batch.reg_val[i], int(batch.reg_t[i]),
                                     int(batch.reg_node[i]))

        for r in range(len(batch.cnt_ki)):
            kid = kid_of[int(batch.cnt_ki[r])]
            if kid < 0:
                continue
            store.counter_merge_slot(kid, int(batch.cnt_node[r]),
                                     int(batch.cnt_val[r]), int(batch.cnt_uuid[r]),
                                     int(batch.cnt_base[r]), int(batch.cnt_base_t[r]))
            st.counter_rows += 1

        for r in range(len(batch.el_ki)):
            kid = kid_of[int(batch.el_ki[r])]
            if kid < 0:
                continue
            store.elem_merge(kid, batch.el_member[r], int(batch.el_add_t[r]),
                             int(batch.el_add_node[r]), int(batch.el_del_t[r]),
                             batch.el_val[r])
            st.elem_rows += 1

        for r in range(len(batch.tns_ki)):
            kid = kid_of[int(batch.tns_ki[r])]
            if kid < 0:
                continue
            store.tensor_merge_row(kid, int(batch.tns_node[r]),
                                   int(batch.tns_uuid[r]),
                                   int(batch.tns_cnt[r]),
                                   batch.tns_cfg[r], batch.tns_payload[r])
            st.tensor_rows += 1

        for i, key in enumerate(batch.del_keys):
            store.record_key_delete(key, int(batch.del_t[i]))

        return st
