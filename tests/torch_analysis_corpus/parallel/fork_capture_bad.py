"""Seeded FORK-CAPTURE violations (never imported)."""
import multiprocessing as mp


def _worker(conn, shard, n_shards):
    conn.send(("ok", shard, n_shards))


class FakePool:
    def spawn_bad(self, ctx, conn, engine):
        p1 = ctx.Process(target=lambda: engine.flush())   # FORK-CAPTURE:
        #                                                   lambda capture

        def closure_worker():
            return engine
        p2 = ctx.Process(target=closure_worker)           # FORK-CAPTURE:
        #                                                   closure
        p3 = ctx.Process(target=self.run_shard)           # FORK-CAPTURE:
        #                                                   bound method
        p4 = mp.Process(target=_worker,
                        args=(conn, self.engine, engine))  # FORK-CAPTURE:
        #                                   instance state + live engine
        return p1, p2, p3, p4

    def spawn_ok(self, ctx, conn, shard):
        return ctx.Process(target=_worker,                # clean: module-
                           args=(conn, shard, 2))         # level fn + data

    def run_shard(self):
        return None
