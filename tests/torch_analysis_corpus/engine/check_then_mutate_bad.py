"""Seeded CHECK-THEN-MUTATE violations (never imported) — the
_pool_add bug class: mutate pool/table state, THEN notice the problem."""

CEILING = 1 << 31


class FakePool:
    def __init__(self):
        self._pool_size = 0
        self._val_pool = []
        self._win_count = 0

    def pool_add_bug(self, vals):
        base = self._pool_size
        self._val_pool.append((base, vals))      # mutation first...
        self._pool_size = base + len(vals)
        if self._pool_size >= CEILING:           # ...check after
            raise RuntimeError("pool overflow")  # CHECK-THEN-MUTATE
        return base

    def window_assert_bug(self, store, n_new, rows):
        got = store.keys.append_block(n_new)     # mutation...
        assert got[0] == rows[0]                 # CHECK-THEN-MUTATE:
        return got                               # assert after (and -O
        #                                          strips it)

    def pool_add_fixed(self, vals):
        base = self._pool_size
        if base + len(vals) >= CEILING:          # clean: check BEFORE
            raise RuntimeError("pool overflow")
        self._val_pool.append((base, vals))
        self._pool_size = base + len(vals)
        return base
