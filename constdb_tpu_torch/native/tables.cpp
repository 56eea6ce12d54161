// Native staging tables for the merge hot path (C++17, no deps).
//
// The port's own copy of the reference package's native/tables.cpp.
//
// The merge engine's host-side cost is index resolution: key bytes -> row,
// (key,node) combo -> counter slot, (key,member) combo -> element row.  In
// Python these are dict probes at ~100ns each over millions of rows; here
// they are open-addressing tables with batch entry points called once per
// column through the CPython extension (pyext.cpp, bound by
// constdb_tpu_torch/utils/tables.py).  The reference's extern "C" entry
// points (its ctypes tier) are not part of the port.
//
//   StrTable — bytes -> dense id (insertion order).  Strings are copied into
//              an arena; id -> (offset,len) lets callers recover bytes.
//   I64Table — int64 -> int64 with tombstone deletion and batch
//              lookup/assign; used for integer combo keys.
//
// Hashing: splitmix64 finalizer for ints, FNV-1a + splitmix for strings.

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ULL;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
}

inline uint64_t hash_bytes(const uint8_t* p, int64_t len) {
    uint64_t h = 0xCBF29CE484222325ULL;
    for (int64_t i = 0; i < len; i++) {
        h ^= p[i];
        h *= 0x100000001B3ULL;
    }
    return splitmix64(h);
}

inline size_t next_pow2(size_t n) {
    size_t p = 16;
    while (p < n) p <<= 1;
    return p;
}

}  // namespace

// ------------------------------------------------------------------ StrTable

struct StrTable {
    // slot: id+1 (0 = empty); ids index into offs/lens
    std::vector<int64_t> slots;
    std::vector<uint64_t> hashes;   // per-slot cached hash
    std::vector<uint8_t> arena;
    std::vector<int64_t> offs;      // per-id arena offset
    std::vector<int64_t> lens;      // per-id length
    size_t mask = 0;
    size_t count = 0;
    double new_ratio = 1.0;  // EMA of observed new-per-row in batches

    explicit StrTable(size_t cap_hint) {
        size_t cap = next_pow2(cap_hint * 2);
        slots.assign(cap, 0);
        hashes.assign(cap, 0);
        mask = cap - 1;
    }

    void rebuild(size_t cap) {
        std::vector<int64_t> ns(cap, 0);
        std::vector<uint64_t> nh(cap, 0);
        size_t nm = cap - 1;
        for (size_t i = 0; i < slots.size(); i++) {
            if (!slots[i]) continue;
            size_t j = hashes[i] & nm;
            while (ns[j]) j = (j + 1) & nm;
            ns[j] = slots[i];
            nh[j] = hashes[i];
        }
        slots.swap(ns);
        hashes.swap(nh);
        mask = nm;
    }

    void grow_to(size_t cap) {
        if (cap > slots.size()) rebuild(cap);
    }

    void grow() { grow_to(slots.size() * 2); }

    // presize for `extra` further inserts: one rehash up front instead of
    // several mid-batch doublings.  Gated to the bulk-ingest shape
    // (extra dominates count AND the worst case would trip growth) so a
    // duplicate-heavy re-merge or a small batch into a big healthy table
    // cannot force a rehash or permanently overallocate.
    void reserve_extra(size_t extra) {
        if (extra <= count) return;
        if ((count + extra) * 10 < slots.size() * 7) return;
        grow_to(next_pow2((count + extra) * 2));
    }

    // after a batch: a reserve sized for batch-INTERNAL duplicates that
    // never materialized leaves the table nearly empty — rehash the few
    // live entries down (ids are stable; only the slot vectors shrink;
    // the 0.2 shrink vs 0.5 post-reserve load gives hysteresis)
    void maybe_shrink() {
        size_t want = next_pow2(count * 4 + 16);
        if (slots.size() > 4096 && count * 10 < slots.size() * 2 &&
            want < slots.size())
            rebuild(want);
    }

    // shared batch protocol of every binding (the C entry points and the
    // CPython extension): presize by the learned new-row ratio, then
    // after the loop shrink an over-eager reserve and update the EMA
    void batch_begin(size_t n) {
        reserve_extra((size_t)((double)n * new_ratio) + 16);
    }
    void batch_end(size_t n, size_t fresh) {
        maybe_shrink();
        if (n > 256) {
            double r = (double)fresh / (double)n;
            new_ratio = 0.5 * new_ratio + 0.5 * r;
            if (new_ratio < 0.02) new_ratio = 0.02;
            if (new_ratio > 1.0) new_ratio = 1.0;
        }
    }

    inline bool eq(int64_t id, const uint8_t* p, int64_t len) const {
        return lens[id] == len &&
               std::memcmp(arena.data() + offs[id], p, (size_t)len) == 0;
    }

    int64_t lookup(const uint8_t* p, int64_t len) const {
        uint64_t h = hash_bytes(p, len);
        size_t j = h & mask;
        while (slots[j]) {
            if (hashes[j] == h && eq(slots[j] - 1, p, len)) return slots[j] - 1;
            j = (j + 1) & mask;
        }
        return -1;
    }

    int64_t get_or_insert(const uint8_t* p, int64_t len) {
        uint64_t h = hash_bytes(p, len);
        size_t j = h & mask;
        while (slots[j]) {
            if (hashes[j] == h && eq(slots[j] - 1, p, len)) return slots[j] - 1;
            j = (j + 1) & mask;
        }
        int64_t id = (int64_t)count;
        offs.push_back((int64_t)arena.size());
        lens.push_back(len);
        arena.insert(arena.end(), p, p + len);
        slots[j] = id + 1;
        hashes[j] = h;
        count++;
        if (count * 10 >= slots.size() * 7) grow();
        return id;
    }
};

// ------------------------------------------------------------------ I64Table

struct I64Table {
    static constexpr int64_t kEmpty = INT64_MIN;
    static constexpr int64_t kTomb = INT64_MIN + 1;
    std::vector<int64_t> keys;
    std::vector<int64_t> vals;
    size_t mask = 0;
    size_t count = 0;   // live entries
    size_t used = 0;    // live + tombstones
    double new_ratio = 1.0;  // EMA of observed new-per-row in batches

    explicit I64Table(size_t cap_hint) {
        size_t cap = next_pow2(cap_hint * 2);
        keys.assign(cap, kEmpty);
        vals.assign(cap, 0);
        mask = cap - 1;
    }

    void rehash(size_t cap) {
        std::vector<int64_t> nk(cap, kEmpty), nv(cap, 0);
        size_t nm = cap - 1;
        for (size_t i = 0; i < keys.size(); i++) {
            if (keys[i] == kEmpty || keys[i] == kTomb) continue;
            size_t j = splitmix64((uint64_t)keys[i]) & nm;
            while (nk[j] != kEmpty) j = (j + 1) & nm;
            nk[j] = keys[i];
            nv[j] = vals[i];
        }
        keys.swap(nk);
        vals.swap(nv);
        mask = nm;
        used = count;
    }

    inline void maybe_grow() {
        if (used * 10 >= keys.size() * 7)
            rehash(count * 10 >= keys.size() * 4 ? keys.size() * 2 : keys.size());
    }

    // presize for `extra` further inserts: one up-front rehash instead of
    // several mid-batch doublings.  Same bulk-ingest gate as StrTable:
    // never triggered by small batches or duplicate-heavy re-merges.
    void reserve_extra(size_t extra) {
        if (extra <= count) return;
        if ((count + extra) * 10 < keys.size() * 7) return;
        rehash(next_pow2((count + extra) * 2));
    }

    // post-batch: undo a reserve that batch-internal duplicates left
    // nearly empty (see StrTable::maybe_shrink)
    void maybe_shrink() {
        size_t want = next_pow2(count * 4 + 16);
        if (keys.size() > 4096 && count * 10 < keys.size() * 2 &&
            want < keys.size())
            rehash(want);
    }

    // shared batch protocol of every binding (the C entry points and the
    // CPython extension): presize by the learned new-row ratio, then
    // after the loop shrink an over-eager reserve and update the EMA
    void batch_begin(size_t n) {
        reserve_extra((size_t)((double)n * new_ratio) + 16);
    }
    void batch_end(size_t n, size_t fresh) {
        maybe_shrink();
        if (n > 256) {
            double r = (double)fresh / (double)n;
            new_ratio = 0.5 * new_ratio + 0.5 * r;
            if (new_ratio < 0.02) new_ratio = 0.02;
            if (new_ratio > 1.0) new_ratio = 1.0;
        }
    }

    int64_t get(int64_t k, int64_t dflt) const {
        size_t j = splitmix64((uint64_t)k) & mask;
        while (keys[j] != kEmpty) {
            if (keys[j] == k) return vals[j];
            j = (j + 1) & mask;
        }
        return dflt;
    }

    void put(int64_t k, int64_t v) {
        size_t j = splitmix64((uint64_t)k) & mask;
        size_t tomb = SIZE_MAX;
        while (keys[j] != kEmpty) {
            if (keys[j] == k) { vals[j] = v; return; }
            if (keys[j] == kTomb && tomb == SIZE_MAX) tomb = j;
            j = (j + 1) & mask;
        }
        if (tomb != SIZE_MAX) {
            keys[tomb] = k;
            vals[tomb] = v;
            count++;
        } else {
            keys[j] = k;
            vals[j] = v;
            count++;
            used++;
            maybe_grow();
        }
    }

    int64_t del(int64_t k, int64_t dflt) {
        size_t j = splitmix64((uint64_t)k) & mask;
        while (keys[j] != kEmpty) {
            if (keys[j] == k) {
                int64_t v = vals[j];
                keys[j] = kTomb;
                count--;
                return v;
            }
            j = (j + 1) & mask;
        }
        return dflt;
    }
};
