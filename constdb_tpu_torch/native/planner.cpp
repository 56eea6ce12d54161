// Native round planner: one steady landing planned in one call.
//
// A steady landing (Node.merge_stream_batch -> the resident engine's micro
// round, engine/cuda.py) folds one coalesced op-stream batch into the
// keyspace's host tables and collects the device scatters of its K3
// launch.  In Python that is ~1,250 interpreter-level calls per landing
// whatever its size; here it is one call.  plan_round reads the batch
// straight from its Python lists (a replica/coalesce.py BatchBuilder, or a
// ColumnarBatch's columns) and, against the keyspace's own native tables
// and column buffers:
//
//   * evaluates the element-plane key-delete rule against the live dt
//     (replica/coalesce.py apply_key_delete_rule);
//   * resolves and creates keys, flags type conflicts
//     (engine/hostbatch.py resolve_keys, resident form: a created row is
//     neutral but for its encoding);
//   * max-merges the envelope into the host key columns (_merge_env);
//   * resolves and creates counter slots (engine/cuda.py
//     _resolve_cnt_rows) and element rows (hostbatch._resolve_el_rows);
//   * folds every slot's duplicates to one winner (hostbatch fold_pair_rows
//     and fold_el_rows: lexicographic max, ties to the later row), and
//     advances the host del_t of element rows whose delete time grew;
//   * packs the round's int64 batch columns and int32 row ids back to back
//     (the layout of TorchMergeEngine._h2d_packed) into one bytearray.
//
// It returns the segment table of the round and what Python must still
// do with objects: extend the blob side lists, register the created
// counter slots whose rank index must grow or turn into a hash, stage the
// winners' values in the pool.
//
// Check-then-mutate: the batch is read and validated whole (types, ranges,
// type conflicts, every counter node's rank) before the first table or
// column changes, so a batch that raises leaves the keyspace as it was,
// and a type-conflicted row touches no member, element or counter table.
//
// Bit-identical to the Python micro path: the same rows created in the
// same order, the same winners in the same order, so the same pool ids.
// tests/test_torch_planner.py holds the two against each other.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace plan {

constexpr int kEncBytes = 3;          // crdt/semantics.py ENC_BYTES
constexpr int kMemberBits = 32;       // store/keyspace.py MEMBER_BITS
constexpr int kPairSrc = 0, kPair = 1, kMax1 = 2;   // ops/bulk.py kinds
constexpr int kReg = 0, kCnt = 1, kEl = 2;          // family codes

// A buffer view released with its owner.
struct View {
    Py_buffer b{};
    bool held = false;
    View() = default;
    View(const View&) = delete;
    View& operator=(const View&) = delete;
    ~View() { if (held) PyBuffer_Release(&b); }
    bool get(PyObject* o, Py_ssize_t itemsize, Py_ssize_t need, bool rw,
             const char* what) {
        int fl = PyBUF_C_CONTIGUOUS | (rw ? PyBUF_WRITABLE : 0);
        if (PyObject_GetBuffer(o, &b, fl) != 0) return false;
        held = true;
        if (b.itemsize != 0 && b.itemsize != itemsize &&
            !(b.itemsize == 1 && itemsize == 1)) {
            PyErr_Format(PyExc_ValueError, "plan_round: %s has item size "
                         "%zd, expected %zd", what, b.itemsize, itemsize);
            return false;
        }
        if (b.len < need * itemsize) {
            PyErr_Format(PyExc_ValueError, "plan_round: %s holds %zd "
                         "bytes, needs %zd", what, b.len, need * itemsize);
            return false;
        }
        return true;
    }
    int64_t* i64() const { return (int64_t*)b.buf; }
    int32_t* i32() const { return (int32_t*)b.buf; }
    int8_t* i8() const { return (int8_t*)b.buf; }
};

// A new reference to a list or tuple's fast-sequence form.
struct Seq {
    PyObject* s = nullptr;
    ~Seq() { Py_XDECREF(s); }
    bool get(PyObject* o, const char* what) {
        s = PySequence_Fast(o, what);
        return s != nullptr;
    }
    Py_ssize_t n() const { return PySequence_Fast_GET_SIZE(s); }
    PyObject* at(Py_ssize_t i) const { return PySequence_Fast_GET_ITEM(s, i); }
};

struct Attr {
    PyObject* o = nullptr;
    ~Attr() { Py_XDECREF(o); }
    bool get(PyObject* obj, const char* name) {
        o = PyObject_GetAttrString(obj, name);
        return o != nullptr;
    }
};

inline bool to_i64(PyObject* o, int64_t* out) {
    long long v = PyLong_AsLongLong(o);
    if (v == -1 && PyErr_Occurred()) return false;
    *out = (int64_t)v;
    return true;
}

inline bool bytes_of(PyObject* o, const char** p, Py_ssize_t* n,
                     const char* what) {
    if (!PyBytes_Check(o)) {
        PyErr_Format(PyExc_TypeError, "plan_round: %s must be bytes, not "
                     "%.80s", what, Py_TYPE(o)->tp_name);
        return false;
    }
    *p = PyBytes_AS_STRING(o);
    *n = PyBytes_GET_SIZE(o);
    return true;
}

// The batch, read whole before anything mutates.  Object pointers are
// borrowed from the caller's lists, which outlive the call.
struct Batch {
    std::vector<PyObject*> key;
    std::vector<const char*> kp;
    std::vector<Py_ssize_t> kl;
    std::vector<int64_t> enc, ct, mt, dt, ex;
    std::vector<PyObject*> rval;           // nullptr = None
    std::vector<int64_t> rt, rn;
    std::vector<int64_t> c_ki, c_node, c_val, c_uuid, c_base, c_bt;
    std::vector<int64_t> e_ki, e_at, e_an, e_dt;
    std::vector<uint8_t> e_chk;
    std::vector<PyObject*> e_mem, e_val;   // e_val nullptr = None
    std::vector<const char*> mp;
    std::vector<Py_ssize_t> ml;
    bool el_vals_maybe = true;   // false: provably no element values

    bool keys_from(PyObject* keys) {
        Seq s;
        if (!s.get(keys, "plan_round: keys must be a sequence")) return false;
        Py_ssize_t n = s.n();
        key.resize(n); kp.resize(n); kl.resize(n);
        for (Py_ssize_t i = 0; i < n; i++) {
            key[i] = s.at(i);
            if (!bytes_of(key[i], &kp[i], &kl[i], "a key")) return false;
        }
        return true;
    }
    void reserve_members(size_t n) {
        for (auto* v : {&e_ki, &e_at, &e_an, &e_dt}) v->reserve(n);
        e_chk.reserve(n);
        e_mem.reserve(n);
        e_val.reserve(n);
        mp.reserve(n);
        ml.reserve(n);
    }
    bool member(PyObject* m, PyObject* v) {
        const char* p;
        Py_ssize_t ln;
        if (!bytes_of(m, &p, &ln, "an element member")) return false;
        e_mem.push_back(m);
        mp.push_back(p);
        ml.push_back(ln);
        e_val.push_back(v == Py_None ? nullptr : v);
        return true;
    }
};

bool i64_list(PyObject* o, std::vector<int64_t>& out, Py_ssize_t n,
              const char* what) {
    Seq s;
    if (!s.get(o, what)) return false;
    if (s.n() != n) {
        PyErr_Format(PyExc_ValueError, "plan_round: %s holds %zd items, "
                     "expected %zd", what, s.n(), n);
        return false;
    }
    out.resize(n);
    for (Py_ssize_t i = 0; i < n; i++)
        if (!to_i64(s.at(i), &out[i])) return false;
    return true;
}

// replica/coalesce.py BatchBuilder: the columns finalize() would build.
bool read_builder(PyObject* bb, Batch& B) {
    Attr keys, enc, ct, mt, dt, runs, cnt, el, hv;
    if (!keys.get(bb, "keys") || !enc.get(bb, "enc") || !ct.get(bb, "ct") ||
        !mt.get(bb, "mt") || !dt.get(bb, "dt") || !runs.get(bb, "reg_runs") ||
        !cnt.get(bb, "cnt_rows") || !el.get(bb, "el_rows") ||
        !hv.get(bb, "_el_has_vals"))
        return false;
    if (!B.keys_from(keys.o)) return false;
    Py_ssize_t n = (Py_ssize_t)B.key.size();
    if (!i64_list(enc.o, B.enc, n, "enc") || !i64_list(ct.o, B.ct, n, "ct") ||
        !i64_list(mt.o, B.mt, n, "mt") || !i64_list(dt.o, B.dt, n, "dt"))
        return false;
    B.ex.assign(n, 0);
    B.rval.assign(n, nullptr);
    B.rt.assign(n, 0);
    B.rn.assign(n, 0);
    Seq rs;
    if (!rs.get(runs.o, "plan_round: reg_runs")) return false;
    for (Py_ssize_t r = 0; r < rs.n(); r++) {
        Seq run;
        if (!run.get(rs.at(r), "plan_round: a register run")) return false;
        if (run.n() != 4) {
            PyErr_SetString(PyExc_ValueError, "plan_round: a register run "
                            "is (ki0, uuids, nodes, vals)");
            return false;
        }
        int64_t ki0;
        if (!to_i64(run.at(0), &ki0)) return false;
        Seq u, nd, v;
        if (!u.get(run.at(1), "plan_round: run uuids") ||
            !nd.get(run.at(2), "plan_round: run nodes") ||
            !v.get(run.at(3), "plan_round: run values"))
            return false;
        Py_ssize_t m = v.n();
        if (ki0 < 0 || ki0 + m > n || u.n() != m || nd.n() != m) {
            PyErr_SetString(PyExc_IndexError,
                            "plan_round: a register run outside the keys");
            return false;
        }
        for (Py_ssize_t j = 0; j < m; j++) {
            PyObject* val = v.at(j);
            B.rval[ki0 + j] = val == Py_None ? nullptr : val;
            if (!to_i64(u.at(j), &B.rt[ki0 + j]) ||
                !to_i64(nd.at(j), &B.rn[ki0 + j]))
                return false;
        }
    }
    Seq cs;
    if (!cs.get(cnt.o, "plan_round: cnt_rows")) return false;
    Py_ssize_t nc = cs.n();
    std::vector<int64_t>* ccols[6] = {&B.c_ki, &B.c_node, &B.c_val,
                                      &B.c_uuid, &B.c_base, &B.c_bt};
    for (auto* c : ccols) c->resize(nc);
    for (Py_ssize_t r = 0; r < nc; r++) {
        Seq row;
        if (!row.get(cs.at(r), "plan_round: a counter row")) return false;
        if (row.n() != 6) {
            PyErr_SetString(PyExc_ValueError, "plan_round: a counter row is "
                            "(ki, node, total, uuid, base, base_t)");
            return false;
        }
        for (int k = 0; k < 6; k++)
            if (!to_i64(row.at(k), &(*ccols[k])[r])) return false;
    }
    int hvals = PyObject_IsTrue(hv.o);
    if (hvals < 0) return false;
    B.el_vals_maybe = hvals != 0;
    Seq es;
    if (!es.get(el.o, "plan_round: el_rows")) return false;
    B.reserve_members((size_t)es.n() * 4);
    for (Py_ssize_t r = 0; r < es.n(); r++) {
        Seq row;
        if (!row.get(es.at(r), "plan_round: an element row")) return false;
        if (row.n() != 7) {
            PyErr_SetString(PyExc_ValueError, "plan_round: an element row is "
                            "(ki, members, vals, add_t, add_node, del_t, "
                            "dt_check)");
            return false;
        }
        int64_t ki, at, an, dl;
        if (!to_i64(row.at(0), &ki) || !to_i64(row.at(3), &at) ||
            !to_i64(row.at(4), &an) || !to_i64(row.at(5), &dl))
            return false;
        int chk = PyObject_IsTrue(row.at(6));
        if (chk < 0) return false;
        Seq mem;
        if (!mem.get(row.at(1), "plan_round: element members")) return false;
        PyObject* vals = row.at(2);
        Seq vs;
        bool with_vals = B.el_vals_maybe && vals != Py_None;
        if (with_vals) {
            if (!vs.get(vals, "plan_round: element values")) return false;
            if (vs.n() != mem.n()) {
                PyErr_SetString(PyExc_ValueError, "plan_round: element "
                                "values and members differ in length");
                return false;
            }
        }
        for (Py_ssize_t j = 0; j < mem.n(); j++) {
            if (!B.member(mem.at(j), with_vals ? vs.at(j) : Py_None))
                return false;
            B.e_ki.push_back(ki);
            B.e_at.push_back(at);
            B.e_an.push_back(an);
            B.e_dt.push_back(dl);
            B.e_chk.push_back((uint8_t)chk);
        }
    }
    return true;
}

bool i64_view(PyObject* o, std::vector<int64_t>& out, Py_ssize_t n,
              const char* what) {
    View v;
    if (!v.get(o, 8, n, false, what)) return false;
    out.assign(v.i64(), v.i64() + n);
    return true;
}

// A ColumnarBatch's columns, as engine/cuda.py _planner_columns packs
// them: (keys, enc, ct, mt, dt, expire, reg_val, reg_t, reg_node, cnt_ki,
// cnt_node, cnt_val, cnt_uuid, cnt_base, cnt_base_t, el_ki, el_member,
// el_val, el_add_t, el_add_node, el_del_t, check-or-None, el_vals_maybe),
// every int column a C-contiguous int64 array, check a bool array.
bool read_columns(PyObject* cols, Batch& B) {
    Seq c;
    if (!c.get(cols, "plan_round: columns")) return false;
    if (c.n() != 23) {
        PyErr_SetString(PyExc_ValueError, "plan_round: 23 columns expected");
        return false;
    }
    if (!B.keys_from(c.at(0))) return false;
    Py_ssize_t n = (Py_ssize_t)B.key.size();
    if (!i64_view(c.at(1), B.enc, n, "enc") ||
        !i64_view(c.at(2), B.ct, n, "ct") || !i64_view(c.at(3), B.mt, n, "mt") ||
        !i64_view(c.at(4), B.dt, n, "dt") ||
        !i64_view(c.at(5), B.ex, n, "expire") ||
        !i64_view(c.at(7), B.rt, n, "reg_t") ||
        !i64_view(c.at(8), B.rn, n, "reg_node"))
        return false;
    Seq rv;
    if (!rv.get(c.at(6), "plan_round: reg_val")) return false;
    if (rv.n() != n) {
        PyErr_SetString(PyExc_ValueError, "plan_round: reg_val length");
        return false;
    }
    B.rval.resize(n);
    for (Py_ssize_t i = 0; i < n; i++)
        B.rval[i] = rv.at(i) == Py_None ? nullptr : rv.at(i);
    View ck;
    if (!ck.get(c.at(9), 8, 0, false, "cnt_ki")) return false;
    Py_ssize_t nc = ck.b.len / 8;
    std::vector<int64_t>* ccols[6] = {&B.c_ki, &B.c_node, &B.c_val,
                                      &B.c_uuid, &B.c_base, &B.c_bt};
    const char* cn[6] = {"cnt_ki", "cnt_node", "cnt_val", "cnt_uuid",
                         "cnt_base", "cnt_base_t"};
    for (int k = 0; k < 6; k++)
        if (!i64_view(c.at(9 + k), *ccols[k], nc, cn[k])) return false;
    View ek;
    if (!ek.get(c.at(15), 8, 0, false, "el_ki")) return false;
    Py_ssize_t ne = ek.b.len / 8;
    if (!i64_view(c.at(15), B.e_ki, ne, "el_ki") ||
        !i64_view(c.at(18), B.e_at, ne, "el_add_t") ||
        !i64_view(c.at(19), B.e_an, ne, "el_add_node") ||
        !i64_view(c.at(20), B.e_dt, ne, "el_del_t"))
        return false;
    Seq mem, val;
    if (!mem.get(c.at(16), "plan_round: el_member") ||
        !val.get(c.at(17), "plan_round: el_val"))
        return false;
    if (mem.n() != ne || val.n() != ne) {
        PyErr_SetString(PyExc_ValueError, "plan_round: element list length");
        return false;
    }
    int hvals = PyObject_IsTrue(c.at(22));
    if (hvals < 0) return false;
    B.el_vals_maybe = hvals != 0;
    for (Py_ssize_t j = 0; j < ne; j++)
        if (!B.member(mem.at(j), val.at(j))) return false;
    B.e_chk.assign(ne, 0);
    if (c.at(21) != Py_None) {
        View chk;
        if (!chk.get(c.at(21), 1, ne, false, "check")) return false;
        for (Py_ssize_t j = 0; j < ne; j++)
            B.e_chk[j] = ((const uint8_t*)chk.b.buf)[j] != 0;
    }
    return true;
}

// One slot's candidate: the plane row, the pair (p, s), its position in
// the fold's input order (ties go to the later one) and a plain-max side.
struct Cand {
    int64_t row, p, s, d;
    Py_ssize_t pos;
};

// The fold of engine/hostbatch.py: per row the lexicographic (p, s) max,
// ties to the later position, and the max of d; winners by ascending row.
void fold(std::vector<Cand>& c, std::vector<Cand>& out) {
    std::sort(c.begin(), c.end(), [](const Cand& a, const Cand& b) {
        if (a.row != b.row) return a.row < b.row;
        if (a.p != b.p) return a.p < b.p;
        if (a.s != b.s) return a.s < b.s;
        return a.pos < b.pos;
    });
    out.clear();
    for (size_t i = 0; i < c.size(); i++) {
        if (i && c[i].row == c[i - 1].row) {
            int64_t d = std::max(out.back().d, c[i].d);
            out.back() = c[i];
            out.back().d = d;
        } else {
            out.push_back(c[i]);
        }
    }
}

struct Seg {
    int kind, fam;
    std::vector<std::vector<int64_t>> cols;
    std::vector<int32_t> ids;
};

Seg pair_seg(int kind, int fam, const std::vector<Cand>& w) {
    Seg s{kind, fam, {{}, {}}, {}};
    for (const Cand& c : w) {
        s.cols[0].push_back(c.p);
        s.cols[1].push_back(c.s);
        s.ids.push_back((int32_t)c.row);
    }
    return s;
}

// A counter node's rank and its kid -> row index: a dense int32 window
// (base, arr) or an I64Table.
struct Rank {
    int64_t node = 0, rank = 0, base = 0;
    View win;
    I64Table* hash = nullptr;
    bool has_win = false;
    int64_t lookup(int64_t kid) const {
        if (hash) return hash->get(kid, -1);
        if (!has_win) return -1;
        Py_ssize_t n = win.b.len / 4;
        if (kid < base || kid >= base + n) return -1;
        return win.i32()[kid - base];
    }
};

// Record created counter slots (kids ascending, rows row0...) in rank R's
// index as KeySpace.cnt_rows_assign does, when that takes no new window:
// -> 1 done, 0 left to Python (a rank with neither, or a window that would
// grow or turn into a hash), -1 error.
int assign_slots(Rank& R, const std::vector<int64_t>& kids, int64_t row0,
                 PyObject* rank_live, long long dense_floor,
                 long long min_fill) {
    size_t n = kids.size();
    Py_ssize_t wn = R.win.held ? R.win.b.len / 4 : 0;
    PyObject* rk = PyLong_FromLongLong(R.rank);
    if (!rk) return -1;
    PyObject* got = PyDict_GetItemWithError(rank_live, rk);
    int64_t live = 0;
    if ((!got && PyErr_Occurred()) || (got && !to_i64(got, &live))) {
        Py_DECREF(rk);
        return -1;
    }
    live += (int64_t)n;
    bool dense = R.has_win && kids.front() >= R.base &&
                 kids.back() < R.base + wn &&
                 (wn <= dense_floor || live * min_fill >= wn);
    if (!R.hash && !dense) {
        Py_DECREF(rk);
        return 0;
    }
    PyObject* lv = PyLong_FromLongLong(live);
    int rc = lv ? PyDict_SetItem(rank_live, rk, lv) : -1;
    Py_XDECREF(lv);
    Py_DECREF(rk);
    if (rc < 0) return -1;
    if (R.hash) {
        size_t before = R.hash->count;
        R.hash->batch_begin(n);
        for (size_t j = 0; j < n; j++) R.hash->put(kids[j], row0 + (int64_t)j);
        R.hash->batch_end(n, R.hash->count - before);
    } else {
        for (size_t j = 0; j < n; j++)
            R.win.i32()[kids[j] - R.base] = (int32_t)(row0 + (int64_t)j);
    }
    return 1;
}

template <class T>
T* capsule(PyObject* o, const char* name) {
    return static_cast<T*>(PyCapsule_GetPointer(o, name));
}

PyObject* list_of(const std::vector<PyObject*>& v) {
    PyObject* l = PyList_New((Py_ssize_t)v.size());
    if (!l) return nullptr;
    for (size_t i = 0; i < v.size(); i++) {
        PyObject* o = v[i] ? v[i] : Py_None;
        Py_INCREF(o);
        PyList_SET_ITEM(l, (Py_ssize_t)i, o);
    }
    return l;
}

PyObject* int_list(const std::vector<int64_t>& v) {
    PyObject* l = PyList_New((Py_ssize_t)v.size());
    if (!l) return nullptr;
    for (size_t i = 0; i < v.size(); i++) {
        PyObject* o = PyLong_FromLongLong(v[i]);
        if (!o) { Py_DECREF(l); return nullptr; }
        PyList_SET_ITEM(l, (Py_ssize_t)i, o);
    }
    return l;
}

}  // namespace plan

// plan_round(src, columnar, key_tab, member_tab, el_tab, keycols, n_keys,
//            cntcols, n_cnt, elcols, n_el, node_rank, rank_rows, rank_hash,
//            rank_live, rank_of, neutral_t, dense_floor, min_fill)
//   src: a BatchBuilder (columnar False) or a tuple of columns (True);
//   *_tab: the keyspace's table capsules; keycols (enc, ct, mt, dt, expire,
//   rv_t, rv_node, cnt_sum), cntcols (kid, node, val, uuid, base, base_t),
//   elcols (kid, add_t, add_node, del_t): the tables' backing arrays, with
//   room for every row this batch can create past n_*; node_rank,
//   rank_rows, rank_hash, rank_live: KeySpace's counter rank maps; rank_of:
//   its method, called for a node it has not ranked yet; dense_floor,
//   min_fill: its CNT_WINDOW_DENSE_FLOOR and CNT_WINDOW_MIN_FILL.
// -> (packed bytearray, n_i64, segments [(kind, fam, n, col_off, ncols,
//     id_off)], new key objects, type conflicts [(position, held encoding,
//     incoming encoding)], created counter slots left for
//     KeySpace.cnt_rows_assign [(rank, first row, kids)], new member
//     objects, register
//     winner values | None, element winner values | None, (n_keys, n_cnt,
//     n_el, reg_rows, cnt_rows, el_rows))
static PyObject* py_plan_round(PyObject*, PyObject* args) {
    using namespace plan;
    PyObject *src, *ktab_o, *mtab_o, *etab_o, *keycols, *cntcols, *elcols,
        *node_rank, *rank_rows, *rank_hash, *rank_live, *rank_of;
    int columnar;
    Py_ssize_t nk0, nc0, ne0;
    long long neutral_t, dense_floor, min_fill;
    if (!PyArg_ParseTuple(args, "OpOOOOnOnOnOOOOOLLL", &src, &columnar,
                          &ktab_o, &mtab_o, &etab_o, &keycols, &nk0, &cntcols,
                          &nc0, &elcols, &ne0, &node_rank, &rank_rows,
                          &rank_hash, &rank_live, &rank_of, &neutral_t,
                          &dense_floor, &min_fill))
        return nullptr;
    if (!PyDict_Check(node_rank) || !PyDict_Check(rank_rows) ||
        !PyDict_Check(rank_hash) || !PyDict_Check(rank_live)) {
        PyErr_SetString(PyExc_TypeError, "plan_round: the rank maps are "
                        "dicts");
        return nullptr;
    }
    StrTable* ktab = capsule<StrTable>(ktab_o, "constdb.StrTable");
    StrTable* mtab = capsule<StrTable>(mtab_o, "constdb.StrTable");
    I64Table* etab = capsule<I64Table>(etab_o, "constdb.I64Table");
    if (!ktab || !mtab || !etab) return nullptr;

    // ---- read and validate the batch (nothing mutates before "mutate")
    Batch B;
    if (!(columnar ? read_columns(src, B) : read_builder(src, B)))
        return nullptr;
    const Py_ssize_t n = (Py_ssize_t)B.key.size();
    const size_t nc = B.c_ki.size(), ne = B.e_ki.size();
    for (size_t r = 0; r < nc; r++)
        if (B.c_ki[r] < 0 || B.c_ki[r] >= n) {
            PyErr_SetString(PyExc_IndexError, "plan_round: counter row key "
                            "index out of range");
            return nullptr;
        }
    for (size_t r = 0; r < ne; r++)
        if (B.e_ki[r] < 0 || B.e_ki[r] >= n) {
            PyErr_SetString(PyExc_IndexError, "plan_round: element row key "
                            "index out of range");
            return nullptr;
        }
    Seq kc, cc, ec;
    if (!kc.get(keycols, "plan_round: keycols") ||
        !cc.get(cntcols, "plan_round: cntcols") ||
        !ec.get(elcols, "plan_round: elcols"))
        return nullptr;
    if (kc.n() != 8 || cc.n() != 6 || ec.n() != 4) {
        PyErr_SetString(PyExc_ValueError, "plan_round: column tuples are "
                        "8 (keys), 6 (counters) and 4 (elements) arrays");
        return nullptr;
    }
    View K[8], C[6], E[4];
    if (!K[0].get(kc.at(0), 1, nk0 + n, true, "keys.enc")) return nullptr;
    for (int k = 1; k < 8; k++)
        if (!K[k].get(kc.at(k), 8, nk0 + n, true, "a key column"))
            return nullptr;
    for (int k = 0; k < 6; k++)
        if (!C[k].get(cc.at(k), 8, nc0 + (Py_ssize_t)nc, true,
                      "a counter column"))
            return nullptr;
    for (int k = 0; k < 4; k++)
        if (!E[k].get(ec.at(k), 8, ne0 + (Py_ssize_t)ne, true,
                      "an element column"))
            return nullptr;
    int8_t* kenc = K[0].i8();
    int64_t *kct = K[1].i64(), *kmt = K[2].i64(), *kdt = K[3].i64(),
            *kex = K[4].i64();
    if ((Py_ssize_t)ktab->count != nk0) {
        PyErr_Format(PyExc_RuntimeError, "key interner holds %zd keys, the "
                     "key table %zd rows", (Py_ssize_t)ktab->count, nk0);
        return nullptr;
    }

    // keys: existing ids, and for a new key its first position (whose
    // encoding creates it); conflicts against what each key will hold
    std::vector<int64_t> kid(n);
    std::vector<Py_ssize_t> first(n, -1);
    std::unordered_map<std::string_view, Py_ssize_t> fresh;
    std::vector<uint64_t> kh(n);
    for (Py_ssize_t i = 0; i < n; i++)
        kh[i] = ktab->prefetch((const uint8_t*)B.kp[i], B.kl[i]);
    for (Py_ssize_t i = 0; i < n; i++) {
        kid[i] = ktab->lookup_hashed((const uint8_t*)B.kp[i], B.kl[i], kh[i]);
        if (kid[i] < 0)
            first[i] = fresh.emplace(std::string_view(B.kp[i], B.kl[i]), i)
                           .first->second;
    }
    for (Py_ssize_t i = 0; i < n; i++)
        if (kid[i] >= 0) {
            __builtin_prefetch(&kenc[kid[i]]);
            __builtin_prefetch(&kdt[kid[i]]);
        }
    std::vector<uint8_t> valid(n);
    std::vector<int64_t> bad;   // (position, held encoding) pairs
    for (Py_ssize_t i = 0; i < n; i++) {
        int64_t held = kid[i] >= 0 ? kenc[kid[i]] : B.enc[first[i]];
        valid[i] = held == B.enc[i];
        if (!valid[i]) {
            bad.push_back(i);
            bad.push_back(held);
        }
    }
    // the element key-delete rule, against the live dt (before this
    // batch's keys exist or its envelope merges)
    {
        bool any = false;
        for (size_t r = 0; r < ne && !any; r++)
            any = B.e_chk[r] && kid[B.e_ki[r]] >= 0 && kdt[kid[B.e_ki[r]]];
        if (any)
            for (size_t r = 0; r < ne; r++) {
                if (!B.e_chk[r]) continue;
                int64_t k = kid[B.e_ki[r]];
                int64_t d = k >= 0 ? kdt[k] : 0;
                if (B.e_at[r] < d) B.e_dt[r] = d;
            }
    }
    // every kept counter row's node ranked (rank_of for new nodes), and
    // its rank's index found
    std::vector<size_t> ckeep;
    for (size_t r = 0; r < nc; r++)
        if (valid[B.c_ki[r]]) ckeep.push_back(r);
    std::vector<int64_t> nodes;
    for (size_t r : ckeep) nodes.push_back(B.c_node[r]);
    std::sort(nodes.begin(), nodes.end());
    nodes.erase(std::unique(nodes.begin(), nodes.end()), nodes.end());
    std::vector<Rank> ranks(nodes.size());
    for (size_t g = 0; g < nodes.size(); g++) {
        Rank& R = ranks[g];
        R.node = nodes[g];
        PyObject* key = PyLong_FromLongLong(R.node);
        if (!key) return nullptr;
        PyObject* got = PyDict_GetItemWithError(node_rank, key);
        if (got) {
            Py_INCREF(got);
        } else if (!PyErr_Occurred()) {
            got = PyObject_CallOneArg(rank_of, key);
        }
        Py_DECREF(key);
        if (!got) return nullptr;
        bool ok = to_i64(got, &R.rank);
        Py_DECREF(got);
        if (!ok) return nullptr;
    }
    for (Rank& R : ranks) {
        PyObject* rk = PyLong_FromLongLong(R.rank);
        if (!rk) return nullptr;
        PyObject* h = PyDict_GetItemWithError(rank_hash, rk);
        PyObject* w = (h || PyErr_Occurred()) ? nullptr
                                              : PyDict_GetItemWithError(
                                                    rank_rows, rk);
        Py_DECREF(rk);
        if (PyErr_Occurred()) return nullptr;
        if (h) {
            Attr cap;
            if (!cap.get(h, "handle")) return nullptr;
            R.hash = capsule<I64Table>(cap.o, "constdb.I64Table");
            if (!R.hash) return nullptr;
        } else if (w) {
            if (!PyTuple_Check(w) || PyTuple_GET_SIZE(w) != 2 ||
                !to_i64(PyTuple_GET_ITEM(w, 0), &R.base)) {
                if (!PyErr_Occurred())
                    PyErr_SetString(PyExc_TypeError, "plan_round: a rank "
                                    "window is (base, int32 array)");
                return nullptr;
            }
            if (!R.win.get(PyTuple_GET_ITEM(w, 1), 4, 0, true,
                           "a rank window"))
                return nullptr;
            R.has_win = true;
        }
    }

    // ---- mutate
    std::vector<PyObject*> new_keys;
    ktab->batch_begin((size_t)n);
    for (Py_ssize_t i = 0; i < n; i++) {
        if (kid[i] >= 0) continue;
        if (first[i] != i) {
            kid[i] = kid[first[i]];
            continue;
        }
        int64_t id = ktab->get_or_insert((const uint8_t*)B.kp[i], B.kl[i]);
        kid[i] = id;
        kenc[id] = (int8_t)B.enc[i];
        for (int k = 1; k < 8; k++) K[k].i64()[id] = 0;
        new_keys.push_back(B.key[i]);
    }
    ktab->batch_end((size_t)n, new_keys.size());
    // envelope max over the valid rows
    for (Py_ssize_t i = 0; i < n; i++) {
        __builtin_prefetch(&kct[kid[i]]);
        __builtin_prefetch(&kmt[kid[i]]);
        __builtin_prefetch(&kdt[kid[i]]);
        __builtin_prefetch(&kex[kid[i]]);
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        if (!valid[i]) continue;
        int64_t k = kid[i];
        kct[k] = std::max(kct[k], B.ct[i]);
        kmt[k] = std::max(kmt[k], B.mt[i]);
        kdt[k] = std::max(kdt[k], B.dt[i]);
        kex[k] = std::max(kex[k], B.ex[i]);
    }
    std::vector<Seg> segs;
    std::vector<Cand> cand, win;
    // registers
    PyObject* reg_vals = nullptr;
    int64_t reg_rows = 0;
    std::vector<PyObject*> wv;
    for (Py_ssize_t i = 0; i < n; i++)
        if (valid[i] && B.enc[i] == kEncBytes && B.rval[i])
            cand.push_back({kid[i], B.rt[i], B.rn[i], 0, i});
    reg_rows = (int64_t)cand.size();
    if (!cand.empty()) {
        fold(cand, win);
        for (const Cand& c : win) wv.push_back(B.rval[c.pos]);
        segs.push_back(pair_seg(kPairSrc, kReg, win));
    }
    // counters: per node, ascending, the missing slots created by
    // ascending kid; then the (uuid, val) and (base_t, base) folds
    std::vector<int64_t> crow(nc, -1);
    int64_t* cnt_col[6];
    for (int k = 0; k < 6; k++) cnt_col[k] = C[k].i64();
    Py_ssize_t nc1 = nc0;
    PyObject* created = PyList_New(0);
    if (!created) return nullptr;
    for (Rank& R : ranks) {
        std::vector<int64_t> miss;
        for (size_t r : ckeep) {
            if (B.c_node[r] != R.node) continue;
            crow[r] = R.lookup(kid[B.c_ki[r]]);
            if (crow[r] < 0) miss.push_back(kid[B.c_ki[r]]);
        }
        if (miss.empty()) continue;
        std::sort(miss.begin(), miss.end());
        miss.erase(std::unique(miss.begin(), miss.end()), miss.end());
        Py_ssize_t row0 = nc1;
        for (int64_t k : miss) {
            const int64_t vals[6] = {k, R.node, 0, neutral_t, 0, neutral_t};
            for (int c = 0; c < 6; c++) cnt_col[c][nc1] = vals[c];
            nc1++;
        }
        for (size_t r : ckeep) {
            if (B.c_node[r] != R.node || crow[r] >= 0) continue;
            crow[r] = row0 + (std::lower_bound(miss.begin(), miss.end(),
                                               kid[B.c_ki[r]]) -
                              miss.begin());
        }
        // the created slots into the rank's index as
        // KeySpace.cnt_rows_assign records them, where that needs no new
        // window: its hash, or a dense window that covers them and stays
        // dense; any other rank's go back to Python
        int rc = assign_slots(R, miss, row0, rank_live, dense_floor,
                              min_fill);
        if (rc < 0) {
            Py_DECREF(created);
            return nullptr;
        }
        if (rc) continue;
        PyObject* kids = int_list(miss);
        PyObject* ent = kids ? Py_BuildValue("(LnN)", (long long)R.rank,
                                             row0, kids)
                             : nullptr;
        if (!ent || PyList_Append(created, ent) != 0) {
            Py_XDECREF(ent);
            Py_DECREF(created);
            return nullptr;
        }
        Py_DECREF(ent);
    }
    if (!ckeep.empty()) {
        cand.clear();
        bool neutral = true;
        for (size_t j = 0; j < ckeep.size(); j++) {
            size_t r = ckeep[j];
            cand.push_back({crow[r], B.c_uuid[r], B.c_val[r], 0,
                            (Py_ssize_t)j});
            neutral = neutral && B.c_bt[r] == neutral_t;
        }
        fold(cand, win);
        segs.push_back(pair_seg(kPairSrc, kCnt, win));
        if (!neutral) {
            cand.clear();
            for (size_t j = 0; j < ckeep.size(); j++) {
                size_t r = ckeep[j];
                cand.push_back({crow[r], B.c_bt[r], B.c_base[r], 0,
                                (Py_ssize_t)j});
            }
            fold(cand, win);
            segs.push_back(pair_seg(kPair, kCnt, win));
        }
    }
    // elements: members interned and rows resolved in kept order, missing
    // rows created in first-occurrence order; the add pair folds, the del
    // side is a max applied to the host del_t (and the device's, by MAX1)
    std::vector<size_t> ekeep;
    for (size_t r = 0; r < ne; r++)
        if (valid[B.e_ki[r]]) ekeep.push_back(r);
    std::vector<PyObject*> new_members, ev;
    bool el_vals = false;
    Py_ssize_t ne1 = ne0;
    if (!ekeep.empty()) {
        size_t m = ekeep.size();
        std::vector<int64_t> erow(m);
        mtab->batch_begin(m);
        size_t mbefore = mtab->count;
        std::vector<int64_t> combo(m);
        for (size_t j = 0; j < m; j++) {
            size_t r = ekeep[j];
            int64_t mid = mtab->get_or_insert((const uint8_t*)B.mp[r], B.ml[r]);
            combo[j] = (int64_t)((uint64_t)kid[B.e_ki[r]] << kMemberBits) | mid;
        }
        mtab->batch_end(m, mtab->count - mbefore);
        int64_t* el_col[4];
        for (int k = 0; k < 4; k++) el_col[k] = E[k].i64();
        etab->batch_begin(m);
        for (size_t j = 0; j < m; j++) etab->prefetch(combo[j]);
        for (size_t j = 0; j < m; j++) {
            int64_t v = etab->get(combo[j], INT64_MIN);
            if (v == INT64_MIN) {
                size_t r = ekeep[j];
                v = ne1++;
                etab->put(combo[j], v);
                el_col[0][v] = kid[B.e_ki[r]];
                el_col[1][v] = el_col[2][v] = el_col[3][v] = 0;
                new_members.push_back(B.e_mem[r]);
            }
            erow[j] = v;
        }
        etab->batch_end(m, (size_t)(ne1 - ne0));
        cand.clear();
        for (size_t j = 0; j < m; j++) {
            size_t r = ekeep[j];
            cand.push_back({erow[j], B.e_at[r], B.e_an[r], B.e_dt[r],
                            (Py_ssize_t)j});
            el_vals = el_vals || B.e_val[r] != nullptr;
        }
        el_vals = el_vals && B.el_vals_maybe;
        fold(cand, win);
        if (el_vals)
            for (const Cand& c : win) ev.push_back(B.e_val[ekeep[c.pos]]);
        segs.push_back(pair_seg(kPairSrc, kEl, win));
        Seg del{kMax1, kEl, {{}}, {}};
        int64_t* hdt = el_col[3];
        for (const Cand& c : win)
            if (c.d) __builtin_prefetch(&hdt[c.row]);
        for (const Cand& c : win) {
            if (c.d && c.d > hdt[c.row]) {
                hdt[c.row] = c.d;
                del.cols[0].push_back(c.d);
                del.ids.push_back((int32_t)c.row);
            }
        }
        if (!del.ids.empty()) segs.push_back(std::move(del));
    }

    // ---- pack: int64 columns of every segment, then their int32 ids
    Py_ssize_t n64 = 0, n32 = 0;
    for (const Seg& s : segs) {
        n64 += (Py_ssize_t)(s.cols.size() * s.ids.size());
        n32 += (Py_ssize_t)s.ids.size();
    }
    PyObject* packed = PyByteArray_FromStringAndSize(nullptr, n64 * 8 + n32 * 4);
    PyObject* seg_list = PyList_New((Py_ssize_t)segs.size());
    if (!packed || !seg_list) {
        Py_XDECREF(packed);
        Py_XDECREF(seg_list);
        Py_DECREF(created);
        return nullptr;
    }
    char* p64 = PyByteArray_AS_STRING(packed);
    char* p32 = p64 + n64 * 8;
    Py_ssize_t o64 = 0, o32 = 0;
    for (size_t g = 0; g < segs.size(); g++) {
        const Seg& s = segs[g];
        Py_ssize_t ns = (Py_ssize_t)s.ids.size();
        PyObject* t = Py_BuildValue("(iinnnn)", s.kind, s.fam, ns, o64,
                                    (Py_ssize_t)s.cols.size(), o32);
        if (!t) {
            Py_DECREF(packed);
            Py_DECREF(seg_list);
            Py_DECREF(created);
            return nullptr;
        }
        PyList_SET_ITEM(seg_list, (Py_ssize_t)g, t);
        for (const auto& col : s.cols) {
            std::memcpy(p64 + o64 * 8, col.data(), ns * 8);
            o64 += ns;
        }
        std::memcpy(p32 + o32 * 4, s.ids.data(), ns * 4);
        o32 += ns;
    }
    PyObject* nk = list_of(new_keys);
    PyObject* bd = PyList_New((Py_ssize_t)(bad.size() / 2));
    for (size_t j = 0; bd && j < bad.size() / 2; j++) {
        PyObject* t = Py_BuildValue("(nLL)", (Py_ssize_t)bad[2 * j],
                                    (long long)bad[2 * j + 1],
                                    (long long)B.enc[bad[2 * j]]);
        if (!t) {
            Py_CLEAR(bd);
            break;
        }
        PyList_SET_ITEM(bd, (Py_ssize_t)j, t);
    }
    PyObject* nm = list_of(new_members);
    reg_vals = wv.empty() ? (Py_INCREF(Py_None), Py_None) : list_of(wv);
    PyObject* el_v = !el_vals ? (Py_INCREF(Py_None), Py_None) : list_of(ev);
    if (!nk || !bd || !nm || !reg_vals || !el_v) {
        Py_XDECREF(nk);
        Py_XDECREF(bd);
        Py_XDECREF(nm);
        Py_XDECREF(reg_vals);
        Py_XDECREF(el_v);
        Py_DECREF(packed);
        Py_DECREF(seg_list);
        Py_DECREF(created);
        return nullptr;
    }
    return Py_BuildValue(
        "(NnNNNNNNN(nnnLnn))", packed, n64, seg_list, nk, bd, created, nm,
        reg_vals, el_v, (Py_ssize_t)(nk0 + (Py_ssize_t)new_keys.size()), nc1,
        ne1, (long long)reg_rows, (Py_ssize_t)ckeep.size(),
        (Py_ssize_t)ekeep.size());
}
