// CPython extension binding for the staging tables (tables.cpp), CRC-64
// (crc64.cpp), the RESP parser and encoder (resp.cpp), the pipelined
// command intake scanner (intake.cpp) and the REPLBATCH blob columns
// (wire.cpp).
//
// The port's own copy of the reference package's native/pyext.cpp, without
// the AOF scanner (it comes with the op log), and with crc64 added: the
// reference calls its CRC through ctypes, the port through this module.
// The extension walks a list of PyBytes directly in C, so the caller packs
// no blob; output arrays are caller-allocated numpy buffers passed through
// the buffer protocol (no numpy C-API dependency).
//
// Built at first use by constdb_tpu_torch/utils/native.py, with the hash of
// the sources, flags and compiler compiled in as CST_ABI_STAMP; the loader
// there refuses a module whose stamp differs.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include "crc64.cpp"   // self-contained: cst_crc64
#include "tables.cpp"  // self-contained: StrTable / I64Table definitions
#include "resp.cpp"    // RESP flat-array fast parser (py_resp_parse)
#include "intake.cpp"  // pipelined-command intake engine (py_intake_scan)
#include "wire.cpp"    // REPLBATCH blob columns (py_wire_{pack,unpack}_blobs)

#ifndef CST_ABI_STAMP
#define CST_ABI_STAMP ""
#endif

namespace {

PyObject* py_abi_stamp(PyObject*, PyObject*) {
    return PyUnicode_FromString(CST_ABI_STAMP);
}

const char* kStrCapsule = "constdb.StrTable";
const char* kI64Capsule = "constdb.I64Table";

void str_destructor(PyObject* cap) {
    delete static_cast<StrTable*>(PyCapsule_GetPointer(cap, kStrCapsule));
}
void i64_destructor(PyObject* cap) {
    delete static_cast<I64Table*>(PyCapsule_GetPointer(cap, kI64Capsule));
}

StrTable* get_str(PyObject* cap) {
    return static_cast<StrTable*>(PyCapsule_GetPointer(cap, kStrCapsule));
}
I64Table* get_i64(PyObject* cap) {
    return static_cast<I64Table*>(PyCapsule_GetPointer(cap, kI64Capsule));
}

bool out_buffer(PyObject* obj, Py_buffer* view, Py_ssize_t need_items) {
    if (PyObject_GetBuffer(obj, view, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) != 0)
        return false;
    if (view->len < (Py_ssize_t)(need_items * sizeof(int64_t))) {
        PyBuffer_Release(view);
        PyErr_SetString(PyExc_ValueError, "output buffer too small");
        return false;
    }
    return true;
}

// ------------------------------------------------------------------ StrTable

PyObject* py_strtab_new(PyObject*, PyObject* args) {
    Py_ssize_t cap_hint = 16;
    if (!PyArg_ParseTuple(args, "|n", &cap_hint)) return nullptr;
    return PyCapsule_New(new StrTable((size_t)cap_hint), kStrCapsule,
                         str_destructor);
}

PyObject* py_strtab_len(PyObject*, PyObject* args) {
    PyObject* cap;
    if (!PyArg_ParseTuple(args, "O", &cap)) return nullptr;
    StrTable* t = get_str(cap);
    if (!t) return nullptr;
    return PyLong_FromSsize_t((Py_ssize_t)t->count);
}

PyObject* py_strtab_get_or_insert(PyObject*, PyObject* args) {
    PyObject* cap;
    Py_buffer b;
    if (!PyArg_ParseTuple(args, "Oy*", &cap, &b)) return nullptr;
    StrTable* t = get_str(cap);
    if (!t) { PyBuffer_Release(&b); return nullptr; }
    int64_t id = t->get_or_insert((const uint8_t*)b.buf, (int64_t)b.len);
    PyBuffer_Release(&b);
    return PyLong_FromLongLong(id);
}

PyObject* py_strtab_lookup(PyObject*, PyObject* args) {
    PyObject* cap;
    Py_buffer b;
    if (!PyArg_ParseTuple(args, "Oy*", &cap, &b)) return nullptr;
    StrTable* t = get_str(cap);
    if (!t) { PyBuffer_Release(&b); return nullptr; }
    int64_t id = t->lookup((const uint8_t*)b.buf, (int64_t)b.len);
    PyBuffer_Release(&b);
    return PyLong_FromLongLong(id);
}

// (table, list[bytes], out int64[n]) -> n_new
PyObject* py_strtab_get_or_insert_batch(PyObject*, PyObject* args) {
    PyObject *cap, *list, *out;
    if (!PyArg_ParseTuple(args, "OOO", &cap, &list, &out)) return nullptr;
    StrTable* t = get_str(cap);
    if (!t) return nullptr;
    PyObject* seq = PySequence_Fast(list, "expected a sequence of bytes");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    Py_buffer ob;
    if (!out_buffer(out, &ob, n)) { Py_DECREF(seq); return nullptr; }
    int64_t* dst = (int64_t*)ob.buf;
    t->batch_begin((size_t)n);
    int64_t before = (int64_t)t->count;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
        char* p;
        Py_ssize_t len;
        if (PyBytes_AsStringAndSize(item, &p, &len) != 0) {
            PyBuffer_Release(&ob);
            Py_DECREF(seq);
            return nullptr;
        }
        dst[i] = t->get_or_insert((const uint8_t*)p, (int64_t)len);
    }
    int64_t fresh = (int64_t)t->count - before;
    t->batch_end((size_t)n, (size_t)fresh);
    PyBuffer_Release(&ob);
    Py_DECREF(seq);
    return PyLong_FromLongLong(fresh);
}

PyObject* py_strtab_lookup_batch(PyObject*, PyObject* args) {
    PyObject *cap, *list, *out;
    if (!PyArg_ParseTuple(args, "OOO", &cap, &list, &out)) return nullptr;
    StrTable* t = get_str(cap);
    if (!t) return nullptr;
    PyObject* seq = PySequence_Fast(list, "expected a sequence of bytes");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    Py_buffer ob;
    if (!out_buffer(out, &ob, n)) { Py_DECREF(seq); return nullptr; }
    int64_t* dst = (int64_t*)ob.buf;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
        char* p;
        Py_ssize_t len;
        if (PyBytes_AsStringAndSize(item, &p, &len) != 0) {
            PyBuffer_Release(&ob);
            Py_DECREF(seq);
            return nullptr;
        }
        dst[i] = t->lookup((const uint8_t*)p, (int64_t)len);
    }
    PyBuffer_Release(&ob);
    Py_DECREF(seq);
    Py_RETURN_NONE;
}

PyObject* py_strtab_bytes_of(PyObject*, PyObject* args) {
    PyObject* cap;
    Py_ssize_t id;
    if (!PyArg_ParseTuple(args, "On", &cap, &id)) return nullptr;
    StrTable* t = get_str(cap);
    if (!t) return nullptr;
    if (id < 0 || (size_t)id >= t->count) {
        PyErr_SetString(PyExc_IndexError, "string id out of range");
        return nullptr;
    }
    return PyBytes_FromStringAndSize(
        (const char*)t->arena.data() + t->offs[id], (Py_ssize_t)t->lens[id]);
}

// ------------------------------------------------------------------ I64Table

PyObject* py_i64_new(PyObject*, PyObject* args) {
    Py_ssize_t cap_hint = 16;
    if (!PyArg_ParseTuple(args, "|n", &cap_hint)) return nullptr;
    return PyCapsule_New(new I64Table((size_t)cap_hint), kI64Capsule,
                         i64_destructor);
}

PyObject* py_i64_len(PyObject*, PyObject* args) {
    PyObject* cap;
    if (!PyArg_ParseTuple(args, "O", &cap)) return nullptr;
    I64Table* t = get_i64(cap);
    if (!t) return nullptr;
    return PyLong_FromSsize_t((Py_ssize_t)t->count);
}

PyObject* py_i64_get(PyObject*, PyObject* args) {
    PyObject* cap;
    long long k, dflt;
    if (!PyArg_ParseTuple(args, "OLL", &cap, &k, &dflt)) return nullptr;
    I64Table* t = get_i64(cap);
    if (!t) return nullptr;
    return PyLong_FromLongLong(t->get(k, dflt));
}

PyObject* py_i64_put(PyObject*, PyObject* args) {
    PyObject* cap;
    long long k, v;
    if (!PyArg_ParseTuple(args, "OLL", &cap, &k, &v)) return nullptr;
    I64Table* t = get_i64(cap);
    if (!t) return nullptr;
    t->put(k, v);
    Py_RETURN_NONE;
}

PyObject* py_i64_del(PyObject*, PyObject* args) {
    PyObject* cap;
    long long k, dflt;
    if (!PyArg_ParseTuple(args, "OLL", &cap, &k, &dflt)) return nullptr;
    I64Table* t = get_i64(cap);
    if (!t) return nullptr;
    return PyLong_FromLongLong(t->del(k, dflt));
}

bool in_buffer(PyObject* obj, Py_buffer* view) {
    return PyObject_GetBuffer(obj, view, PyBUF_C_CONTIGUOUS) == 0;
}

// (table, keys int64[n], dflt, out int64[n])
PyObject* py_i64_lookup_batch(PyObject*, PyObject* args) {
    PyObject *cap, *keys, *out;
    long long dflt;
    if (!PyArg_ParseTuple(args, "OOLO", &cap, &keys, &dflt, &out)) return nullptr;
    I64Table* t = get_i64(cap);
    if (!t) return nullptr;
    Py_buffer kb, ob;
    if (!in_buffer(keys, &kb)) return nullptr;
    Py_ssize_t n = kb.len / (Py_ssize_t)sizeof(int64_t);
    if (!out_buffer(out, &ob, n)) { PyBuffer_Release(&kb); return nullptr; }
    const int64_t* ks = (const int64_t*)kb.buf;
    int64_t* dst = (int64_t*)ob.buf;
    for (Py_ssize_t i = 0; i < n; i++) dst[i] = t->get(ks[i], dflt);
    PyBuffer_Release(&ob);
    PyBuffer_Release(&kb);
    Py_RETURN_NONE;
}

// (table, keys int64[n], vals int64[n])
PyObject* py_i64_put_batch(PyObject*, PyObject* args) {
    PyObject *cap, *keys, *vals;
    if (!PyArg_ParseTuple(args, "OOO", &cap, &keys, &vals)) return nullptr;
    I64Table* t = get_i64(cap);
    if (!t) return nullptr;
    Py_buffer kb, vb;
    if (!in_buffer(keys, &kb)) return nullptr;
    if (!in_buffer(vals, &vb)) { PyBuffer_Release(&kb); return nullptr; }
    Py_ssize_t n = kb.len / (Py_ssize_t)sizeof(int64_t);
    const int64_t* ks = (const int64_t*)kb.buf;
    const int64_t* vs = (const int64_t*)vb.buf;
    t->batch_begin((size_t)n);
    size_t pb_before = t->count;
    for (Py_ssize_t i = 0; i < n; i++) t->put(ks[i], vs[i]);
    t->batch_end((size_t)n, t->count - pb_before);
    PyBuffer_Release(&vb);
    PyBuffer_Release(&kb);
    Py_RETURN_NONE;
}

// (table, keys int64[n], next, out int64[n]) -> n_new
PyObject* py_i64_get_or_assign_batch(PyObject*, PyObject* args) {
    PyObject *cap, *keys, *out;
    long long next;
    if (!PyArg_ParseTuple(args, "OOLO", &cap, &keys, &next, &out)) return nullptr;
    I64Table* t = get_i64(cap);
    if (!t) return nullptr;
    Py_buffer kb, ob;
    if (!in_buffer(keys, &kb)) return nullptr;
    Py_ssize_t n = kb.len / (Py_ssize_t)sizeof(int64_t);
    if (!out_buffer(out, &ob, n)) { PyBuffer_Release(&kb); return nullptr; }
    const int64_t* ks = (const int64_t*)kb.buf;
    int64_t* dst = (int64_t*)ob.buf;
    t->batch_begin((size_t)n);
    int64_t start = next;
    for (Py_ssize_t i = 0; i < n; i++) {
        int64_t v = t->get(ks[i], INT64_MIN);
        if (v == INT64_MIN) {
            v = next++;
            t->put(ks[i], v);
        }
        dst[i] = v;
    }
    t->batch_end((size_t)n, (size_t)(next - start));
    PyBuffer_Release(&ob);
    PyBuffer_Release(&kb);
    return PyLong_FromLongLong(next - start);
}

// Bool mask of non-None entries of a list, returned as raw bytes (the
// Python side views it as a bool ndarray).  The per-row `v is not None`
// generator over multi-million-row value columns is one of the largest
// host costs in the merge dispatch (engine/cuda.py staging).
static PyObject* py_nonnull_mask(PyObject*, PyObject* args) {
    PyObject* lst;
    if (!PyArg_ParseTuple(args, "O", &lst)) return nullptr;
    if (!PyList_CheckExact(lst)) {
        PyErr_SetString(PyExc_TypeError, "nonnull_mask expects a list");
        return nullptr;
    }
    Py_ssize_t n = PyList_GET_SIZE(lst);
    // bytearray (not bytes): numpy views over it stay WRITABLE, matching
    // the pure-Python fallback's mutability contract
    PyObject* out = PyByteArray_FromStringAndSize(nullptr, n);
    if (!out) return nullptr;
    char* p = PyByteArray_AS_STRING(out);
    for (Py_ssize_t i = 0; i < n; i++)
        p[i] = PyList_GET_ITEM(lst, i) != Py_None;
    return out;
}

// CRC-64/XZ of any C-contiguous buffer, continuing from `crc`; the GIL is
// released while it runs.
static PyObject* py_crc64(PyObject*, PyObject* args) {
    unsigned long long crc;
    Py_buffer b;
    if (!PyArg_ParseTuple(args, "Ky*", &crc, &b)) return nullptr;
    uint64_t out;
    Py_BEGIN_ALLOW_THREADS
    out = cst_crc64((uint64_t)crc, (const unsigned char*)b.buf, (size_t)b.len);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&b);
    return PyLong_FromUnsignedLongLong(out);
}

PyMethodDef methods[] = {
    {"crc64", py_crc64, METH_VARARGS,
     "crc64(crc, buffer) -> CRC-64/XZ of buffer, continuing from crc"},
    {"nonnull_mask", py_nonnull_mask, METH_VARARGS,
     "nonnull_mask(list) -> bytearray bool mask of non-None entries"},
    {"strtab_new", py_strtab_new, METH_VARARGS, ""},
    {"strtab_len", py_strtab_len, METH_VARARGS, ""},
    {"strtab_get_or_insert", py_strtab_get_or_insert, METH_VARARGS, ""},
    {"strtab_lookup", py_strtab_lookup, METH_VARARGS, ""},
    {"strtab_get_or_insert_batch", py_strtab_get_or_insert_batch, METH_VARARGS, ""},
    {"strtab_lookup_batch", py_strtab_lookup_batch, METH_VARARGS, ""},
    {"strtab_bytes_of", py_strtab_bytes_of, METH_VARARGS, ""},
    {"i64_new", py_i64_new, METH_VARARGS, ""},
    {"i64_len", py_i64_len, METH_VARARGS, ""},
    {"i64_get", py_i64_get, METH_VARARGS, ""},
    {"i64_put", py_i64_put, METH_VARARGS, ""},
    {"i64_del", py_i64_del, METH_VARARGS, ""},
    {"i64_lookup_batch", py_i64_lookup_batch, METH_VARARGS, ""},
    {"i64_put_batch", py_i64_put_batch, METH_VARARGS, ""},
    {"i64_get_or_assign_batch", py_i64_get_or_assign_batch, METH_VARARGS, ""},
    {"resp_parse", py_resp_parse, METH_VARARGS,
     "resp_parse(buf, pos, Arr, Bulk, Int, Simple, Err, nil[, max]) -> "
     "(msgs, new_pos, fallback)"},
    {"resp_encode", py_resp_encode, METH_VARARGS,
     "resp_encode(out, msg, Arr, Bulk, Int, Simple, Err, NilT, NoReplyT) "
     "-> appended? (False = caller must use the pure-Python encoder)"},
    {"intake_scan", py_intake_scan, METH_VARARGS,
     "intake_scan(buf, pos, Arr, Bulk, Int, Simple, Err, nil[, max_bulk, "
     "max_msgs]) -> (ops, payloads, new_pos)"},
    {"wire_pack_blobs", py_wire_pack_blobs, METH_VARARGS,
     "wire_pack_blobs(out, items) -> appended? (False = pure packer)"},
    {"wire_unpack_blobs", py_wire_unpack_blobs, METH_VARARGS,
     "wire_unpack_blobs(buf, pos, n) -> (blobs, new_pos) | None"},
    {"abi_stamp", py_abi_stamp, METH_NOARGS,
     "abi_stamp() -> sha256 over the sources and flags this module was "
     "built from"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "cst_ext",
    "Native staging tables (CPython binding)", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_cst_ext(void) { return PyModule_Create(&moduledef); }
