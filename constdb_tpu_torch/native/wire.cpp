// Native REPLBATCH blob columns (replica/wire.py hot loops).
//
// The port's own copy of the reference package's native/wire.cpp.
//
// The columnar wire codec's int columns decode with one np.frombuffer,
// but the BLOB columns (keys, register values, element members) pay a
// per-row Python loop on both sides: a fromiter + join on the pusher's
// _pack_blobs, a slice loop on the receiver's _Reader.blobs.  These two
// move here; layout is byte-identical to the Python reference (one width
// byte + little-endian lengths with the width's max value as the None
// sentinel + concatenated payloads).
//
// Both entry points DECLINE rather than raise on anything off the happy
// path — a non-list input, a non-bytes item, an over-wide blob, a bad
// width byte, truncation — returning False/None so the caller falls
// through to the pure-Python path, which either handles the shape or
// raises its own _PatternError/WireFormatError with the reference
// message.  Error behavior therefore never diverges; only the clean-path
// cycles move.  crc validation stays in replica/wire.py (_decode): the
// corruption→demotion accounting is receiver-side Python either way.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstring>

namespace wire {

// little-endian length write for w in {1,2,4}
inline void put_len(char* p, int w, unsigned long long v) {
    for (int i = 0; i < w; i++) p[i] = (char)((v >> (8 * i)) & 0xff);
}

inline unsigned long long get_len(const unsigned char* p, int w) {
    unsigned long long v = 0;
    for (int i = 0; i < w; i++) v |= (unsigned long long)p[i] << (8 * i);
    return v;
}

}  // namespace wire

// wire_pack_blobs(out_bytearray, items_list) -> True (appended) | False
// (decline: caller runs the pure packer).
static PyObject* py_wire_pack_blobs(PyObject*, PyObject* args) {
    PyObject *out, *items;
    if (!PyArg_ParseTuple(args, "OO", &out, &items)) return nullptr;
    if (!PyByteArray_CheckExact(out) || !PyList_CheckExact(items))
        Py_RETURN_FALSE;
    Py_ssize_t n = PyList_GET_SIZE(items);
    long long mx = 0;
    unsigned long long total = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* it = PyList_GET_ITEM(items, i);
        if (it == Py_None) continue;
        if (!PyBytes_CheckExact(it)) Py_RETURN_FALSE;
        Py_ssize_t ln = PyBytes_GET_SIZE(it);
        if (ln > mx) mx = ln;
        total += (unsigned long long)ln;
    }
    int w;
    if (mx < 0xff) w = 1;
    else if (mx < 0xffff) w = 2;
    else if (mx < 0xffffffffLL) w = 4;
    else Py_RETURN_FALSE;  // pure packer raises "blob too large"
    const unsigned long long sentinel = (1ULL << (8 * w)) - 1;
    Py_ssize_t old = PyByteArray_GET_SIZE(out);
    if (PyByteArray_Resize(out, old + 1 + n * w + (Py_ssize_t)total))
        return nullptr;
    char* p = PyByteArray_AS_STRING(out) + old;
    *p++ = (char)w;
    char* lens = p;
    char* pay = p + n * w;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* it = PyList_GET_ITEM(items, i);
        if (it == Py_None) {
            wire::put_len(lens + i * w, w, sentinel);
            continue;
        }
        Py_ssize_t ln = PyBytes_GET_SIZE(it);
        wire::put_len(lens + i * w, w, (unsigned long long)ln);
        memcpy(pay, PyBytes_AS_STRING(it), (size_t)ln);
        pay += ln;
    }
    Py_RETURN_TRUE;
}

// wire_unpack_blobs(buf, pos, n) -> (list, new_pos) | None (decline: the
// pure reader re-runs the column and raises the reference error).
static PyObject* py_wire_unpack_blobs(PyObject*, PyObject* args) {
    Py_buffer view;
    Py_ssize_t pos, n;
    if (!PyArg_ParseTuple(args, "y*nn", &view, &pos, &n)) return nullptr;
    const unsigned char* b = (const unsigned char*)view.buf;
    const Py_ssize_t len = view.len;
    if (n < 0 || pos < 0 || pos + 1 > len) goto decline;
    {
        int w = b[pos];
        if (w != 1 && w != 2 && w != 4) goto decline;
        Py_ssize_t lens_at = pos + 1;
        if (n > (len - lens_at) / w) goto decline;
        Py_ssize_t blob_at = lens_at + n * w;
        const unsigned long long sentinel = (1ULL << (8 * w)) - 1;
        unsigned long long total = 0;
        for (Py_ssize_t i = 0; i < n; i++) {
            unsigned long long ln = wire::get_len(b + lens_at + i * w, w);
            if (ln != sentinel) total += ln;
        }
        if (total > (unsigned long long)(len - blob_at)) goto decline;
        PyObject* lst = PyList_New(n);
        if (!lst) goto fail;
        Py_ssize_t bp = blob_at;
        for (Py_ssize_t i = 0; i < n; i++) {
            unsigned long long ln = wire::get_len(b + lens_at + i * w, w);
            PyObject* item;
            if (ln == sentinel) {
                item = Py_None;
                Py_INCREF(item);
            } else {
                item = PyBytes_FromStringAndSize((const char*)b + bp,
                                                 (Py_ssize_t)ln);
                if (!item) {
                    Py_DECREF(lst);
                    goto fail;
                }
                bp += (Py_ssize_t)ln;
            }
            PyList_SET_ITEM(lst, i, item);
        }
        PyBuffer_Release(&view);
        return Py_BuildValue("(Nn)", lst, bp);
    }
decline:
    PyBuffer_Release(&view);
    Py_RETURN_NONE;
fail:
    PyBuffer_Release(&view);
    return nullptr;
}
