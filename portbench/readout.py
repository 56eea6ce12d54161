"""The program's keyspace read back in the reference's state form.

Runs after the node's final flush, when the host keyspace holds the
merged state.  Reads the store's columns and bytes lists and copies them;
it computes nothing the reference computes.
"""

from __future__ import annotations

import numpy as np


def _bytes_col(items: list) -> tuple:
    """A bytes-or-None list as (has, numpy bytes)."""
    if not items:
        return np.zeros(0, bool), np.zeros(0, "S1")
    obj = np.array(items, dtype=object)
    has = obj != None  # noqa: E711 (elementwise)
    if not has.any():
        return has, np.zeros(len(items), "S1")
    return has, np.where(has, obj, b"").astype(np.bytes_)


def keyspace_state(ks) -> dict:
    """-> the state form of portbench/reference/__init__.py."""
    n, c, e = ks.keys.n, ks.cnt.n, ks.el.n
    k = ks.keys
    st = {"key": np.array(ks.key_bytes[:n], dtype=np.bytes_)}
    for name, col in (("enc", "enc"), ("ct", "ct"), ("mt", "mt"),
                      ("dt", "dt"), ("expire", "expire"), ("reg_t", "rv_t"),
                      ("reg_node", "rv_node"), ("cnt_sum", "cnt_sum")):
        st[name] = np.array(getattr(k, col)[:n], dtype=np.int64)
    st["reg_has"], st["reg_val"] = _bytes_col(ks.reg_val[:n])
    for name, col in (("c_key", "kid"), ("c_node", "node"), ("c_val", "val"),
                      ("c_uuid", "uuid"), ("c_base", "base"),
                      ("c_base_t", "base_t")):
        st[name] = np.array(getattr(ks.cnt, col)[:c], dtype=np.int64)
    for name, col in (("e_key", "kid"), ("e_add_t", "add_t"),
                      ("e_add_node", "add_node"), ("e_del_t", "del_t")):
        st[name] = np.array(getattr(ks.el, col)[:e], dtype=np.int64)
    st["e_member"] = np.array(ks.el_member[:e], dtype=np.bytes_)
    st["e_has"], st["e_val"] = _bytes_col(ks.el_val[:e])
    return st
