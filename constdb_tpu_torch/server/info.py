"""INFO command: Redis-style sections over node + process + device metrics
(the port's copy).

Capability parity with the reference's stats layer (reference src/stats.rs:
global atomics folded into `Metrics`, INFO sections Server/Clients/Memory/
Stats/Replication/CPU/Keyspace, stats.rs:287-305).  The reference's
allocator-integrated memory gauge (jemalloc wrapper, lib.rs:63-78) maps here
to host RSS plus the card's memory accounting.

Differences from the JAX package's INFO: the device lines read the
engine's torch device (`torch.cuda.memory_allocated`, `mem_get_info`, the
device name, and the kernel launch counts of ops/kernels.py) and are left
out when the engine is not on a card; there is no `engine_degraded` (the
port's engine factory never falls back).  Every other section and field
keeps the reference's name.  One section is the port's own and shows only
when asked by name, `INFO trace`: the engine's flushes by cause, the
key-scoped barriers that needed none, the steady rounds the native
planner ran and those left on Python by cause, and Python's collector
(utils/trace.py).
"""

from __future__ import annotations

import os
import resource
import sys
import time

import numpy as np
import torch

from ..crdt import semantics as S
from ..engine.base import FLUSH_CAUSES, MICRO_PYTHON_CAUSES
from ..resp.message import Bulk
from ..utils import trace
from .commands import CMD_READONLY, register


def _section_server(node, out):
    out.append(("node_id", node.node_id))
    out.append(("node_alias", node.alias))
    app = getattr(node, "app", None)
    if app is not None:
        out.append(("tcp_addr", app.advertised_addr))
    out.append(("process_id", os.getpid()))
    up = time.time() - (node.stats.start_time or time.time())
    out.append(("uptime_in_seconds", int(up)))
    out.append(("current_uuid", node.hlc.current))


def _section_clients(node, out):
    out.append(("connected_clients", node.stats.current_clients))
    out.append(("total_connections_received", node.stats.connections_accepted))
    # client-assisted caching (server/tracking.py): live tracked
    # subscriptions on this node
    tr = getattr(node, "tracking", None)
    out.append(("tracking_clients", tr.n_clients if tr is not None else 0))


def _current_rss_bytes():
    """CURRENT resident set size from /proc/self/status VmRSS (the
    reference reports live allocator bytes, stats.rs:253-260 — a gauge
    that can go DOWN; `ru_maxrss` is the high-water mark and never does).
    Falls back to the peak on non-procfs platforms."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return _peak_rss_bytes()


def _peak_rss_bytes():
    # ru_maxrss is KB on Linux but BYTES on Darwin
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_maxrss if sys.platform == "darwin" else ru.ru_maxrss * 1024


def _section_memory(node, out):
    rss = _current_rss_bytes()
    # governed accounting (server/overload.py): the byte total the
    # maxmemory watermarks are enforced against — store live rows +
    # blob/tensor payloads + repl log + device pools + applier buffers.
    # A shard-per-core node's workers each govern their slice; the
    # parent sums their last-acked gauges (serve_shard<i>_used_bytes).
    plane = getattr(node, "serve_plane", None)
    if plane is not None:
        x = node.stats.extra
        used = node.governor.used_memory() + sum(
            x.get(f"serve_shard{i}_used_bytes", 0)
            for i in range(plane.n_shards))
    else:
        used = node.governor.used_memory()
    out.append(("used_memory", used))
    out.append(("maxmemory", node.governor.maxmemory))
    out.append(("maxmemory_soft", node.governor.soft_bytes))
    out.append(("overload_state", node.governor.state_name))
    out.append(("used_memory_rss", rss))
    # ru_maxrss lags the live gauge by kernel sampling granularity; clamp
    # so the reported peak is never below the reported current
    out.append(("used_memory_peak", max(_peak_rss_bytes(), rss)))
    _device_lines(node, out)
    # store-exact accounting (reference src/lib.rs:63-78 exposes the
    # allocator gauge; the columnar numeric plane is exactly countable)
    for name, val in node.ks.memory_report().items():
        out.append((f"store_{name}", val))


def _device_lines(node, out):
    """The card's memory, its name, and the kernels launched so far —
    only for an engine on a CUDA device."""
    dev = getattr(node.engine, "device", None)
    if not isinstance(dev, torch.device) or dev.type != "cuda":
        return
    from ..ops import kernels
    free, total = torch.cuda.mem_get_info(dev)
    out.append(("device_mem_allocated", torch.cuda.memory_allocated(dev)))
    out.append(("device_mem_peak", torch.cuda.max_memory_allocated(dev)))
    out.append(("device_mem_free", free))
    out.append(("device_mem_total", total))
    out.append(("device", str(dev)))
    out.append(("device_name", torch.cuda.get_device_name(dev)))
    out.append(("device_kernel_launches", ",".join(
        f"{k}={v}" for k, v in sorted(kernels.LAUNCHES.items()))))


def _section_stats(node, out):
    st = node.stats
    out.append(("total_commands_processed", st.cmds_processed))
    out.append(("total_commands_replicated", st.cmds_replicated))
    out.append(("total_net_input_bytes", st.net_in_bytes))
    out.append(("total_net_output_bytes", st.net_out_bytes))
    out.append(("repl_net_input_bytes", st.repl_in_bytes))
    out.append(("repl_net_output_bytes", st.repl_out_bytes))
    out.append(("repl_frames_coalesced", st.repl_frames_coalesced))
    out.append(("repl_coalesce_flushes", st.repl_coalesce_flushes))
    out.append(("repl_apply_barriers", st.repl_apply_barriers))
    # batch wire protocol (replica/wire.py REPLBATCH): aggregated
    # steady-state stream bytes out, group-encoded runs sent/received
    # (with the op frames they covered), and receiver-side payload
    # decode failures — each one pins that peer to per-frame delivery
    out.append(("repl_wire_bytes_out", st.repl_wire_bytes_out))
    out.append(("repl_wire_batches_out", st.repl_wire_batches_out))
    out.append(("repl_wire_batch_frames_out",
                st.repl_wire_batch_frames_out))
    out.append(("repl_wire_batches_in", st.repl_wire_batches_in))
    out.append(("repl_wire_batch_frames_in", st.repl_wire_batch_frames_in))
    out.append(("repl_wire_demotions", st.repl_wire_demotions))
    # broadcast plane (replica/encode_cache.py + CAP_COMPRESS): push-
    # loop fan-out reuse of published wire encodings (hits/misses over
    # drained runs, live resident bytes), and the outbound stream
    # compression's raw-vs-wire ratio (1.0 = nothing compressed yet)
    out.append(("repl_encode_cache_hits", st.repl_encode_cache_hits))
    out.append(("repl_encode_cache_misses", st.repl_encode_cache_misses))
    wire_cache = getattr(node, "wire_cache", None)
    out.append(("repl_encode_cache_bytes",
                wire_cache.used_bytes() if wire_cache is not None else 0))
    out.append(("repl_compress_ratio",
                round(st.repl_comp_raw_bytes / st.repl_comp_wire_bytes, 3)
                if st.repl_comp_wire_bytes else 1.0))
    # anti-entropy resyncs this node pushed: digest-negotiated deltas
    # vs full snapshots (replica/link.py; the demotion counter rides
    # `extra` as repl_delta_demotions, with shard ids in the log)
    out.append(("repl_delta_syncs", st.repl_delta_syncs))
    out.append(("repl_delta_bytes", st.repl_delta_bytes))
    out.append(("repl_full_syncs", st.repl_full_syncs))
    out.append(("repl_digest_rounds", st.repl_digest_rounds))
    # replica-link connections re-established after a drop (the backoff
    # ladder's success count — per-peer state/attempts ride the
    # Replication section's repl_link_state / replica<i> rows)
    out.append(("repl_reconnects", st.repl_reconnects))
    # client-serving coalescing (server/serve.py), mirroring the repl_*
    # trio above; the latency percentiles come from the sampled
    # plan→land ring (CONSTDB_TORCH_SERVE_LAT_SAMPLE)
    out.append(("serve_msgs_coalesced", st.serve_msgs_coalesced))
    out.append(("serve_flushes", st.serve_flushes))
    out.append(("serve_barriers", st.serve_barriers))
    # the coalesced read plane (server/serve.py read planner +
    # server/read_cache.py).  Counters are node totals — a sharded node
    # folds worker deltas into them per ack (server/serve_shards.py) —
    # while the bytes gauge sums the parent cache with the per-shard
    # worker gauges (a shard worker's cache lives in its process)
    out.append(("serve_reads_coalesced", st.serve_reads_coalesced))
    out.append(("serve_read_flushes", st.serve_read_flushes))
    # native intake stage (native/intake.cpp + server/io.py): chunks the
    # C scanner split+classified, and the frames it emitted as opcodes.
    # The port's intake is always native.
    out.append(("native_intake_chunks", st.native_intake_chunks))
    out.append(("native_intake_msgs", st.native_intake_msgs))
    rc = node.read_cache
    x = st.extra
    rc_bytes = rc.used_bytes() + sum(
        v for k, v in x.items()
        if k.startswith("serve_shard") and k.endswith("_cache_bytes"))
    out.append(("read_cache_hits", rc.hits))
    out.append(("read_cache_misses", rc.misses))
    out.append(("read_cache_bytes", rc_bytes))
    out.append(("read_cache_invalidations", rc.invalidations))
    # overload governance (server/overload.py): client writes shed at
    # the maxmemory soft watermark, hard-watermark reclaim sweeps,
    # slow-reader disconnects at the outbuf cap, and push loops paused
    # on a full per-peer replication window
    out.append(("oom_shed_writes", st.oom_shed_writes))
    out.append(("oom_hard_reclaims", st.oom_hard_reclaims))
    out.append(("client_outbuf_disconnects", st.client_outbuf_disconnects))
    out.append(("repl_window_pauses", st.repl_window_pauses))
    # client-assisted caching (server/tracking.py): invalidation keys
    # pushed to tracked connections, the push frames carrying them, and
    # over-outbuf trackers demoted to untracked (each one a loud
    # disconnect — the reconnect-flush law restores correctness)
    out.append(("tracking_invalidations_sent", st.tracking_invalidations_sent))
    out.append(("tracking_pushes", st.tracking_pushes))
    out.append(("tracking_demotions", st.tracking_demotions))
    if st.serve_lat:
        lat_ms = np.fromiter(st.serve_lat, dtype=np.float64) * 1000.0
        out.append(("serve_lat_p50_ms",
                    round(float(np.percentile(lat_ms, 50)), 3)))
        out.append(("serve_lat_p99_ms",
                    round(float(np.percentile(lat_ms, 99)), 3)))
    out.append(("merge_batches", st.merges))
    out.append(("merge_rows", st.merge_rows))
    out.append(("merge_seconds_total", round(st.merge_secs, 6)))
    if st.merges and st.merge_secs:
        out.append(("merge_rows_per_sec",
                    int(st.merge_rows / st.merge_secs)))
    out.append(("flush_seconds_total", round(st.flush_secs, 6)))
    fam = getattr(node.engine, "family_secs", None)
    if fam:
        for name, secs in sorted(fam.items()):
            out.append((f"merge_{name}_seconds", round(secs, 6)))
    folds = getattr(node.engine, "folds", None)
    if folds is not None:
        out.append(("merge_folds", folds))
    rebuilds = getattr(node.engine, "mirror_rebuilds", None)
    if rebuilds is not None:
        for name, cnt in sorted(rebuilds.items()):
            out.append((f"mirror_rebuilds_{name}", cnt))
    # device-transfer accounting (engine/cuda.py): cumulative host<->device
    # bytes, steady-state micro rounds merged in place against resident
    # planes vs routed to the host fallback, and the dirty-row flush
    # downloads vs their whole-plane equivalent — the residency metrics
    # the bench legs and the v5e acceptance round read
    if getattr(node.engine, "bytes_h2d", None) is not None:
        out.append(("dev_upload_bytes", node.engine.bytes_h2d))
        out.append(("dev_download_bytes", node.engine.bytes_d2h))
    for gauge in ("dev_rounds_resident", "host_micro_rounds",
                  "flush_rows_downloaded", "flush_rows_full_equiv"):
        v = getattr(node.engine, gauge, None)
        if v is not None:
            out.append((gauge, v))
    # tensor-register family (crdt/tensor.py): merge routing counts +
    # device payload-pool residency; per-strategy merge wins and the
    # host payload gauge live in the Keyspace section
    for gauge in ("tns_dev_rows", "tns_host_rows"):
        v = getattr(node.engine, gauge, None)
        if v is not None:
            out.append((gauge, v))
    v = getattr(node.engine, "_tns_bytes", None)
    if v is not None:
        out.append(("tns_pool_bytes", v))
    out.append(("engine", node.engine.name))
    out.append(("gc_freed", st.gc_freed))
    for k, v in sorted(st.extra.items()):
        out.append((k, v))


def _section_cpu(node, out):
    """(reference src/stats.rs CPU section)"""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out.append(("used_cpu_user", round(ru.ru_utime, 3)))
    out.append(("used_cpu_sys", round(ru.ru_stime, 3)))
    rc = resource.getrusage(resource.RUSAGE_CHILDREN)
    out.append(("used_cpu_user_children", round(rc.ru_utime, 3)))
    out.append(("used_cpu_sys_children", round(rc.ru_stime, 3)))
    try:
        out.append(("voluntary_ctx_switches", ru.ru_nvcsw))
        out.append(("involuntary_ctx_switches", ru.ru_nivcsw))
    except AttributeError:  # pragma: no cover
        pass


def _section_durability(node, out):
    """Durable op log (persist/oplog.py): enablement, size, group-commit
    health, compaction, and what the last boot recovery found."""
    lg = getattr(node, "oplog", None)
    out.append(("aof_enabled", int(lg is not None)))
    x = node.stats.extra
    if lg is None:
        src = x.get("aof_recovery_source")
        if src:  # recovered once, then disabled mid-run (tests)
            out.append(("aof_recovery_source", src))
        return
    out.append(("aof_fsync_policy", lg.policy))
    out.append(("aof_size_bytes", lg.size_bytes()))
    out.append(("aof_base_size_bytes", lg.base_size))
    out.append(("aof_generation", lg.generation))
    out.append(("aof_segments", lg.n_segments))
    out.append(("aof_appended_ops", lg.appended_ops))
    out.append(("aof_spliced_batches", lg.spliced_batches))
    out.append(("aof_encoded_batches", lg.encoded_batches))
    out.append(("aof_fsyncs", lg.fsyncs))
    out.append(("aof_last_fsync_lag_ms", lg.last_fsync_lag_ms))
    out.append(("aof_rewrites", lg.rewrites))
    out.append(("aof_rewrite_in_progress", int(lg._rewriting)))
    out.append(("aof_tail_truncated", lg.tail_truncated))
    out.append(("aof_pending_floor", lg.durable_floor() or 0))
    out.append(("aof_recovery_source",
                x.get("aof_recovery_source", "empty")))
    out.append(("aof_recovered_ops", x.get("aof_recovered_ops", 0)))


def _section_recovery(node, out):
    """Fast-restart observability (persist/oplog.py): how the last boot
    recovery ran (wall time, landing strategy, replay concurrency) and
    the incremental-checkpoint cut the NEXT restart will replay from."""
    x = node.stats.extra
    out.append(("recovery_wall_s", x.get("recovery_wall_s", 0)))
    out.append(("recovery_mode", x.get("recovery_mode", "")))
    out.append(("recovery_shards", x.get("recovery_shards", 0)))
    out.append(("recovery_merge_rounds",
                x.get("recovery_merge_rounds", 0)))
    if "digest_warm_s" in x:
        out.append(("digest_warm_s", x["digest_warm_s"]))
    if "recovery_restore_to" in x:
        out.append(("recovery_restore_to", x["recovery_restore_to"]))
        out.append(("recovery_restore_skipped",
                    x.get("recovery_restore_skipped", 0)))
    lg = getattr(node, "oplog", None)
    if lg is not None:
        out.append(("checkpoint_secs", lg.checkpoint_secs))
        out.append(("checkpoint_last_uuid", lg.checkpoint_uuid))
        out.append(("checkpoint_age_s",
                    round(time.time() - lg.checkpoint_ts, 3)
                    if lg.checkpoint_ts else -1))


def _section_replication(node, out):
    peers = node.replicas.describe() if node.replicas else []
    live = [m for _, m in peers if m.alive]
    out.append(("connected_replicas", sum(
        1 for m in live if m.link is not None and m.link.connected)))
    out.append(("known_replicas", len(peers)))
    rl = node.repl_log
    out.append(("repl_log_entries", len(rl)))
    out.append(("repl_log_bytes", rl.total_bytes))
    out.append(("repl_log_first_uuid", rl.first_uuid))
    out.append(("repl_log_last_uuid", rl.last_uuid))
    horizon = node.replicas.min_uuid() if node.replicas else None
    out.append(("gc_horizon_uuid", horizon if horizon is not None else ""))
    states = []
    for i, (addr, m) in enumerate(peers):
        link = m.link
        if link is not None and getattr(link, "state", None) is not None:
            # live link: the backoff ladder's own view (connected /
            # dialing / backoff:N / suspended — replica/link.py)
            state = link.state
        else:
            state = "alive" if m.alive else "forgotten"
        states.append(f"{addr}={state}")
        recon = getattr(link, "reconnects", 0) if link is not None else 0
        win = getattr(link, "win_unacked", 0) if link is not None else 0
        win_p = int(getattr(link, "win_paused", False)) \
            if link is not None else 0
        # broadcast-plane per-peer wire observability (replica/link.py):
        # bytes written to this peer, the negotiated compression's
        # raw/wire ratio on its stream, encode-cache reuse counts
        bytes_out = getattr(link, "bytes_out", 0) if link is not None \
            else 0
        craw = getattr(link, "comp_raw_bytes", 0) if link is not None \
            else 0
        cwire = getattr(link, "comp_wire_bytes", 0) if link is not None \
            else 0
        ratio = round(craw / cwire, 3) if cwire else 1.0
        hits = getattr(link, "cache_hits", 0) if link is not None else 0
        misses = getattr(link, "cache_misses", 0) \
            if link is not None else 0
        out.append((f"replica{i}",
                    f"addr={addr},node_id={m.node_id},state={state},"
                    f"reconnects={recon},"
                    f"win_unacked={win},win_paused={win_p},"
                    f"bytes_out={bytes_out},compressed_ratio={ratio},"
                    f"cache_hits={hits},cache_misses={misses},"
                    f"i_sent={m.uuid_i_sent},i_acked={m.uuid_i_acked},"
                    f"he_sent={m.uuid_he_sent},he_acked={m.uuid_he_acked}"))
    if states:
        out.append(("repl_link_state", ";".join(states)))


def _section_keyspace(node, out):
    plane = getattr(node, "serve_plane", None)
    if plane is not None:
        # shard-per-core node: the serve workers hold the keyspace; the
        # per-shard gauges come from the latest worker acks (slightly
        # stale by at most one in-flight chunk), so imbalance across the
        # shard map is observable without a worker round-trip
        x = node.stats.extra
        per = [x.get(f"serve_shard{i}_keys", 0)
               for i in range(plane.n_shards)]
        out.append(("keys", sum(per)))
        out.append(("serve_shards", plane.n_shards))
        for i, n in enumerate(per):
            out.append((f"shard{i}_keys", n))
        return
    ks = node.ks
    n = ks.keys.n
    out.append(("keys", n))
    if n:
        counts = np.bincount(ks.keys.enc[:n].astype(np.int64), minlength=16)
        out.append(("counters", int(counts[S.ENC_COUNTER])))
        out.append(("registers", int(counts[S.ENC_BYTES])))
        out.append(("dicts", int(counts[S.ENC_DICT])))
        out.append(("sets", int(counts[S.ENC_SET])))
        out.append(("multivalues", int(counts[S.ENC_MV])))
        out.append(("lists", int(counts[S.ENC_LIST])))
        out.append(("tensors", int(counts[S.ENC_TENSOR])))
    out.append(("counter_slots", ks.cnt.n))
    out.append(("element_rows", ks.el.n - ks.el_dead))
    out.append(("tensor_slots", ks.tns.n))
    out.append(("tensor_payload_bytes", ks.tns_bytes))
    for name, cnt in sorted(ks.tns_merges_by_strat.items()):
        out.append((f"tensor_merges_{name.replace('-', '_')}", cnt))
    out.append(("pending_tombstones", len(ks.garbage)))


def _section_cluster(node, out) -> None:
    """Slot ownership + migration observability (constdb_tpu_torch/
    cluster).  cluster_enabled:0 is the whole story on a non-cluster
    node — the section shape stays stable either way, so dashboards need
    no probing."""
    cl = node.cluster
    if cl is None:
        out.append(("cluster_enabled", 0))
        return
    out.extend(cl.info_pairs())


SECTIONS = {
    "server": _section_server,
    "clients": _section_clients,
    "memory": _section_memory,
    "stats": _section_stats,
    "cpu": _section_cpu,
    "durability": _section_durability,
    "recovery": _section_recovery,
    "replication": _section_replication,
    "keyspace": _section_keyspace,
    "cluster": _section_cluster,
}


def _section_trace(node, out) -> None:
    """The program's counters (utils/trace.py): the engine's flushes that
    ran, by cause (engine/base.py FLUSH_CAUSES), the key-scoped barriers
    that needed none, the steady rounds of coalesced batches the native
    planner ran and those that stayed on Python, by cause
    (MICRO_PYTHON_CAUSES), and Python's collector, process-wide: its
    passes and seconds."""
    spans = getattr(node.engine, "spans", None)

    def value(name):
        return 0 if spans is None else spans.value(name)
    for cause in FLUSH_CAUSES:
        out.append((f"engine_flushes_{cause}",
                    value(f"engine.flushes.{cause}")))
    out.append(("engine_barriers_clean", value("engine.barriers_clean")))
    out.append(("engine_micro_planned", value("engine.micro_planned")))
    for cause in MICRO_PYTHON_CAUSES:
        out.append((f"engine_micro_python_{cause}",
                    value(f"engine.micro_python.{cause}")))
    t = trace.gc_totals()
    out.append(("gc_collections", t["gc.collections"]))
    out.append(("gc_seconds_total", round(t["gc.seconds"], 6)))


# sections INFO shows only when asked by name (as Redis's commandstats)
ON_REQUEST = {"trace": _section_trace}


@register("info", CMD_READONLY)
def info_command(node, ctx, args):
    """(reference stats.rs:287-305)"""
    want = args.next_str().lower() if args.has_more else None
    lines = []
    for name, fn in (ON_REQUEST if want in ON_REQUEST else SECTIONS).items():
        if want is not None and name != want:
            continue
        lines.append(f"# {name.capitalize()}")
        rows: list = []
        fn(node, rows)
        lines.extend(f"{k}:{v}" for k, v in rows)
        lines.append("")
    return Bulk("\r\n".join(lines).encode())
