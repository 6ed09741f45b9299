#!/usr/bin/env python
"""Sustained mixed-workload serving soak.

One clock, every lifecycle mechanism at once, on the GPU at the
bench parity operating point (1M hard corpus, 3,072-bit codes, f16
payloads, adaptive decrypt budget):

  continuous query stream (windows of 256 from a 1,024-query pool)
  + periodic live inserts (capacity-padded scan state -> NO recompile)
  + deletes of the previous insert batch
  + ONE mid-run key rotation with the background migration daemon
    re-encrypting the corpus under live traffic

Housekeeping under the same clock:

  + mid-soak ``compact_storage`` while the query stream runs (the metadata
    compaction epoch + arena rewrite interacting with the capacity-padded
    scan state under live traffic)
  + a checkpoint (flush_all + table refresh + db-dir copy, with a live
    result snapshot) and, later windows in, a RESTORE of that checkpoint
    into a second facade in the same process — queried and verified
    id-identical against the snapshot — all while the primary keeps
    serving (the restore's compile/upload shows up as the window's
    latency blip, which is the point)
  + per-window p99 ART and a p99/p99.9 series in the summary

Per-window JSON rows (recall@10 / ART / p99 / q/s / key version / stale
count / mean decrypts) -> SOAK_OUT (default chiprun_out/soak.jsonl), plus a summary row
with recall drift and pre/post-rotation ART medians.

The soak's pass condition: recall drift ~ 0 across the rotation
epoch, ART stable once migration drains, compaction + checkpoint/restore
green under load with the restored facade query-identical to its snapshot.

Usage: python scripts/soak.py                # needs a GPU
Env: SOAK_S (timed seconds, default 660), SOAK_N (1_000_000), SOAK_D (128),
     SOAK_POOL (1024), SOAK_WINDOW (256), SOAK_INSERT_EVERY (4 windows),
     SOAK_INSERT_BATCH (128), SOAK_ROTATE_FRAC (0.4),
     SOAK_COMPACT_FRAC (0.62), SOAK_CKPT_FRAC (0.75),
     SOAK_RESTORE_FRAC (0.85)  (set any frac >= 1 to disable that event)
"""

import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import bench  # log + timing conventions (repo root)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.environ.get("SOAK_OUT",
                     os.path.join(ROOT, "chiprun_out", "soak.jsonl"))


def emit(row):
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(json.dumps(row) + "\n")
    print("ROW", json.dumps(row), flush=True)


def main():
    soak_s = float(os.environ.get("SOAK_S", 660))
    n = int(os.environ.get("SOAK_N", 1_000_000))
    d = int(os.environ.get("SOAK_D", 128))
    pool = int(os.environ.get("SOAK_POOL", 1024))
    window = int(os.environ.get("SOAK_WINDOW", 256))
    ins_every = int(os.environ.get("SOAK_INSERT_EVERY", 4))
    ins_batch = int(os.environ.get("SOAK_INSERT_BATCH", 128))
    rot_frac = float(os.environ.get("SOAK_ROTATE_FRAC", 0.4))
    compact_frac = float(os.environ.get("SOAK_COMPACT_FRAC", 0.62))
    ckpt_frac = float(os.environ.get("SOAK_CKPT_FRAC", 0.75))
    restore_frac = float(os.environ.get("SOAK_RESTORE_FRAC", 0.85))

    from fspann.utils.compile_cache import enable_compile_cache
    import jax

    devs = jax.devices()
    bench.log(f"devices: {devs}")
    if devs[0].platform != "gpu":
        bench.log(f"no GPU (JAX platform {devs[0].platform}) — refusing")
        sys.exit(2)
    platform = devs[0].device_kind
    enable_compile_cache()

    from fspann.api.system import ForwardSecureANNSystem
    from fspann.config import SystemConfig
    from fspann.crypto.rotation import BackgroundReencryption
    from fspann.io import groundtruth, synthetic

    base, queries = synthetic.lsh_hard_corpus(n, d, pool, seed=42)

    cfg = SystemConfig()
    cfg = dataclasses.replace(
        cfg,
        paper=dataclasses.replace(cfg.paper, tables=8, m=64),
        runtime=dataclasses.replace(
            cfg.runtime, routing_mode="scan", rerank_limit=2000,
            refinement_limit=56000, max_global_candidates=56000,
            probe_override=16, block_size=128,
            adaptive_decrypt_margin=40, storage_dtype="f16",
            encode_backend="cpu",
            # capacity headroom: every soak insert fills tombstoned
            # padding in place — no scan recompile under live traffic
            scan_capacity_rows=n + 16384),
        reencryption=dataclasses.replace(cfg.reencryption,
                                         background_enabled=False)).validate()

    work = tempfile.mkdtemp(prefix="fspann_soak_")
    try:
        s = ForwardSecureANNSystem(cfg, os.path.join(work, "db"), d,
                                   query_batch=64)
        t0 = time.perf_counter()
        s.index_stream(base, batch_size=100_000)
        s.finalize_for_search()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gtm = groundtruth.precompute(base, queries, k=100)
        bench.log(f"build {build_s:.0f}s, GT {time.perf_counter()-t0:.0f}s")

        # warmup/compile at window shape + one insert shape
        s.run_queries(queries[:window],
                      groundtruth.GroundtruthManager(gtm.gt[:window]),
                      base, ks=(10,))
        rngi = np.random.default_rng(777)
        warm_v = rngi.normal(size=(ins_batch, d)).astype(np.float32) * 3 + 60.0
        next_id = n
        s.insert_live(np.arange(next_id, next_id + ins_batch), warm_v)
        warm_ids = np.arange(next_id, next_id + ins_batch)
        next_id += ins_batch
        s.delete(warm_ids)
        s.profiler.clear_rows()

        emit({"step": "setup", "platform": platform, "n": n, "d": d,
              "build_s": round(build_s, 1), "soak_s": soak_s,
              "window": window, "insert_batch": ins_batch,
              "insert_every": ins_every, "capacity": n + 16384})

        bg = None
        rotated = False
        compacted = False
        checkpointed = False
        restored_ok = None
        ckpt_dir = os.path.join(work, "db_ckpt")
        ckpt_snapshot = None   # (ids, dists) on the check window at ckpt time
        check_qs = queries[:window]
        prev_ins: np.ndarray | None = None
        w = 0
        t_start = time.perf_counter()
        rows = []
        try:
            while True:
                t_rel = time.perf_counter() - t_start
                if t_rel >= soak_s:
                    break
                ev = {}
                if not compacted and t_rel >= compact_frac * soak_s:
                    # housekeeping under load: arena rewrite + metadata
                    # compaction epoch while the stream keeps coming
                    t1 = time.perf_counter()
                    rep = s.compact_storage()
                    compacted = True
                    ev["event"] = "compact_storage"
                    ev["compact_s"] = round(time.perf_counter() - t1, 2)
                    ev["compact_bytes_freed"] = int(rep["bytes_freed"])
                if not checkpointed and t_rel >= ckpt_frac * soak_s:
                    # checkpoint: snapshot live results on the check window,
                    # flush, copy the db dir.  No mutation between snapshot
                    # and copy -> a later restore must be id-identical.
                    t1 = time.perf_counter()
                    toks = s.tokens.create_batch(check_qs, 10)
                    res = s.query_service.search_batches([toks])[0]
                    ckpt_snapshot = (np.array(res.ids), np.array(res.distances))
                    s.flush_all()
                    shutil.copytree(os.path.join(work, "db"), ckpt_dir)
                    checkpointed = True
                    ev["event"] = "checkpoint"
                    ev["checkpoint_s"] = round(time.perf_counter() - t1, 2)
                if checkpointed and restored_ok is None \
                        and t_rel >= restore_frac * soak_s:
                    # restore the checkpoint into a SECOND facade in-process
                    # (scan-state compile + HBM upload land inside the soak
                    # clock) and verify query-identity vs the snapshot
                    t1 = time.perf_counter()
                    s2 = ForwardSecureANNSystem(cfg, ckpt_dir, d,
                                                query_batch=64)
                    n_restored = s2.restore_index_from_disk()
                    toks2 = s2.tokens.create_batch(check_qs, 10)
                    res2 = s2.query_service.search_batches([toks2])[0]
                    restored_ok = bool(
                        np.array_equal(ckpt_snapshot[0], res2.ids)
                        and np.allclose(ckpt_snapshot[1], res2.distances))
                    s2.store.close()
                    del s2, toks2, res2
                    ev["event"] = "restore_verify"
                    ev["restore_s"] = round(time.perf_counter() - t1, 2)
                    ev["restored_rows"] = int(n_restored)
                    ev["restore_query_identical"] = restored_ok
                if not rotated and t_rel >= rot_frac * soak_s:
                    rv = s.rotation.force_rotate_now()
                    bg = BackgroundReencryption(s.rotation, interval_s=0.05,
                                                batch=25_000,
                                                load_shed_qps=1e9)
                    bg.start()
                    rotated = True
                    ev["event"] = f"rotate->v{rv}+bg_migration"
                if w % ins_every == 0:
                    if prev_ins is not None:
                        s.delete(prev_ins)
                        ev["deleted"] = len(prev_ins)
                    v = rngi.normal(size=(ins_batch, d)).astype(np.float32) \
                        * 3 + 60.0
                    ids = np.arange(next_id, next_id + ins_batch)
                    s.insert_live(ids, v)
                    next_id += ins_batch
                    prev_ins = ids
                    ev["inserted"] = ins_batch
                lo = (w * window) % pool
                qs = queries[lo:lo + window]
                gslice = groundtruth.GroundtruthManager(
                    gtm.gt[lo:lo + window])
                s.profiler.clear_rows()
                t1 = time.perf_counter()
                agg = s.run_queries(qs, gslice, base, ks=(10,))
                dt = time.perf_counter() - t1
                prow = [r for r in s.profiler.rows if r.k == 10]
                dec = (sum(r.cand_decrypted for r in prow) / max(len(prow), 1))
                stale = int(len(s.store.meta.stale_ids(s.km.current_version)))
                row = {"w": w, "t_s": round(t_rel, 1),
                       "qps": round(window / dt, 1),
                       "art_ms": round(agg.mean_art_ms, 2),
                       "p99_art_ms": round(agg.p99_art_ms, 2),
                       "recall_at_10": round(agg.recall_at_k[10], 4),
                       "decrypts": round(dec, 0),
                       "key_version": s.km.current_version,
                       "stale": stale,
                       "live_extra": 0 if prev_ins is None
                       else int(len(prev_ins))}
                row.update(ev)
                rows.append(row)
                emit(row)
                w += 1
        finally:
            if bg is not None:
                bg.stop()

        r10 = [r["recall_at_10"] for r in rows]
        arts = [r["art_ms"] for r in rows]
        rot_w = next((r["w"] for r in rows if "event" in r), None)
        pre = [a for r, a in zip(rows, arts)
               if rot_w is None or r["w"] < rot_w]
        post_drain = [a for r, a in zip(rows, arts)
                      if rot_w is not None and r["w"] > rot_w
                      and r["stale"] == 0]
        med = lambda xs: round(float(np.median(xs)), 2) if xs else None
        p99s = [r["p99_art_ms"] for r in rows]
        emit({"step": "summary", "windows": len(rows),
              "total_queries": len(rows) * window,
              "wall_s": round(time.perf_counter() - t_start, 1),
              "recall_min": min(r10), "recall_max": max(r10),
              "recall_drift": round(max(r10) - min(r10), 4),
              "art_median_pre_rotation_ms": med(pre),
              "art_median_post_migration_ms": med(post_drain),
              "p99_median_ms": med(p99s), "p99_worst_ms": max(p99s),
              "compacted": compacted, "checkpointed": checkpointed,
              "restore_query_identical": restored_ok,
              "inserts_total": int(next_id - n),
              "final_stale": rows[-1]["stale"] if rows else None})
        s.shutdown()
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
