#!/usr/bin/env python
"""Key-rotation epoch workload (BASELINE.json config 4): mixed-version
ciphertexts, lazy re-encryption DURING live queries, recall stability
across rotations.

Phases:
  1. steady      — baseline throughput/recall
  2. rotate      — force-rotate (keys only; index untouched)
  3. mixed       — queries against mixed-version ciphertexts
  4. background  — queries while the background re-encryption daemon
                   migrates the corpus underneath
  5. migrated    — selective re-encryption of all touched ids, then verify
                   recall + result equality vs phase 1

Prints one JSON line per phase.  Env: EPOCH_N (200k), EPOCH_D (128),
EPOCH_Q (192), EPOCH_MODE (scan|probe).
"""
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402


def main():
    n = int(os.environ.get("EPOCH_N", 200_000))
    d = int(os.environ.get("EPOCH_D", 128))
    q = int(os.environ.get("EPOCH_Q", 192))
    mode = os.environ.get("EPOCH_MODE", "scan")

    from fspann.api.system import ForwardSecureANNSystem
    from fspann.config import SystemConfig
    from fspann.io import groundtruth, synthetic

    base, queries = synthetic.lsh_hard_corpus(n, d, q, seed=42)
    cfg = SystemConfig()
    cfg = dataclasses.replace(
        cfg,
        paper=dataclasses.replace(cfg.paper, tables=8),
        runtime=dataclasses.replace(
            cfg.runtime, routing_mode=mode, rerank_limit=2000,
            refinement_limit=16_000, max_global_candidates=16_000,
            probe_override=12, block_size=64, encode_backend="cpu"),
        reencryption=dataclasses.replace(
            cfg.reencryption, background_enabled=False))

    work = tempfile.mkdtemp(prefix="fspann_epoch_")
    try:
        s = ForwardSecureANNSystem(cfg, work + "/db", d, query_batch=64)
        s.index_stream(base, batch_size=100_000)
        s.finalize_for_search()
        gtm = groundtruth.precompute(base, queries, k=10)

        def phase(tag, extra=None):
            t0 = time.perf_counter()
            agg = s.run_queries(queries, gtm, base, ks=(10,))
            dt = time.perf_counter() - t0
            row = {"phase": tag, "qps": round(q / dt, 1),
                   "recall_at_10": round(agg.recall_at_k[10], 4),
                   "art_ms": round(agg.mean_art_ms, 2),
                   "key_version": s.km.current_version,
                   "stale": int(len(s.store.meta.stale_ids(
                       s.km.current_version)))}
            if extra:
                row.update(extra)
            print(json.dumps(row), flush=True)
            return agg

        s.run_queries(queries[:64], gtm, base, ks=(10,))  # warmup/compile
        s.profiler.clear_rows()
        a1 = phase("steady")

        s.rotation.force_rotate_now()
        a2 = phase("rotate_mixed")        # mixed-version serving

        # background daemon migrating under live queries
        from fspann.crypto.rotation import BackgroundReencryption
        bg = BackgroundReencryption(s.rotation, interval_s=0.05,
                                    batch=20_000, load_shed_qps=1e9)
        bg.start()
        try:
            a3 = phase("background_migration")
        finally:
            bg.stop()

        rep = s.run_selective_reencryption()
        a4 = phase("fully_migrated", {"migrated": rep.get("reencrypted", 0)})

        stable = abs(a4.recall_at_k[10] - a1.recall_at_k[10]) < 1e-9
        print(json.dumps({"phase": "verdict",
                          "recall_stable_across_rotation": bool(stable),
                          "recall_delta": round(
                              a4.recall_at_k[10] - a1.recall_at_k[10], 6)}),
              flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
