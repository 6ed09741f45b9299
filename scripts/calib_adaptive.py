#!/usr/bin/env python
"""Adaptive-decrypt margin calibration (scan mode, 1M hard corpus).

One build at CAL_M (default 64), then sweep adaptive_decrypt_margin with
the decrypt cap L=2000: measures mean decrypts + recall per margin vs the
fixed-budget rows.  CPU run (recall is platform-independent)."""
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, ".")
import jax  # noqa: E402

os.environ["JAX_PLATFORMS"] = "cpu"   # env AND config (CLAUDE.md gotcha)
jax.config.update("jax_platforms", "cpu")

N = int(os.environ.get("CAL_N", 1_000_000))
D, Q = 128, 192
M = int(os.environ.get("CAL_M", 64))


def main():
    from fspann.api.system import ForwardSecureANNSystem
    from fspann.config import (SystemConfig, PaperConfig, RuntimeConfig,
                                   EvalConfig)
    from fspann.io import synthetic, groundtruth

    base, queries = synthetic.lsh_hard_corpus(N, D, Q, seed=42)
    cfg = SystemConfig(
        paper=PaperConfig(m=M, lam=2, divisions=3, tables=8, seed=13),
        runtime=RuntimeConfig(block_size=128, encode_backend="cpu",
                              refinement_limit=56_000,
                              max_global_candidates=56_000,
                              rerank_limit=2_000, routing_mode="scan"),
        eval=EvalConfig(k_variants=(1, 10, 100))).validate()
    work = tempfile.mkdtemp(prefix="fspann_calibA_")
    try:
        s = ForwardSecureANNSystem(cfg, work + "/db", D, query_batch=64)
        t0 = time.time()
        s.index_stream(base, batch_size=200_000)
        s.finalize_for_search()
        print(f"build {time.time()-t0:.0f}s", flush=True)
        gtm = groundtruth.precompute(base, queries, k=100)

        points = [(2000, 0), (2000, 40), (1000, 0), (1000, 30), (1000, 40),
                  (1000, 60), (800, 40), (700, 0), (700, 40)]
        if os.environ.get("CAL_POINTS"):   # "L:margin,L:margin,..."
            points = [tuple(int(x) for x in p.split(":"))
                      for p in os.environ["CAL_POINTS"].split(",")]
        for L, margin in points:
            rt = dataclasses.replace(cfg.runtime, rerank_limit=L,
                                     adaptive_decrypt_margin=margin)
            c2 = dataclasses.replace(cfg, runtime=rt)
            for obj in (s, s.index, s.query_service):
                obj.cfg = c2
            s.profiler.clear_rows()
            try:
                t0 = time.time()
                agg = s.run_queries(queries, gtm, base)
                dt = time.time() - t0
                print(json.dumps({
                    "L": L, "margin": margin,
                    "r@10": round(agg.recall_at_k[10], 4),
                    "r@100": round(agg.recall_at_k[100], 4),
                    "ratio": round(agg.ratio_at_k[100], 4),
                    "dec": round(agg.mean_cand_decrypted, 0),
                    "art_ms": round(agg.mean_art_ms, 1),
                    "qps": round(Q / dt, 1)}), flush=True)
            except Exception as e:  # noqa: BLE001
                print(f"POINT FAILED L={L} margin={margin}: "
                      f"{type(e).__name__}: {e}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
