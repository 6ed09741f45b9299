#!/usr/bin/env python
"""Scan-mode decrypt-budget (L) calibration at the parity default (m=48).

Builds ONE 1M hard-corpus index in scan mode, then sweeps rerank_limit —
the decrypt budget L — to find the smallest L that holds the headline
recall.  Decrypt is a large share of ART at L=2000, so a recall-preserving
cut is a direct q/s win.  Recall/ratio are platform-independent: runs on
CPU (forced via jax.config)."""
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
M = int(os.environ.get("CAL_M", 48))


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
    work = tempfile.mkdtemp(prefix="fspann_calibL_")
    try:
        s = ForwardSecureANNSystem(cfg, work + "/db", D, query_batch=64)
        t0 = time.time()
        s.index_stream(base, batch_size=200_000)
        s.finalize_for_search()
        print(f"build {time.time()-t0:.0f}s", flush=True)
        t0 = time.time()
        gtm = groundtruth.precompute(base, queries, k=100)
        print(f"gt {time.time()-t0:.0f}s", flush=True)

        for L in (2000, 1500, 1000, 700, 500, 300):
            rt = dataclasses.replace(cfg.runtime, rerank_limit=L)
            c2 = dataclasses.replace(cfg, runtime=rt)
            for obj in (s, s.index, s.query_service):
                obj.cfg = c2
            try:
                t0 = time.time()
                agg = s.run_queries(queries, gtm, base)
                dt = time.time() - t0
                print(json.dumps({
                    "L": L,
                    "r@10": round(agg.recall_at_k[10], 4),
                    "r@100": round(agg.recall_at_k[100], 4),
                    "ratio": round(agg.ratio_at_k[100], 4),
                    "dec": round(agg.mean_cand_decrypted, 0),
                    "art_ms": round(agg.mean_art_ms, 1),
                    "qps": round(Q / dt, 1)}), flush=True)
            except Exception as e:  # noqa: BLE001
                print(f"POINT FAILED L={L}: {type(e).__name__}: {e}",
                      flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
