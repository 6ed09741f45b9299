#!/usr/bin/env python
"""1M hard-corpus rerank calibration: build ONE index (tables 8, block 128),
then sweep query-time (probes, refinement, rerank budget) operating points.
Recall/ratio are platform-independent; JAX_PLATFORMS=cpu runs it without
the GPU."""
import dataclasses
import json
import shutil
import sys
import tempfile
import time

sys.path.insert(0, ".")
import numpy as np  # noqa: E402

N, D, Q = 1_000_000, 128, 192


def main():
    from fspann.api.system import ForwardSecureANNSystem
    from fspann.config import SystemConfig, PaperConfig, RuntimeConfig, EvalConfig
    from fspann.io import synthetic, groundtruth

    base, queries = synthetic.lsh_hard_corpus(N, D, Q, seed=42)
    cfg = SystemConfig(
        paper=PaperConfig(m=24, lam=2, divisions=3, tables=8, seed=13),
        runtime=RuntimeConfig(block_size=128, encode_backend="cpu",
                              refinement_limit=93_000,
                              max_global_candidates=93_000,
                              rerank_limit=8_000),   # keeps point_codes
        eval=EvalConfig(k_variants=(1, 10, 100))).validate()
    work = tempfile.mkdtemp(prefix="fspann_calib_")
    try:
        s = ForwardSecureANNSystem(cfg, work + "/db", D, query_batch=64)
        t0 = time.time()
        s.index_stream(base, batch_size=200_000)
        s.finalize_for_search()
        print(f"build {time.time()-t0:.0f}s", flush=True)
        t0 = time.time()
        gtm = groundtruth.precompute(base, queries, k=100)
        print(f"gt {time.time()-t0:.0f}s", flush=True)

        points = [
            ("p12_R38k_rr2k",  12, 38_000, 2_000),
            ("p16_R56k_rr4k",  16, 56_000, 4_000),
            ("p16_R56k_rr2k",  16, 56_000, 2_000),
            ("p20_R93k_rr4k",  20, 93_000, 4_000),
        ]
        for tag, probes, limit, rr in points:
            rt = dataclasses.replace(cfg.runtime, probe_override=probes,
                                     refinement_limit=limit,
                                     max_global_candidates=limit,
                                     rerank_limit=rr)
            c2 = dataclasses.replace(cfg, runtime=rt)
            for obj in (s, s.index, s.query_service):
                obj.cfg = c2
            try:
                t0 = time.time()
                agg = s.run_queries(queries, gtm, base)
                dt = time.time() - t0
                print(json.dumps({
                    "tag": tag,
                    "r@10": round(agg.recall_at_k[10], 3),
                    "r@100": round(agg.recall_at_k[100], 3),
                    "ratio": round(agg.ratio_at_k[100], 4),
                    "dec": round(agg.mean_cand_decrypted, 0),
                    "art_ms": round(agg.mean_art_ms, 1),
                    "qps": round(Q / dt, 1)}), flush=True)
            except Exception as e:  # noqa: BLE001
                print(f"POINT FAILED {tag}: {type(e).__name__}: {e}",
                      flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
