"""Scan-mode evaluation for a synthetic family at given code geometry.

The 960-d recall problem (VERDICT r2 weak 1): the scan's code width was
dimension-blind — 1,152 bits at 960-d, same as 128-d — so the fine Hamming
ranking starves exactly where the corpus has the most entropy.  This script
measures recall vs (m, lambda, tables, L) so the per-dataset configs can
scale code bits with dimension.

Usage:
  JAX_PLATFORMS=cpu python scripts/eval_scan.py FAMILY N D M LAM TABLES L [DIV]
  e.g. python scripts/eval_scan.py gist 200000 960 48 2 8 2000
"""

import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np



def main():
    fam = sys.argv[1]
    n = int(sys.argv[2])
    d = int(sys.argv[3])
    m = int(sys.argv[4])
    lam = int(sys.argv[5])
    tables = int(sys.argv[6])
    limit = int(sys.argv[7])
    div = int(sys.argv[8]) if len(sys.argv) > 8 else 3
    nq = 200

    from fspann.api.system import ForwardSecureANNSystem
    from fspann.config import (SystemConfig, PaperConfig, RuntimeConfig,
                                   EvalConfig)
    from fspann.io import groundtruth, synthetic

    t0 = time.time()
    if fam == "gist":
        base, queries = synthetic.lsh_hard_corpus(n, d, nq)
    elif fam == "glove":
        base, queries = synthetic.glove_like_corpus(n, d, nq)
    elif fam == "redcaps":
        base, queries = synthetic.redcaps_like_corpus(n, d, nq)
    elif fam == "hard":
        base, queries = synthetic.lsh_hard_corpus(n, d, nq)
    else:
        raise SystemExit(f"unknown family {fam}")
    print(f"corpus {time.time()-t0:.0f}s", flush=True)

    code_bits = tables * div * m * lam
    print(f"{fam} n={n} d={d} m={m} lam={lam} T={tables} div={div} "
          f"L={limit} total_bits={code_bits} "
          f"({n*code_bits/2**30:.2f} GiB int8 at this N)", flush=True)

    cfg = SystemConfig(
        paper=PaperConfig(m=m, lam=lam, divisions=div, tables=tables,
                          seed=13),
        runtime=RuntimeConfig(refinement_limit=limit,
                              max_global_candidates=limit,
                              routing_mode="scan", encode_backend="cpu"),
        eval=EvalConfig(k_variants=(10, 100)),
    ).validate()
    work = tempfile.mkdtemp(prefix="fspann_scan_")
    try:
        sys_ = ForwardSecureANNSystem(cfg, os.path.join(work, "db"), d,
                                      query_batch=64)
        t0 = time.time()
        sys_.index_stream(base, batch_size=100_000)
        sys_.finalize_for_search()
        print(f"build {time.time()-t0:.0f}s", flush=True)
        gtm = groundtruth.precompute(base, queries, k=100)
        t0 = time.time()
        agg = sys_.run_queries(queries, gtm, base, ks=(10, 100))
        wall = time.time() - t0
        print(f"RESULT r@10={agg.recall_at_k[10]:.4f} "
              f"r@100={agg.recall_at_k[100]:.4f} "
              f"ratio={agg.ratio_at_k[100]:.4f} ART={agg.mean_art_ms:.1f}ms "
              f"q/s={nq/wall:.1f}", flush=True)
        sys_.shutdown()
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
