"""Calibrate the LSH-hard corpus: hardness statistics + recall at default
config.  Run on CPU at 100k–200k to pick `separation` / `query_alpha` before
committing to a 1M GPU bench.

Usage: JAX_PLATFORMS=cpu python scripts/calibrate_hard.py [N] [SEP] [ALPHA]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np



def relative_contrast(base, queries, k=10, sample=2000):
    """d(q, NN_k) / d(q, mean point): ~1 = hopeless, >2 = easy."""
    rng = np.random.default_rng(0)
    sub = base[rng.choice(len(base), min(len(base), 100_000), replace=False)]
    rc = []
    for q in queries[:32]:
        d2 = ((sub - q) ** 2).sum(axis=1)
        d2.sort()
        rc.append(np.sqrt(d2[k - 1]) / np.sqrt(d2.mean()))
    return float(np.mean(rc))


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    sep = float(sys.argv[2]) if len(sys.argv) > 2 else 1.6
    alpha = float(sys.argv[3]) if len(sys.argv) > 3 else 0.9
    probes = int(sys.argv[4]) if len(sys.argv) > 4 else -1
    d, nq = 128, 100

    from fspann.io.synthetic import lsh_hard_corpus
    from fspann.api.system import ForwardSecureANNSystem
    from fspann.config import SystemConfig
    from fspann.io import groundtruth
    import dataclasses
    import tempfile
    import shutil

    t0 = time.time()
    base, queries = lsh_hard_corpus(n, d, nq, separation=sep,
                                    query_alpha=alpha)
    print(f"corpus: {time.time()-t0:.1f}s  "
          f"rel_contrast@10={relative_contrast(base, queries):.3f}",
          flush=True)

    cfg = SystemConfig()
    cfg = dataclasses.replace(
        cfg, runtime=dataclasses.replace(cfg.runtime, encode_backend="cpu",
                                         probe_override=probes))
    work = tempfile.mkdtemp(prefix="fspann_cal_")
    try:
        sys_ = ForwardSecureANNSystem(cfg, os.path.join(work, "db"), d,
                                      query_batch=64)
        t0 = time.time()
        sys_.index_stream(base, batch_size=100_000)
        sys_.finalize_for_search()
        print(f"build: {time.time()-t0:.1f}s", flush=True)
        gtm = groundtruth.precompute(base, queries, k=100)
        agg = sys_.run_queries(queries, gtm, base, ks=(10, 100))
        rows = [r for r in sys_.profiler.rows if r.k == 10]
        scan = np.mean([r.cand_refined for r in rows]) / n
        print(f"n={n} sep={sep} alpha={alpha} probes={probes}: "
              f"recall@10={agg.recall_at_k[10]:.4f} "
              f"recall@100={agg.recall_at_k[100]:.4f} "
              f"ratio@100={agg.ratio_at_k[100]:.4f} "
              f"ART={agg.mean_art_ms:.1f}ms scan={scan:.4%}", flush=True)
        sys_.shutdown()
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
