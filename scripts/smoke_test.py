#!/usr/bin/env python
"""End-to-end smoke with pass/fail gates (reference fsp-anns-parent/smoke_test.sh).

Runs the full encrypted pipeline on a real dataset (or a synthetic clustered
corpus when no data is given) and gates on the reference's thresholds:
ratio <= 1.30 and recall@10 >= 0.85 (smoke_test.sh:427-440; recall gate
applied at the reference's thesis-setting level).

Usage:
  python scripts/smoke_test.py                              # synthetic
  python scripts/smoke_test.py --data sift_base.fvecs --queries q.fvecs \
      --config configs/sift1m.json --profile SIFT_P6_BALANCED \
      [--query-limit 20] [--index-limit 100000]
"""

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, ".")

RATIO_GATE = 1.30
RECALL_GATE = 0.85


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data")
    ap.add_argument("--queries")
    ap.add_argument("--config")
    ap.add_argument("--profile")
    ap.add_argument("--query-limit", type=int, default=20)
    ap.add_argument("--index-limit", type=int, default=None)
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--corpus", default="hard", choices=("hard", "easy"),
                    help="synthetic corpus kind; 'hard' makes the gates "
                         "informative (VERDICT r1: easy clusters pass "
                         "SIFT-calibrated gates trivially)")
    args = ap.parse_args()

    from fspann.api.system import ForwardSecureANNSystem
    from fspann.config import load_config
    from fspann.io import groundtruth, loaders

    if args.config:
        cfg = load_config(args.config, args.profile)
    else:
        # parity-grade profile: on the hard corpus the recall gate only
        # passes if routing actually ranks well at a ~30% scan — random
        # probing at the same scan fraction lands far below 0.85.  The
        # full-code rerank exercises the serving-default fused path while
        # keeping the decrypt volume smoke-sized.
        cfg = load_config(overrides={
            "paper": {"tables": 8},
            "runtime": {"probe_override": 10, "block_size": 64,
                        "refinement_limit": 16000,
                        "max_global_candidates": 16000,
                        "rerank_limit": 4000}})

    if args.data:
        base = loaders.load_vectors(args.data)
        if args.index_limit:
            base = base[:args.index_limit]
        base = np.asarray(base, np.float32)
        queries = np.asarray(loaders.load_vectors(args.queries),
                             np.float32)[:args.query_limit]
    else:
        from fspann.io import synthetic
        gen = synthetic.lsh_hard_corpus if args.corpus == "hard" \
            else synthetic.easy_corpus
        base, queries = gen(args.n, args.d, args.query_limit, seed=3)

    work = tempfile.mkdtemp(prefix="fspann_smoke_")
    try:
        system = ForwardSecureANNSystem(cfg, work + "/db", base.shape[1],
                                        query_batch=min(32, len(queries)))
        t0 = time.time()
        system.index_stream(base, batch_size=50_000)
        system.finalize_for_search()
        gtm = groundtruth.precompute(base, queries, k=cfg.eval.max_k)
        agg = system.run_queries(queries, gtm, base)
        rep = system.run_selective_reencryption()
        wall = time.time() - t0
        ratio, recall10 = agg.headline

        print(agg.paper_line())
        print(f"selective re-encryption: {rep['reencrypted']} migrated, "
              f"{rep['migration_remaining']} remaining")
        verdict = {
            "ratio": round(ratio, 4), "recall_at_10": round(recall10, 4),
            "art_ms": round(agg.mean_art_ms, 1), "wall_s": round(wall, 1),
            "gates": {"ratio<=1.30": ratio <= RATIO_GATE,
                      "recall@10>=0.85": recall10 >= RECALL_GATE},
        }
        print(json.dumps(verdict))
        system.shutdown()
        if not all(verdict["gates"].values()):
            print("SMOKE FAILED", file=sys.stderr)
            if ratio > RATIO_GATE:
                print("tuning: lower omega_divisor or raise probes/"
                      "refinementLimit", file=sys.stderr)
            if recall10 < RECALL_GATE:
                print("tuning: raise tables/probes or refinementLimit "
                      "(see configs/*.json profiles)", file=sys.stderr)
            return 1
        print("SMOKE PASSED")
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
