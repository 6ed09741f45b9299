#!/usr/bin/env python
"""Profile sweep runner (reference fsp-anns-parent/run-all.sh /
adaptive_run.sh): run every profile of one or more config suites, collect a
global_summary.csv.

Usage:
  python scripts/run_all.py --config configs/sift1m.json \
      --data base.fvecs --queries q.fvecs --out results/sweep \
      [--profiles SIFT_P4_FAST,SIFT_P6_BALANCED] [--query-limit 1000]
  python scripts/run_all.py --config configs/sift1m.json --synthetic 100000
"""

import argparse
import csv
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, ".")


def run_profile(cfg, base, queries, out_dir, profile, gtm=None):
    from fspann.api.system import ForwardSecureANNSystem
    from fspann.io import groundtruth

    work = tempfile.mkdtemp(prefix=f"fspann_{profile}_")
    try:
        system = ForwardSecureANNSystem(cfg, work + "/db", base.shape[1])
        t0 = time.time()
        system.index_stream(base, batch_size=100_000)
        system.finalize_for_search()
        build_s = time.time() - t0
        if gtm is None:   # GT is profile-independent; caller should share it
            gtm = groundtruth.precompute(base, queries, k=cfg.eval.max_k)
        # warmup batch: exclude jit compile from the measured sweep
        system.run_queries(queries[:min(64, len(queries))], gtm, base)
        system.profiler.clear_rows()
        t0 = time.time()
        agg = system.run_queries(queries, gtm, base)
        query_s = time.time() - t0
        system.run_selective_reencryption()
        system.export_artifacts(os.path.join(out_dir, profile))
        ratio, recall10 = agg.headline
        row = {
            "profile": profile,
            "recall_at_10": round(recall10, 4),
            "recall_at_100": round(agg.recall_at_k.get(100, float("nan")), 4),
            "ratio": round(ratio, 4),
            "art_ms": round(agg.mean_art_ms, 2),
            "qps": round(len(queries) / query_s, 2),
            "build_s": round(build_s, 1),
            "mean_cands": round(agg.mean_cand_unique, 0),
        }
        system.shutdown()
        return row
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--data")
    ap.add_argument("--queries")
    ap.add_argument("--profiles", help="comma-separated subset")
    ap.add_argument("--query-limit", type=int, default=1000)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="use an n-point synthetic corpus instead of --data")
    ap.add_argument("--corpus", default="hard", choices=("hard", "easy"),
                    help="synthetic corpus kind (io/synthetic.py)")
    ap.add_argument("--encode-backend", default=None,
                    help="override runtime.encode_backend (cpu|default)")
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--out", default="results/sweep")
    args = ap.parse_args()

    from fspann.config import load_config
    from fspann.io import loaders

    data = json.load(open(args.config))
    profiles = list(data.get("profiles", {}))
    if isinstance(data.get("profiles"), list):
        profiles = [p["name"] for p in data["profiles"]]
    if args.profiles:
        profiles = [p for p in profiles if p in args.profiles.split(",")]

    if args.synthetic:
        from fspann.io import synthetic
        gen = synthetic.lsh_hard_corpus if args.corpus == "hard" \
            else synthetic.easy_corpus
        base, queries = gen(args.synthetic, args.d, args.query_limit, seed=42)
    else:
        base = np.asarray(loaders.load_vectors(args.data), np.float32)
        queries = np.asarray(loaders.load_vectors(args.queries),
                             np.float32)[:args.query_limit]

    os.makedirs(args.out, exist_ok=True)
    from fspann.io import groundtruth
    t0 = time.time()
    gtm = groundtruth.precompute(base, queries, k=100)
    print(f"GT precompute: {time.time()-t0:.1f}s", flush=True)
    rows = []
    for profile in profiles:
        overrides = {"runtime": {"encode_backend": args.encode_backend}} \
            if args.encode_backend else None
        cfg = load_config(args.config, profile, overrides=overrides)
        print(f"=== {profile} ===", flush=True)
        try:
            row = run_profile(cfg, base, queries, args.out, profile, gtm=gtm)
        except Exception as e:  # noqa: BLE001 — one profile must not kill the sweep
            print(f"PROFILE FAILED {profile}: {type(e).__name__}: {e}",
                  flush=True)
            continue
        print(json.dumps(row), flush=True)
        rows.append(row)
        with open(os.path.join(args.out, "global_summary.csv"), "w",
                  newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    print(f"wrote {args.out}/global_summary.csv ({len(rows)} profiles)")


if __name__ == "__main__":
    main()
