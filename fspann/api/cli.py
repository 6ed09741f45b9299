"""Command-line entry point (reference ForwardSecureANNSystem.main:1954-2274).

Full mode: index → finalize → query → selective re-encryption → export.
Query-only mode (``--query-only``): restore from disk, pin key version, query.

Usage:
    python -m fspann.api.cli --data base.fvecs --queries q.fvecs \
        --gt gt.ivecs --base-dir ./db --results ./results \
        [--config cfg.json --profile P6_BALANCED] [--query-limit 1000]
    python -m fspann.api.cli --query-only --queries q.fvecs --base-dir ./db
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..config import load_config
from ..io import groundtruth, loaders
from .system import ForwardSecureANNSystem


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fspann", description=__doc__)
    p.add_argument("--config", help="JSON config path")
    p.add_argument("--profile", help="named profile in the config")
    p.add_argument("--data", help="base vectors (fvecs/bvecs/csv)")
    p.add_argument("--queries", required=True)
    p.add_argument("--gt", help="ground truth (ivecs/csv); AUTO = precompute")
    p.add_argument("--base-dir", required=True, help="store directory")
    p.add_argument("--results", default="results")
    p.add_argument("--query-limit", type=int, default=None)
    p.add_argument("--index-limit", type=int, default=None,
                   help="index only the first N base vectors")
    p.add_argument("--batch", type=int, default=100_000)
    p.add_argument("--query-batch", type=int, default=64)
    p.add_argument("--query-only", action="store_true",
                   help="restore index from disk; no (re)indexing")
    p.add_argument("--restore-version", type=int, default=None,
                   help="pin an explicit key version on restore (reference "
                        "-Drestore.version); default: latest persisted")
    p.add_argument("--no-reencrypt", action="store_true",
                   help="skip the end-of-run selective re-encryption")
    p.add_argument("--decoys", action="store_true",
                   help="interleave decoy queries (access-pattern cloak)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = load_config(args.config, args.profile) if args.config \
        else load_config()

    queries = np.asarray(loaders.load_vectors(args.queries), np.float32)
    if args.query_limit:
        queries = queries[:args.query_limit]
    dim = queries.shape[1]

    system = ForwardSecureANNSystem(cfg, args.base_dir, dim,
                                    query_batch=args.query_batch)
    try:
        base = None
        if args.query_only:
            n = system.restore_index_from_disk(version=args.restore_version)
            print(f"restored {n} points "
                  f"(key version pinned at {system.rotation.pinned_version})",
                  file=sys.stderr)
        else:
            if not args.data:
                raise SystemExit("--data is required unless --query-only")
            base = loaders.load_vectors(args.data)
            n = system.index_stream(base, args.batch, args.index_limit)
            system.finalize_for_search()
            print(f"indexed {n} points", file=sys.stderr)

        gtm = None
        if args.gt and args.gt != "AUTO":
            gtm = groundtruth.GroundtruthManager.load(
                args.gt, base_size=system.index.size + 1)
            if base is not None:
                vr = groundtruth.validate(
                    base, queries, gtm, cfg.ratio.gt_sample,
                    cfg.ratio.gt_mismatch_tolerance)
                if not vr.ok:
                    raise SystemExit(
                        f"GT validation failed: {vr.mismatches}/{vr.checked} "
                        f"mismatches (max rel err {vr.max_rel_error:.3g}) — "
                        "aborting run (reference behavior)")
        elif args.gt == "AUTO":
            if base is None:
                raise SystemExit("--gt AUTO requires --data")
            gtm = groundtruth.precompute(base, queries,
                                         k=system.cfg.eval.max_k)

        eval_queries, real_src = queries, None
        if args.decoys or cfg.cloak.enabled:
            from ..query.decoy import DecoyGenerator
            gen = DecoyGenerator(dim, rate=cfg.cloak.rate,
                                 seed=cfg.cloak.seed, mode=cfg.cloak.mode)
            # decoys run the full pipeline (the access-pattern cloak);
            # recall/ratio are computed on the real queries only via
            # real_src (reference ForwardSecureANNSystem.java:172-183)
            eval_queries, real_src = gen.interleave(queries)
            print(f"decoys: {len(eval_queries) - len(queries)} injected",
                  file=sys.stderr)
        agg = system.run_queries(eval_queries, gtm, base, real_src=real_src)
        print(agg.paper_line(), file=sys.stderr)

        if not args.no_reencrypt:
            rep = system.run_selective_reencryption()
            print(f"selective re-encryption: {json.dumps(rep)}",
                  file=sys.stderr)
        system.export_artifacts(args.results)

        def _num(x):
            return None if x is None or x != x else round(float(x), 4)

        print(json.dumps({
            "recall_at_10": _num(agg.recall_at_k.get(10)),
            "ratio": _num(agg.headline[0]),
            "art_ms": _num(agg.mean_art_ms),
            "queries": agg.num_queries,
        }))
        return 0
    finally:
        system.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
