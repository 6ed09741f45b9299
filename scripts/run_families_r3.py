"""Round-3 evidence sweep: 1M-scale measured rows for every reference
dataset family (VERDICT r2 missing 2 / next-round 1).

For each family (glove-100-like, redcaps-512-like, gist-960-like):
  1. generate the calibrated 1M instance + 200 held-out queries + GT,
  2. run the reference-shaped PROBE profile ladder (band calibration
     evidence — reference bands: glove 0.14–0.27 r@100, redcaps 0.04–0.10),
  3. run the dimension-scaled SCAN profile (our serving mode).

Recall/ratio are platform-independent; this runs on CPU (the slower
serving platform — latency numbers are conservative).  Each step survives
exceptions (the VM has slow phases).  JSON-lines out:
bench_results/families_r3/results.jsonl

Usage: JAX_PLATFORMS=cpu python scripts/run_families_r3.py [fam ...]
"""

import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "bench_results",
                       os.environ.get("FAM_OUT_DIR", "families_r3"))
OUT = os.path.join(OUT_DIR, "results.jsonl")

N = int(os.environ.get("FAM_N", 1_000_000))
NQ = int(os.environ.get("FAM_NQ", 200))

FAMILIES = {
    "glove": dict(d=100, cfg="glove100.json",
                  profiles=["GLOVE_P4_FAST", "GLOVE_P6_BALANCED",
                            "GLOVE_TABLES8", "GLOVE_LAMBDA3",
                            "GLOVE_LAMBDA3_WIDE",
                            "GLOVE_DIV10_FINE", "GLOVE_SCAN",
                            "GLOVE_SCAN_HQ"]),
    "redcaps": dict(d=512, cfg="redcaps.json",
                    profiles=["REDCAPS_P4_FAST", "REDCAPS_P6_BASE",
                              "REDCAPS_P10_HIGH", "REDCAPS_LAMBDA3",
                              "REDCAPS_LAMBDA3_WIDE",
                              "REDCAPS_M30", "REDCAPS_DIV6",
                              "REDCAPS_SCAN", "REDCAPS_SCAN_HQ"]),
    "gist": dict(d=960, cfg="gist1m.json",
                 profiles=["GIST_SCAN", "GIST_SCAN_HQ", "GIST_SCAN_F16"]),
}


def emit(row):
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(OUT, "a") as f:
        f.write(json.dumps(row) + "\n")
    print("ROW", json.dumps(row), flush=True)


def gen_corpus(fam, d):
    from fspann.io import synthetic

    # hardness-equivalence knobs (round-4 calibration,
    # bench_results/calib_r4.jsonl): FAM_GLOVE_NORM_SIGMA=0.4 /
    # FAM_REDCAPS_D_EFF reproduce the reference's measured probe bands
    if fam == "glove":
        ns = float(os.environ.get("FAM_GLOVE_NORM_SIGMA", 0.55))
        return synthetic.glove_like_corpus(N, d, NQ, norm_sigma=ns)
    if fam == "redcaps":
        de = int(os.environ.get("FAM_REDCAPS_D_EFF", 512))
        return synthetic.redcaps_like_corpus(N, d, NQ, d_eff=de)
    if fam == "gist":
        return synthetic.lsh_hard_corpus(N, d, NQ)
    raise ValueError(fam)


def run_profile(fam, base, queries, gtm, cfg_path, profile):
    import jax

    from fspann.api.system import ForwardSecureANNSystem
    from fspann.config import load_config

    platform = jax.default_backend()
    label = "cpu-1core" if platform == "cpu" else platform
    d = base.shape[1]
    cfg = load_config(cfg_path, profile)
    cfg = dataclasses.replace(
        cfg, runtime=dataclasses.replace(cfg.runtime, encode_backend="cpu"))
    work = tempfile.mkdtemp(prefix=f"fspann_{fam}_")
    try:
        sys_ = ForwardSecureANNSystem(cfg, os.path.join(work, "db"), d,
                                      query_batch=64)
        t0 = time.time()
        sys_.index_stream(base, batch_size=100_000)
        sys_.finalize_for_search()
        build_s = time.time() - t0
        t0 = time.time()
        agg = sys_.run_queries(queries, gtm, base, ks=(10, 100))
        wall = time.time() - t0
        cols = sys_.profiler.columns()
        sel = cols["k"] == 10
        emit({"family": fam, "profile": profile, "n": len(base), "d": d,
              "recall_at_10": round(agg.recall_at_k[10], 4),
              "recall_at_100": round(agg.recall_at_k[100], 4),
              "ratio_at_100": round(agg.ratio_at_k[100], 4),
              "art_ms": round(agg.mean_art_ms, 1),
              "qps": round(NQ / wall, 1),
              "cand_mean": int(np.mean(cols["cand_refined"][sel])),
              "build_s": round(build_s, 0), "platform": label})
        sys_.shutdown()
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main():
    fams = sys.argv[1:] or list(FAMILIES)
    from fspann.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from fspann.io import groundtruth

    for fam in fams:
        spec = FAMILIES[fam]
        cfg_path = os.path.join(ROOT, "configs", spec["cfg"])
        only = os.environ.get("FAM_PROFILES")
        if only:
            # an explicit FAM_PROFILES list may name profiles beyond the
            # default ladder (e.g. new HQ variants from the config file),
            # but each family runs only the names its OWN config defines —
            # without the intersection a cross-family list would pay the
            # hour-scale corpus+GT build just to KeyError on load_config
            wanted = [p.strip() for p in only.split(",") if p.strip()]
            with open(cfg_path) as f:
                avail = set(json.load(f).get("profiles", {}))
            profiles = [p for p in wanted if p in avail]
            if not profiles:
                print(f"=== {fam}: no FAM_PROFILES match, skipped ===",
                      flush=True)
                continue
        else:
            profiles = spec["profiles"]
        print(f"=== {fam} (d={spec['d']}, n={N}) ===", flush=True)
        t0 = time.time()
        base, queries = gen_corpus(fam, spec["d"])
        print(f"corpus {time.time()-t0:.0f}s", flush=True)
        t0 = time.time()
        gtm = groundtruth.precompute(base, queries, k=100)
        print(f"gt {time.time()-t0:.0f}s", flush=True)
        for profile in profiles:
            try:
                run_profile(fam, base, queries, gtm, cfg_path, profile)
            except Exception:
                traceback.print_exc()
                emit({"family": fam, "profile": profile, "error": True})
        del base, queries, gtm


if __name__ == "__main__":
    main()
