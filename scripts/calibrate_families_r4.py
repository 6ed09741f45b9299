"""Round-4 family-instance recalibration (VERDICT r3 next-round #3).

The r3 probe ladders landed BELOW the reference bands per-profile (glove
0.087-0.175 vs 0.137-0.272; redcaps 0.025-0.070 vs 0.043-0.097) — i.e. the
synthetic instances are somewhat harder than the real datasets.  The
hardness-oracle control shows the partition geometry retains full GT
information on these instances, so the shortfall is instance difficulty,
not router bugs.  This sweep tunes the generator difficulty knobs
(glove: spectrum/norm_sigma; redcaps: cone) until the band-endpoint
profiles reproduce the reference's measured recall@100 rows, then the full
ladder re-runs at the calibrated setting (run_families_r3.py with
FAM_* env overrides below).

Usage: JAX_PLATFORMS=cpu python scripts/calibrate_families_r4.py glove
       JAX_PLATFORMS=cpu python scripts/calibrate_families_r4.py redcaps
Env: CAL_N (default 1_000_000), CAL_NQ (200), CAL_GRID ("a,b,c" overrides)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

if os.environ.get("JAX_PLATFORMS") == "cpu":
    import jax
    jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "bench_results", "calib_r4.jsonl")
N = int(os.environ.get("CAL_N", 1_000_000))
NQ = int(os.environ.get("CAL_NQ", 200))

# band-endpoint profiles + their reference recall@100 rows
TARGETS = {
    "glove": {"cfg": "glove100.json",
              "profiles": {"GLOVE_P4_FAST": 0.137, "GLOVE_TABLES8": 0.272},
              # difficulty knob: spectrum (lower = flatter spectrum =
              # more informative projections = easier)
              "grid": [1.25, 1.15, 1.05]},
    "redcaps": {"cfg": "redcaps.json",
                "profiles": {"REDCAPS_P4_FAST": 0.043,
                             "REDCAPS_LAMBDA3": 0.097},
                # difficulty knob: cone (higher = more shared direction =
                # wider cosine spread = easier)
                "grid": [2.0, 2.6, 3.2]},
}


def emit(row):
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(json.dumps(row) + "\n")
    print("ROW", json.dumps(row), flush=True)


def gen(fam, knob):
    from fspann.io import synthetic

    if fam == "glove":
        # CAL_GLOVE_KNOB=norm_sigma sweeps the lognormal norm spread
        # instead (the bucket-width breaker) when spectrum proves flat
        if os.environ.get("CAL_GLOVE_KNOB", "spectrum") == "norm_sigma":
            return synthetic.glove_like_corpus(N, 100, NQ, norm_sigma=knob)
        return synthetic.glove_like_corpus(N, 100, NQ, spectrum=knob)
    # CAL_REDCAPS_KNOB=d_eff sweeps the latent dimensionality — the
    # distance-concentration lever itself — when cone proves flat
    if os.environ.get("CAL_REDCAPS_KNOB", "cone") == "d_eff":
        return synthetic.redcaps_like_corpus(N, 512, NQ, d_eff=int(knob))
    return synthetic.redcaps_like_corpus(N, 512, NQ, cone=knob)


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from run_families_r3 import run_profile   # reuse the ladder runner

    import run_families_r3 as fam_mod
    fam_mod.N, fam_mod.NQ = N, NQ             # keep row metadata honest
    fam_mod.OUT = OUT

    from fspann.io import groundtruth

    fams = sys.argv[1:] or list(TARGETS)
    for fam in fams:
        spec = TARGETS[fam]
        grid = [float(x) for x in os.environ.get("CAL_GRID", "").split(",")
                if x] or spec["grid"]
        cfg_path = os.path.join(ROOT, "configs", spec["cfg"])
        for knob in grid:
            t0 = time.time()
            base, queries = gen(fam, knob)
            gtm = groundtruth.precompute(base, queries, k=100)
            print(f"{fam} knob={knob}: corpus+GT {time.time()-t0:.0f}s",
                  flush=True)
            kname = os.environ.get("CAL_GLOVE_KNOB", "spectrum") \
                if fam == "glove" \
                else os.environ.get("CAL_REDCAPS_KNOB", "cone")
            tag = f"{fam}@{knob}" if kname in ("spectrum", "cone") \
                else f"{fam}@{kname}={knob}"
            for prof, ref in spec["profiles"].items():
                t0 = time.time()
                run_profile(tag, base, queries, gtm, cfg_path,
                            prof)
                print(f"  {prof}: ref_r100={ref} ({time.time()-t0:.0f}s)",
                      flush=True)
            del base, queries, gtm


if __name__ == "__main__":
    main()
