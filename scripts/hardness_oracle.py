"""Quantify family-instance hardness: ORACLE probe-schedule recall.

VERDICT r3 weak #4: our synthetic glove-like/redcaps-like probe ladders land
below the reference's measured bands, and the "instance is harder than the
real dataset" claim rested on band shape alone.  This script computes, for
each probe-mode profile geometry, the BEST recall ANY probe-selection policy
could achieve at that profile's probe budget: for each query it greedily
picks, per group (table x division), the partitions containing the most
not-yet-covered GT neighbors — an information-theoretic upper bound on the
router (which must pick partitions from key proximity alone, without seeing
GT).

Interpretation:
  oracle << reference band   -> the INSTANCE is harder than the real
                                dataset: no probe policy could reach the
                                band at this budget; the measured gap is
                                discharged.
  oracle >> our measured row -> calibration gap: the router leaves recall
                                on the table and profiles need retuning.

The SIFT-like hard corpus (whose probe ladder DID land in-band in r2) runs
as the control: its oracle/measured/band relation anchors what a
"calibrated" family looks like.

Usage: JAX_PLATFORMS=cpu python scripts/hardness_oracle.py [fam ...]
       (families: glove redcaps hard; FAM_N / FAM_NQ override sizes)
"""

import dataclasses
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
OUT = os.path.join(ROOT, "bench_results", "hardness_oracle.jsonl")

N = int(os.environ.get("FAM_N", 1_000_000))
NQ = int(os.environ.get("FAM_NQ", 200))

# probe-mode profiles only (scan profiles have no probe schedule), plus each
# family's reference recall@100 band row for the same profile (BASELINE.md /
# reference logs "New Results")
FAMILIES = {
    "glove": dict(d=100, cfg="glove100.json", profiles={
        "GLOVE_P4_FAST": 0.137, "GLOVE_P6_BALANCED": 0.220,
        "GLOVE_TABLES8": 0.272, "GLOVE_LAMBDA3": 0.258,
        "GLOVE_DIV10_FINE": 0.252}),
    "redcaps": dict(d=512, cfg="redcaps.json", profiles={
        "REDCAPS_P4_FAST": 0.043, "REDCAPS_P6_BASE": 0.060,
        "REDCAPS_P10_HIGH": 0.080, "REDCAPS_LAMBDA3": 0.097,
        "REDCAPS_M30": 0.073, "REDCAPS_DIV6": 0.051}),
    "hard": dict(d=128, cfg="sift1m.json", profiles={
        "SIFT_P4_FAST": 0.551, "SIFT_P6_BALANCED": 0.677,
        "SIFT_P10_HIGH": 0.771}),
}


def emit(row):
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(json.dumps(row) + "\n")
    print("ROW", json.dumps(row), flush=True)


def gen_corpus(fam, d):
    from fspann.io import synthetic

    if fam == "glove":
        return synthetic.glove_like_corpus(N, d, NQ)
    if fam == "redcaps":
        return synthetic.redcaps_like_corpus(N, d, NQ)
    return synthetic.lsh_hard_corpus(N, d, NQ, seed=42)


def oracle_recall(bucket_of, gt, probes, k):
    """Greedy per-group probe schedule upper bound.

    bucket_of: int32 [G, N] partition index of each point per group.
    gt: int64 [Q, >=k]; probes: partitions probed per group.
    Returns mean oracle recall@k."""
    g_cnt = bucket_of.shape[0]
    total = 0.0
    for qi in range(gt.shape[0]):
        ids = gt[qi, :k]
        buckets = bucket_of[:, ids]                     # [G, k]
        covered = np.zeros(k, bool)
        quota = np.full(g_cnt, probes, np.int32)
        # greedy: pick the (group, bucket) with max uncovered members among
        # groups with remaining quota, until quotas exhaust or no gain
        while quota.any():
            best_gain, best = 0, None
            for g in range(g_cnt):
                if quota[g] == 0:
                    continue
                bu = buckets[g][~covered]
                if not len(bu):
                    break
                vals, counts = np.unique(bu, return_counts=True)
                j = counts.argmax()
                if counts[j] > best_gain:
                    best_gain, best = counts[j], (g, vals[j])
            if best is None:
                break
            g, b = best
            covered |= buckets[g] == b
            quota[g] -= 1
        total += covered.mean()
    return total / gt.shape[0]


def main():
    from fspann.config import load_config
    from fspann.io import groundtruth
    from fspann.ops import coding

    fams = sys.argv[1:] or list(FAMILIES)
    for fam in fams:
        spec = FAMILIES[fam]
        t0 = time.perf_counter()
        base, queries = gen_corpus(fam, spec["d"])
        gtm = groundtruth.precompute(base, queries, k=100)
        gt = np.asarray(gtm.gt)
        print(f"{fam}: corpus+GT {time.perf_counter()-t0:.0f}s", flush=True)

        only = {p for p in os.environ.get(
            "ORACLE_PROFILES", "").split(",") if p}
        for prof, ref_r100 in spec["profiles"].items():
            if only and prof not in only:
                continue
            cfg = load_config(os.path.join(ROOT, "configs", spec["cfg"]),
                              profile=prof)
            pp, rt = cfg.paper, cfg.runtime
            t0 = time.perf_counter()
            sample = base[:262_144]
            bank = coding.build_bank_from_sample(
                sample, pp.m, pp.lam, pp.tables, pp.divisions, pp.seed,
                pp.omega_divisor)
            # per-group bucket of every point: sort keys (tie by id, same
            # as build_partitions_numpy) and chop into blocks
            _codes, keys = coding.encode_numpy(base, bank)   # keys [N, G]
            g_cnt = keys.shape[1]
            block = rt.block_size
            bucket_of = np.empty((g_cnt, N), np.int32)
            for g in range(g_cnt):
                order = np.argsort(keys[:, g], kind="stable")
                bucket_of[g, order] = (
                    np.arange(N, dtype=np.int32) // block)
            probes = rt.probe_override or rt.probes
            r10 = oracle_recall(bucket_of, gt, probes, 10)
            r100 = oracle_recall(bucket_of, gt, probes, 100)
            frac = probes * g_cnt * block / N
            emit({"family": fam, "profile": prof, "n": N, "queries": NQ,
                  "probes": int(probes), "groups": int(g_cnt),
                  "block": int(block), "scan_fraction": round(frac, 5),
                  "oracle_r10": round(r10, 4),
                  "oracle_r100": round(r100, 4),
                  "reference_band_r100": ref_r100,
                  "secs": round(time.perf_counter() - t0, 1)})
            del bucket_of, keys, _codes


if __name__ == "__main__":
    main()
