"""Root-cause diagnostic for the λ=3 probe-profile gap (VERDICT r4 item #5).

Round-4 measured: GLOVE_LAMBDA3 r@100 0.1893 vs reference 0.2578 and
REDCAPS_LAMBDA3 0.0807 vs 0.0969 — the only 2 of 11 family rows below the
reference, both the λ=3 geometry.  The striking part is the RELATIVE
response: moving P6 (λ=2) → LAMBDA3 (λ=3) the reference GAINS (glove
×1.17, redcaps ×1.63) while we LOSE (×0.73 glove) — yet coding, key
construction (63-bit MSB-first interleave, GreedyPartitioner.java:87-96),
partitioning (median repCode, block 64) and the probe walk are bit-parity
with the reference (ops/coding.py, ops/partition.py, ops/routing.py).
With the implementation identical, the response difference must be the
DATA: what information each interleave bit-level carries on our calibrated
synthetic instances vs real GloVe/RedCaps.

This script quantifies, at λ=2 vs λ=3 on the calibrated family instance:

  1. per-bit-level entropy of the code bits (level 0 = MSB of h mod 2^λ):
     a level whose bits are near-constant adds Hamming noise and — at the
     TOP of the sort key — randomizes partition order below it;
  2. h-value spread per projection (how many buckets are actually hit —
     λ=3 only helps if h spans > 4 values so bit 2 carries signal);
  3. 63-bit key truncation loss: at λ=3, code bits 63..71 (the LSB level
     of projections 16..24) fall OUT of the sort key.  We rebuild the
     partition table from the full untruncated 72-bit order and measure
     the recall delta — isolating truncation from bit-level constancy;
  4. GT probe distance: for each query's true top-10 neighbors, the
     min-over-groups |center_partition(query) − partition(neighbor)| —
     the partition-space dispersion the multi-probe walk must cover;
  5. routing recall@100 (probe walk + exact rerank on plaintext) at the
     ladder's probe count — tying the mechanism to the measured rows.

Usage: JAX_PLATFORMS=cpu python scripts/diag_lambda3.py [glove|redcaps]
Env: DIAG_N (200_000), DIAG_NQ (200), DIAG_OUT
     (bench_results/diag_lambda3.jsonl),
     DIAG_OMEGA_SCALE (1.0) — scale the fitted omega DOWN to widen the
     per-projection h-spread: the h-spread hypothesis test for the
     redcaps lambda=3 response (real RedCaps gains x1.63 at lambda=3
     while the calibrated instance is flat; if the gain appears once h
     spans >= 8 buckets, the gap is instance h-spread, not mechanism).
Round-5 addendum: each lam=3 row also measures the PRODUCTION wide-keys
path (runtime.wide_keys — build_partitions(wide=True) + pair-aware
find_center) as ``routing_recall_at_100_wide``, alongside the forged
rank-key upper bound ``..._untruncated_key``.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("JAX_PLATFORMS") == "cpu":
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.environ.get(
    "DIAG_OUT", os.path.join(ROOT, "bench_results", "diag_lambda3.jsonl"))

N = int(os.environ.get("DIAG_N", 200_000))
NQ = int(os.environ.get("DIAG_NQ", 200))

# the family-ladder profile geometries (configs/{glove100,redcaps}.json)
GEOM = {
    "glove": dict(d=100, m=24, tables=6, divisions=8, probes=6,
                  refinement=18000, norm_sigma=0.4),
    "redcaps": dict(d=512, m=24, tables=6, divisions=8, probes=6,
                    refinement=20000, d_eff=256),
}
BLOCK = 64          # reference GreedyPartitioner block size
SAMPLE = 2000       # bank-fit sample (>= reference's 1000-vector init)


def emit(row):
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(json.dumps(row) + "\n")
    print("ROW", json.dumps(row), flush=True)


def bit_level_entropy(h: np.ndarray, lam: int) -> list[float]:
    """Mean Bernoulli entropy (bits) of each interleave level's code bits.
    h: int32 [S, G, m].  Level l extracts bit lam-1-l (MSB first)."""
    out = []
    for lev in range(lam):
        bit = (h.astype(np.uint32) >> np.uint32(lam - 1 - lev)) & 1
        p = bit.reshape(-1, h.shape[-1]).mean(axis=0)   # per-projection mean
        p = np.clip(p, 1e-9, 1 - 1e-9)
        ent = -(p * np.log2(p) + (1 - p) * np.log2(1 - p))
        out.append(float(ent.mean()))
    return out


def untruncated_order(codes_g: np.ndarray) -> np.ndarray:
    """Sort order by the FULL packed code (all words, MSB-first), not the
    63-bit key — what the sort would do if computeKey kept every bit."""
    cols = [codes_g[:, w] for w in range(codes_g.shape[1] - 1, -1, -1)]
    return np.lexsort(tuple(cols))


def part_of_ids(sids: np.ndarray, n: int) -> np.ndarray:
    """Inverse map: partition index of each id, per group.  [G, N]"""
    g, p, b = sids.shape
    out = np.empty((g, n), np.int32)
    flat = sids.reshape(g, p * b)
    pidx = np.repeat(np.arange(p, dtype=np.int32), b)[None].repeat(g, 0)
    for gi in range(g):
        live = flat[gi] >= 0
        out[gi, flat[gi][live]] = pidx[gi][live]
    return out


def routing_recall(table, codes_q, keys_q, base, queries, gt, probes,
                   refinement, k=100):
    """Probe walk -> exact L2 rerank on plaintext -> recall@k."""
    import jax.numpy as jnp

    from fspann.ops import routing

    tomb = jnp.zeros(len(base), bool)
    res = routing.route(table, jnp.asarray(codes_q), jnp.asarray(keys_q),
                        tomb, probes, refinement)
    ids = np.asarray(res.ids)
    hits = 0
    for qi in range(len(queries)):
        cand = ids[qi][ids[qi] >= 0]
        if not len(cand):
            continue
        d2 = ((base[cand] - queries[qi]) ** 2).sum(axis=1)
        top = cand[np.argsort(d2, kind="stable")[:k]]
        hits += len(set(top.tolist()) & set(gt[qi, :k].tolist()))
    return hits / (len(queries) * k)


def main():
    fam = sys.argv[1] if len(sys.argv) > 1 else "glove"
    geom = GEOM[fam]
    from fspann.io import groundtruth, synthetic
    from fspann.ops import coding, partition, routing

    t0 = time.time()
    if fam == "glove":
        base, queries = synthetic.glove_like_corpus(
            N, geom["d"], NQ, norm_sigma=geom["norm_sigma"])
    else:
        base, queries = synthetic.redcaps_like_corpus(
            N, geom["d"], NQ, d_eff=geom["d_eff"])
    gtm = groundtruth.precompute(base, queries, k=100)
    gt = gtm.gt
    print(f"corpus+gt {time.time()-t0:.0f}s", flush=True)

    omega_scale = float(os.environ.get("DIAG_OMEGA_SCALE", 1.0))
    for lam in (2, 3):
        t0 = time.time()
        bank = coding.build_bank_from_sample(
            base[:SAMPLE], geom["m"], lam, geom["tables"],
            geom["divisions"], seed=13)
        if omega_scale != 1.0:
            import dataclasses
            bank = dataclasses.replace(
                bank, omega=bank.omega * np.float32(omega_scale))
        codes, keys = coding.encode_numpy(base, bank)
        codes_q, keys_q = coding.encode_numpy(queries, bank)

        # 1+2: what does each bit level know?  (50k subsample)
        h = np.asarray(coding.project_h(base[:50_000], bank))
        ent = bit_level_entropy(h, lam)
        spread = np.percentile(
            h.max(axis=0) - h.min(axis=0), [50, 99])   # per (g, j) h range
        hist_vals = [float((h == v).mean())
                     for v in range(int(h.min()), int(h.min()) + 8)]

        # distinct-key structure of the sort
        g = bank.g
        distinct = np.mean([len(np.unique(keys[:, gi])) for gi in
                            range(0, g, max(g // 8, 1))]) / N

        # 3: partition tables — 63-bit key vs full untruncated code order
        keys_gn = np.ascontiguousarray(keys.T)          # [G, N]
        codes_gn = np.ascontiguousarray(np.moveaxis(codes, 1, 0))  # [G,N,W]
        table = partition.build_partitions_numpy(keys_gn, codes_gn, BLOCK)
        r100 = routing_recall(table, codes_q, keys_q, base, queries, gt,
                              geom["probes"], geom["refinement"])

        r100_wide = None
        if lam * geom["m"] > 63:
            # the shipped wide-keys path (runtime.wide_keys): pair order at
            # build, query keys2 derived from codes inside routing.route
            table_w = partition.build_partitions_numpy(
                keys_gn, codes_gn, BLOCK, wide=True)
            r100_wide = routing_recall(table_w, codes_q, keys_q, base,
                                       queries, gt, geom["probes"],
                                       geom["refinement"])

        r100_full = None
        if lam * geom["m"] > 63:
            # rebuild with the untruncated order (forge keys = rank so the
            # binary search stays consistent with the new order)
            p = table.ids.shape[1]
            sids = np.empty((g, p * BLOCK), np.int32)
            fkeys = np.empty((g, p * BLOCK), np.int64)
            pad = p * BLOCK - N
            rank_f: np.ndarray | None = None
            for gi in range(g):
                order = untruncated_order(codes_gn[gi])
                sids[gi, :N] = order
                fkeys[gi, :N] = np.arange(N, dtype=np.int64)
            if pad:
                sids[:, N:] = -1
                fkeys[:, N:] = np.iinfo(np.int64).max
            sids = sids.reshape(g, p, BLOCK)
            fkeys = fkeys.reshape(g, p, BLOCK)
            counts = np.clip(N - np.arange(p) * BLOCK, 0, BLOCK
                             ).astype(np.int32)
            counts = np.broadcast_to(counts, (g, p)).copy()
            mid = (counts - 1) // 2
            mid_ids = np.take_along_axis(
                sids, mid[..., None], axis=-1)[..., 0]
            reps = codes_gn[np.arange(g)[:, None], np.maximum(mid_ids, 0)]
            table_f = partition.PartitionTable(
                fkeys[:, :, 0].copy(),
                np.take_along_axis(
                    fkeys, np.maximum(counts - 1, 0)[..., None],
                    axis=-1)[..., 0],
                reps.astype(np.uint32), sids, counts)
            # query keys in the forged (rank) space: insertion position of
            # the query's full code among the sorted codes per group
            qk_full = np.empty((NQ, g), np.int64)
            for gi in range(g):
                order = sids[gi].reshape(-1)[:N]
                sc = codes_gn[gi][order]        # sorted full codes [N, W]
                # compare query code to sorted codes lexicographically
                qc = codes_q[:, gi]             # [NQ, W]
                lo = np.zeros(NQ, np.int64)
                hi = np.full(NQ, N, np.int64)
                for _ in range(int(np.ceil(np.log2(N))) + 1):
                    mid_ = (lo + hi) // 2
                    rows = sc[np.minimum(mid_, N - 1)]
                    less = np.zeros(NQ, bool)
                    decided = np.zeros(NQ, bool)
                    for w in range(sc.shape[1]):
                        lt = (rows[:, w] < qc[:, w]) & ~decided
                        gtq = (rows[:, w] > qc[:, w]) & ~decided
                        less |= lt
                        decided |= lt | gtq
                    lo = np.where(less, mid_ + 1, lo)
                    hi = np.where(less, hi, mid_)
                qk_full[:, gi] = np.clip(lo, 0, N - 1)
            r100_full = routing_recall(table_f, codes_q, qk_full, base,
                                       queries, gt, geom["probes"],
                                       geom["refinement"])

        # 4: GT probe distance (partition-space dispersion of true top-10)
        pof = part_of_ids(np.asarray(table.ids), N)     # [G, N]
        import jax.numpy as jnp
        center = np.asarray(routing.find_center(
            jax.tree_util.tree_map(jnp.asarray, table),
            jnp.asarray(keys_q)))                       # [NQ, G]
        nbr = gt[:, :10]                                # [NQ, 10]
        dist = np.abs(pof[:, nbr].transpose(1, 2, 0)    # [NQ, 10, G]
                      - center[:, None, :])
        min_dist = dist.min(axis=2)                     # min over groups
        within = [float((min_dist < w).mean())
                  for w in (1, 3, 6, 12, 24)]

        emit({"family": fam, "lam": lam, "n": N, "nq": NQ,
              "bit_level_entropy": [round(e, 4) for e in ent],
              "h_range_p50": float(spread[0]), "h_range_p99": float(spread[1]),
              "h_hist_from_min": [round(v, 4) for v in hist_vals],
              "distinct_key_frac": round(float(distinct), 4),
              "omega_scale": omega_scale,
              "routing_recall_at_100": round(r100, 4),
              "routing_recall_at_100_wide":
                  None if r100_wide is None else round(r100_wide, 4),
              "routing_recall_at_100_untruncated_key":
                  None if r100_full is None else round(r100_full, 4),
              "gt10_min_probe_dist_p50": float(np.median(min_dist)),
              "gt10_min_probe_dist_p90":
                  float(np.percentile(min_dist, 90)),
              "gt10_within_probes_1_3_6_12_24": within,
              "secs": round(time.time() - t0, 1)})


if __name__ == "__main__":
    import jax
    main()
