"""End-to-end plaintext ANN slice through the public package API.

Builds the LSH bank from a sample, encodes a corpus, builds partitions,
routes queries, refines, and reports recall@10 vs exact brute force —
the minimum E2E slice of SURVEY.md §7 step 2.

Usage: python examples/plaintext_ann.py [n] [d] [q]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax.numpy as jnp
from fspann.config import SystemConfig
from fspann.ops import coding, partition, refine, routing


def main(n=20_000, d=64, q=64, k=10, seed=13):
    cfg = SystemConfig()
    pp, rt = cfg.paper, cfg.runtime
    rng = np.random.default_rng(seed)
    # clustered corpus so LSH has structure to find
    centers = rng.normal(size=(64, d)).astype(np.float32) * 6
    assign = rng.integers(0, 64, n)
    base = centers[assign] + rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, 64, q)] + \
        rng.normal(size=(q, d)).astype(np.float32)

    t0 = time.perf_counter()
    bank = coding.build_bank_from_sample(base[:2000], pp.m, pp.lam, pp.tables,
                                         pp.divisions, pp.seed)
    codes, keys = coding.encode(jnp.asarray(base), bank)
    table = partition.build_partitions(jnp.transpose(keys, (1, 0)),
                                       jnp.transpose(codes, (1, 0, 2)),
                                       rt.block_size)
    t_build = time.perf_counter() - t0

    qc, qk = coding.encode(jnp.asarray(queries), bank)
    tomb = jnp.zeros(n, bool)
    t0 = time.perf_counter()
    routed = routing.route(table, qc, qk, tomb, rt.effective_probes(),
                           rt.refinement_limit)
    cand_ids = np.asarray(routed.ids)
    # plaintext gather (in the encrypted system the host crypto layer does this)
    cand_vecs = base[np.maximum(cand_ids, 0)]
    valid = cand_ids >= 0
    res = refine.refine(jnp.asarray(queries), jnp.asarray(cand_vecs),
                        jnp.asarray(cand_ids), jnp.asarray(valid), k)
    got = np.asarray(res.ids)
    t_query = time.perf_counter() - t0

    gt_ids, gt_dist = refine.bruteforce_topk(base, queries, k)
    hits = sum(len(set(got[i].tolist()) & set(gt_ids[i].tolist()))
               for i in range(q))
    recall = hits / (q * k)
    mean_cands = float(np.asarray(routed.n_unique).mean())
    print(f"n={n} d={d} q={q} k={k}")
    print(f"build: {t_build:.2f}s  query(total): {t_query:.2f}s "
          f"({q / t_query:.1f} q/s incl. compile)")
    print(f"mean unique candidates: {mean_cands:.0f} "
          f"({100 * mean_cands / n:.1f}% of corpus)")
    print(f"recall@{k}: {recall:.4f}")
    return recall


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:4]]
    r = main(*args)
    sys.exit(0 if r > 0.8 else 1)
