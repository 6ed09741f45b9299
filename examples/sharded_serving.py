"""Mesh-sharded serving demo: corpus-sharded routing + cross-chip top-k.

Runs on whatever devices are available — set
``XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu``
for a virtual 8-device mesh.

Usage: python examples/sharded_serving.py [n] [d] [q]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from fspann.ops import coding, refine
from fspann.parallel.sharded import ShardedIndex, make_mesh


def main(n=100_000, d=64, q=64, k=10):
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(256, d)).astype(np.float32) * 6
    base = centers[rng.integers(0, 256, n)] + \
        rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, 256, q)] + \
        rng.normal(size=(q, d)).astype(np.float32)

    mesh = make_mesh()
    print(f"mesh: {mesh.devices.size} devices ({mesh.devices.flat[0].platform})")
    bank = coding.build_bank_from_sample(base[:2000], m=16, lam=2, tables=4,
                                         divisions=2, seed=13)
    idx = ShardedIndex(mesh, bank)
    t0 = time.perf_counter()
    idx.build(base)
    print(f"sharded build: {time.perf_counter()-t0:.2f}s "
          f"({idx.shard_rows} rows/device)")

    t0 = time.perf_counter()
    ids, dist = idx.query(queries, probes=4, refinement_limit=2048, k=k)
    t1 = time.perf_counter()
    ids2, _ = idx.query(queries, probes=4, refinement_limit=2048, k=k)
    t2 = time.perf_counter()
    gt_ids, _ = refine.bruteforce_topk(base, queries, k)
    hits = sum(len(set(ids[i].tolist()) & set(gt_ids[i].tolist()))
               for i in range(q))
    print(f"recall@{k}: {hits/(q*k):.4f}")
    print(f"query: {t1-t0:.2f}s cold, {t2-t1:.3f}s warm "
          f"({q/(t2-t1):.0f} q/s)")
    return hits / (q * k)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:4]]
    r = main(*args)
    sys.exit(0 if r > 0.8 else 1)
