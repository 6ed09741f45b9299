"""A/B: fused decrypt-and-score (load_score_batch) with f32/f16/i8 payloads.

The pre-fusion f16 path lost on this DRAM-starved host because the widened
f32 row had to be WRITTEN to the staging matrix (a full extra DRAM pass).
The fused scored path (aes_gcm.c:534-556) decrypts into stack scratch and
widens in L1 — the only DRAM traffic per open is the arena record READ,
which f16 halves (272B vs 528B at 128-d) and i8 quarters (148B).  This
measures whether the quantized payloads win stage B outright.

Usage: JAX_PLATFORMS=cpu python scripts/ab_f16_scored.py [N] [OPENS] [REPS]
"""

import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_store(work, tag, dtype, vecs):
    from fspann.crypto.keys import KeyManager
    from fspann.store.point_store import PointStore

    km = KeyManager(os.path.join(work, f"ks_{tag}.blob"))
    store = PointStore(os.path.join(work, f"db_{tag}"), km, dim=vecs.shape[1],
                       dtype=dtype)
    n = len(vecs)
    for s in range(0, n, 100_000):
        e = min(s + 100_000, n)
        store.insert_batch(np.arange(s, e), vecs[s:e])
    return store


def run(store, ids, qvecs, r, reps):
    n = len(ids)
    norms = np.zeros(n, np.float32)
    dots = np.zeros(n, np.float32)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        ok = store.load_score_batch(ids, qvecs, r, norms, dots)
        best = min(best, time.perf_counter() - t0)
        assert ok.all()   # every rep, not just the last
    return best, norms.copy(), dots.copy()


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    opens = int(sys.argv[2]) if len(sys.argv) > 2 else 131_072
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    d, q = 128, 64
    r = opens // q

    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    qvecs = rng.normal(size=(q, d)).astype(np.float32)
    # without replacement per query: duplicate candidate ids would collapse
    # in the set-based top-100 agreement metric and overstate disagreement
    ids = np.stack([rng.permutation(n)[:r] for _ in range(q)]).reshape(-1)

    work = tempfile.mkdtemp(prefix="fspann_abf16_")
    try:
        body = {"f32": 4 * d, "f16": 2 * d, "i8": d + 4}
        for dtype in ("f32", "f16", "i8"):
            t0 = time.perf_counter()
            store = build_store(work, dtype, dtype, vecs)
            build_s = time.perf_counter() - t0
            wall, norms, dots = run(store, ids, qvecs, r, reps)
            d2 = (norms - 2.0 * dots).reshape(q, r)
            top = np.argsort(d2, axis=1)[:, :100]
            if dtype == "f32":
                top_ref, d2_ref = top, d2
            ms_q = wall * 1000.0 / q
            mbps = opens * (body[dtype] + 16) / wall / 1e6
            agree = np.mean([len(set(ids.reshape(q, r)[i, top[i]]) &
                                 set(ids.reshape(q, r)[i, top_ref[i]]))
                             for i in range(q)]) / 100.0
            rel = float(np.max(np.abs(d2 - d2_ref) /
                               np.maximum(np.abs(d2_ref), 1e-6)))
            print(f"{dtype}: stage-B best {ms_q:.2f} ms/q "
                  f"({mbps:.0f} MB/s arena read), build {build_s:.0f}s, "
                  f"top-100 agree {agree:.4f}, max rel d2 err {rel:.2e}",
                  flush=True)
            store.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
