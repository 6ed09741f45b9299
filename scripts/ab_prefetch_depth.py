"""Interleaved A/B of the open-loop software-prefetch depth (FSPANN_PF_DEPTH).

Builds ONE store, then cycles depths round-robin so host-weather drift hits
every depth equally (the per-minute DRAM bandwidth on this shared VM swings
2-3x; consecutive-block comparisons are meaningless).  The depth is read
once per process in C, so each depth runs in a SUBPROCESS.

Usage: JAX_PLATFORMS=cpu python scripts/ab_prefetch_depth.py [N] [OPENS] \
           [ROUNDS] [DTYPE]
"""

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

_WORKER = r"""
import os, sys, time
sys.path.insert(0, {root!r})
import numpy as np
from fspann.crypto.keys import KeyManager
from fspann.store.point_store import PointStore

work, dtype, n, opens, q = {work!r}, {dtype!r}, {n}, {opens}, 64
km = KeyManager(os.path.join(work, "ks.blob"))
store = PointStore(os.path.join(work, "db"), km, dim=128, dtype=dtype)
r = opens // q
rng = np.random.default_rng(7)
ids = np.stack([rng.permutation(n)[:r] for _ in range(q)]).reshape(-1)
qvecs = rng.normal(size=(q, 128)).astype(np.float32)
norms = np.zeros(opens, np.float32)
dots = np.zeros(opens, np.float32)
best = float("inf")
for _ in range(3):
    t0 = time.perf_counter()
    ok = store.load_score_batch(ids, qvecs, r, norms, dots)
    best = min(best, time.perf_counter() - t0)
    assert ok.all()
print(best)
store.close()
"""


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    opens = int(sys.argv[2]) if len(sys.argv) > 2 else 131_072
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    dtype = sys.argv[4] if len(sys.argv) > 4 else "f16"
    depths = [1, 4, 8, 2]

    work = tempfile.mkdtemp(prefix="fspann_pf_")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        from fspann.crypto.keys import KeyManager
        from fspann.store.point_store import PointStore

        km = KeyManager(os.path.join(work, "ks.blob"))
        store = PointStore(os.path.join(work, "db"), km, dim=128,
                           dtype=dtype)
        rng = np.random.default_rng(0)
        import time
        t0 = time.perf_counter()
        for s in range(0, n, 100_000):
            e = min(s + 100_000, n)
            store.insert_batch(
                np.arange(s, e),
                rng.normal(size=(e - s, 128)).astype(np.float32))
        store.close()
        print(f"build: {time.perf_counter()-t0:.0f}s", flush=True)

        code = _WORKER.format(root=root, work=work, dtype=dtype, n=n,
                              opens=opens)
        results = {d: [] for d in depths}
        for rnd in range(rounds):
            for d in depths:
                env = dict(os.environ, FSPANN_PF_DEPTH=str(d),
                           JAX_PLATFORMS="cpu")
                out = subprocess.run([sys.executable, "-c", code], env=env,
                                     capture_output=True, text=True)
                if out.returncode != 0:
                    print(out.stderr[-2000:])
                    raise SystemExit(1)
                wall = float(out.stdout.strip().splitlines()[-1])
                results[d].append(wall * 1000.0 / 64)
                print(f"round {rnd} depth {d}: {wall*1000/64:.3f} ms/q",
                      flush=True)
        print(json.dumps({str(d): {"best": round(min(v), 3),
                                   "median": round(sorted(v)[len(v)//2], 3)}
                          for d, v in results.items()}))
    finally:
        import shutil
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
