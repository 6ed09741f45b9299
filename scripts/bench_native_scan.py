#!/usr/bin/env python
"""Micro-bench of the native packed Hamming scan kernel (ops/native_scan).

Times fspann_hamming_topl at serving geometries and cross-checks a slice
against the numpy oracle.  CPU-only (no jax device use) — safe to run
while another job owns the GPU.

  NS_N=1000000 NS_W32=96 NS_Q=64 NS_L=2048 NS_TRIALS=3 NS_THREADS=1 \
      python scripts/bench_native_scan.py

Reference geometry: w32 = groups * code_words; the 1M parity default
(m=64, lam=2, tables/divisions 4x6 per configs/hard1m.json) packs to
3,072 bits = 96 uint32 words/row.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# CPU-only: never reserve the GPU's memory
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

from fspann.ops import native_scan  # noqa: E402


def main():
    n = int(os.environ.get("NS_N", 1_000_000))
    w32 = int(os.environ.get("NS_W32", 96))
    q = int(os.environ.get("NS_Q", 64))
    limit = int(os.environ.get("NS_L", 2048))
    trials = int(os.environ.get("NS_TRIALS", 3))
    threads = int(os.environ.get("NS_THREADS", 1))

    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=(n, w32), dtype=np.uint32)
    qwords = rng.integers(0, 2**32, size=(q, w32), dtype=np.uint32)

    native_scan.hamming_topl(words[:10_000], qwords, None, min(limit, 10_000),
                             threads=threads)          # warm (build + faults)
    best = float("inf")
    for t in range(trials):
        t0 = time.perf_counter()
        native_scan.hamming_topl(words, qwords, None, limit, threads=threads)
        dt = time.perf_counter() - t0
        best = min(best, dt)
        print(f"trial {t}: {dt * 1e3:.1f} ms/batch  {dt / q * 1e3:.2f} ms/q  "
              f"{n * q / dt / 1e6:.0f} Mpairs/s")

    # oracle cross-check on a slice (the full tests live in
    # tests/test_native_scan.py; this is a fast sanity gate)
    n2, l2 = 4000, 97
    ids, sc, _ = native_scan.hamming_topl(words[:n2], qwords, None, l2,
                                          threads=threads)
    bits = np.unpackbits(words[:n2].astype(">u4").view(np.uint8), axis=-1)
    qb = np.unpackbits(qwords.astype(">u4").view(np.uint8), axis=-1)
    for qi in range(q):
        ham = (bits != qb[qi]).sum(-1)
        order = np.lexsort((np.arange(n2), ham))[:l2]
        assert (ids[qi] == order).all() and (sc[qi] == ham[order]).all(), qi
    print(f"oracle ok; best {best / q * 1e3:.2f} ms/q at "
          f"[{n}x{w32 * 32} bits, Q={q}, L={limit}, threads={threads}]")


if __name__ == "__main__":
    main()
