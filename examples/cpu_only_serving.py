"""CPU-only encrypted serving: no accelerator anywhere in the stack.

The same framework that serves from the GPU bit-matmul scan runs
accelerator-free:
stage A goes through the native packed-word kernel
(`ops/native/hamming_topl.c`, AVX-512 when present; picked automatically by
``runtime.scan_native="auto"`` whenever no accelerator backs the scan), and
stages B/C are the host AES + BLAS paths that never needed a device.
Results are bit-identical to device serving — a host can fail over
GPU <-> CPU without a results change (tests/test_native_scan.py).

Usage: JAX_PLATFORMS=cpu python examples/cpu_only_serving.py [n] [d] [q]
"""

import dataclasses
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# CPU-only by construction: pin the platform before jax initializes a
# backend
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from fspann.api.system import ForwardSecureANNSystem
from fspann.config import SystemConfig
from fspann.io import groundtruth
from fspann.ops import native_scan


def main(n=20_000, d=32, q=32):
    print(f"native kernel available: {native_scan.available()}  "
          f"devices: {jax.devices()}")
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(64, d)).astype(np.float32) * 6
    base = centers[rng.integers(0, 64, n)] + \
        rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, 64, q)] + \
        rng.normal(size=(q, d)).astype(np.float32)

    cfg = SystemConfig()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime,
        routing_mode="scan",           # global exact code ranking
        scan_native="auto",            # native kernel on CPU (the default)
        refinement_limit=2000,
        adaptive_decrypt_margin=40,    # per-query decrypt budget
        adaptive_decrypt_anchor=100)).validate()

    work = tempfile.mkdtemp(prefix="fspann_cpu_")
    try:
        sys_ = ForwardSecureANNSystem(cfg, work + "/db", d, query_batch=16)
        t0 = time.perf_counter()
        sys_.index_stream(base, batch_size=5000)
        sys_.finalize_for_search()
        # native-only serving never builds the device bit matrix: the
        # packed codes (n x bits/8 bytes) are the whole routing state.
        # scan_native="auto" falls back to the XLA scan where the kernel
        # can't build (no cc on the host) — don't assert, report.
        if sys_.index._scan_state is None and \
                sys_.index._scan_codes is not None:
            state = (f"packed codes only "
                     f"({sys_.index._scan_codes.nbytes/1e6:.1f} MB)")
        else:
            state = "device (XLA) bit matrix — native kernel unavailable"
        print(f"indexed {n} pts in {time.perf_counter()-t0:.1f}s; scan "
              f"state = {state}")

        gtm = groundtruth.precompute(base, queries, k=100)
        t0 = time.perf_counter()
        agg = sys_.run_queries(queries, gtm, base)
        dt = time.perf_counter() - t0
        print(f"queries: {agg.paper_line()}  wall {dt:.2f}s "
              f"({q/dt:.1f} q/s)")
        assert agg.recall_at_k[10] > 0.9
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]))
