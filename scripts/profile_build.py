"""Section-profile the 1M build: where do insert/finalize seconds go?

Wraps the build path's sections with wall-clock accumulators:

  insert:   quantize (storage-dtype round trip), seal (AES+CRC+arena+meta
            via store.insert_batch), encode (routing codes, index.stage)
  finalize: partition table build vs scan-state build (device upload)

Usage: JAX_PLATFORMS=cpu python scripts/profile_build.py [N] [M]
       (BENCH_DTYPE to vary storage dtype; BENCH_ENCODE=cpu|default to
       A/B host vs device encode — run WITHOUT JAX_PLATFORMS=cpu for the
       device side so "default" goes through the GPU)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fspann.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import numpy as np

SEC: dict[str, float] = {}


def timed(name, fn):
    def wrap(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        SEC[name] = SEC.get(name, 0.0) + time.perf_counter() - t0
        return out
    return wrap


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    m = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    d = 128
    dtype = os.environ.get("BENCH_DTYPE", "f16")

    import dataclasses
    import tempfile

    from fspann.api.system import ForwardSecureANNSystem
    from fspann.config import SystemConfig
    from fspann.io import synthetic
    from fspann.ops import coding, partition, hamming_scan
    from fspann.store import point_store as ps_mod
    from fspann.crypto import aesgcm

    t0 = time.perf_counter()
    base, _q = synthetic.lsh_hard_corpus(n, d, 8, seed=42)
    print(f"corpus: {time.perf_counter()-t0:.1f}s", flush=True)

    cfg = SystemConfig()
    cfg = dataclasses.replace(
        cfg,
        paper=dataclasses.replace(cfg.paper, tables=8, m=m),
        runtime=dataclasses.replace(
            cfg.runtime, probe_override=16, block_size=128,
            refinement_limit=56000, max_global_candidates=56000,
            rerank_limit=2000, adaptive_decrypt_margin=40,
            routing_mode="scan", storage_dtype=dtype,
            encode_backend=os.environ.get("BENCH_ENCODE", "cpu")))

    # section wraps
    coding.encode_numpy = timed("encode", coding.encode_numpy)

    _dev_encode = coding.encode

    def _timed_dev_encode(*a, **kw):
        t0 = time.perf_counter()
        out = _dev_encode(*a, **kw)
        import jax as _jax
        out = _jax.block_until_ready(out)   # charge the device round trip here
        SEC["encode"] = SEC.get("encode", 0.0) + time.perf_counter() - t0
        return out

    coding.encode = _timed_dev_encode
    partition.build_partitions_numpy = timed(
        "table_build", partition.build_partitions_numpy)
    hamming_scan.build_scan_state = timed(
        "scan_state", hamming_scan.build_scan_state)
    hamming_scan.build_scan_state_packed = timed(
        "scan_state", hamming_scan.build_scan_state_packed)
    ps_mod.PointStore.quantize_parts = timed(
        "quantize", ps_mod.PointStore.quantize_parts)
    aesgcm.seal_batch = timed("seal", aesgcm.seal_batch)
    ps_mod.aesgcm.seal_batch = aesgcm.seal_batch
    ps_mod.PointStore.insert_batch = timed(
        "store_insert", ps_mod.PointStore.insert_batch)

    # localize the "insert-other" gap: rotation checks, staging entry,
    # bank init
    from fspann.crypto import rotation as rot_mod
    from fspann.index import service as idx_mod
    rot_mod.KeyRotationService.rotate_if_needed = timed(
        "rotate_check", rot_mod.KeyRotationService.rotate_if_needed)
    idx_mod.PartitionedIndex.stage = timed(
        "stage_total", idx_mod.PartitionedIndex.stage)
    idx_mod.PartitionedIndex._init_bank = timed(
        "bank_init", idx_mod.PartitionedIndex._init_bank)

    with tempfile.TemporaryDirectory(prefix="fspann_pb_") as work:
        sys_ = ForwardSecureANNSystem(cfg, os.path.join(work, "db"), d,
                                      query_batch=64)
        t0 = time.perf_counter()
        sys_.index_stream(base, batch_size=100_000)
        t_ins = time.perf_counter() - t0
        t0 = time.perf_counter()
        sys_.finalize_for_search()
        t_fin = time.perf_counter() - t0
        print(f"insert wall {t_ins:.1f}s  finalize wall {t_fin:.1f}s")
        other_ins = t_ins - SEC.get("quantize", 0) - SEC.get(
            "store_insert", 0) - SEC.get("encode", 0)
        print("sections (s):")
        for k in ("quantize", "seal", "store_insert", "encode",
                  "stage_total", "bank_init", "rotate_check",
                  "table_build", "scan_state"):
            print(f"  {k:12s} {SEC.get(k, 0.0):7.1f}")
        print(f"  {'insert-other':12s} {other_ins:7.1f}  "
              f"(staging concat, stream slicing, rotation checks)")
        sys_.shutdown()


if __name__ == "__main__":
    main()
