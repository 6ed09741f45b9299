#!/usr/bin/env python
"""Device-side route_rerank microbench at serving shapes: how many ms/batch
the fused routing step costs on-device (block_until_ready), vs the transfer
of its output. Separates 'device compute' from 'transfer' in the serving
route-wait."""
import sys, time
sys.path.insert(0, ".")
import numpy as np

def main():
    import jax, jax.numpy as jnp
    from fspann.ops import coding, partition, routing

    n, d, qb = 1_000_000, 128, 64
    m, lam, tables, div = 24, 2, 8, 3
    probes, block, limit = 12, 128, 4000
    rng = np.random.default_rng(0)
    base = rng.normal(size=(n, d)).astype(np.float32)
    bank_cpu = coding.build_bank_from_sample(base[:1000], m, lam, tables, div, 13)
    bank = coding.GBank(np.asarray(bank_cpu.alpha), np.asarray(bank_cpu.r),
                        np.asarray(bank_cpu.omega), m, lam, tables, div, 13)
    codes, keys = coding.encode_numpy(base, bank)
    table = partition.build_partitions_numpy(
        np.ascontiguousarray(keys.T), np.ascontiguousarray(codes.transpose(1, 0, 2)), block)
    table = jax.device_put(table)
    pc = jax.device_put(codes)
    tomb = jnp.zeros(n, bool)
    queries = base[rng.integers(0, n, qb)] + 0.1
    qc, qk = coding.encode_numpy(queries, bank)
    qc, qk = jnp.asarray(qc), jnp.asarray(qk)

    def timed(tag, fn, reps=5):
        fn()  # compile
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps * 1000
        print(f"{tag}: {dt:.1f} ms/batch ({dt/qb:.2f} ms/q)", flush=True)
        return out

    timed("route coarse p12 R=38k", lambda: routing.route(table, qc, qk, tomb, 12, 38_000))
    timed("fused p12 L=4k exact", lambda: routing.route_rerank(table, qc, qk, tomb, pc, 12, 4000))
    timed("fused p16 L=2k exact", lambda: routing.route_rerank(table, qc, qk, tomb, pc, 16, 2000))
    timed("fused p16 L=2k approx", lambda: routing.route_rerank(table, qc, qk, tomb, pc, 16, 2000, approx=True))
    out = timed("fused p12 L=2k approx", lambda: routing.route_rerank(table, qc, qk, tomb, pc, 12, 2000, approx=True))
    t0 = time.perf_counter()
    ids = np.asarray(out.ids)
    print(f"transfer [64,4000] ids: {(time.perf_counter()-t0)*1000:.1f} ms", flush=True)



def scan_bench():
    import jax, jax.numpy as jnp
    from fspann.ops import coding, hamming_scan
    n, d, qb = 1_000_000, 128, 64
    m, lam, tables, div = 24, 2, 8, 3
    rng = np.random.default_rng(0)
    base = rng.normal(size=(n, d)).astype(np.float32)
    bank = coding.build_bank_from_sample(base[:1000], m, lam, tables,
                                         div, 13)
    bank = coding.GBank(np.asarray(bank.alpha), np.asarray(bank.r),
                        np.asarray(bank.omega), m, lam, tables, div, 13)
    codes, _ = coding.encode_numpy(base, bank)
    import time as _t
    t0 = _t.perf_counter()
    state = hamming_scan.build_scan_state(codes, bank.code_bits)
    jax.block_until_ready(state.bits)
    print(f"scan state build+upload: {_t.perf_counter()-t0:.1f}s "
          f"({state.bits.nbytes/1e9:.2f} GB)", flush=True)
    queries = base[rng.integers(0, n, qb)] + 0.1
    qc, _ = coding.encode_numpy(queries, bank)
    qbits = jnp.asarray(hamming_scan.unpack_bits_numpy(qc, bank.code_bits))
    tomb = jnp.zeros(n, bool)

    def timed(tag, fn, reps=5):
        fn(); jax.block_until_ready(fn())
        t0 = _t.perf_counter()
        for _ in range(reps):
            out = fn()
        jax.block_until_ready(out)
        dt = (_t.perf_counter() - t0) / reps * 1000
        print(f"{tag}: {dt:.1f} ms/batch ({dt/qb:.2f} ms/q)", flush=True)

    timed("scan L=2k approx", lambda: hamming_scan.scan(state, qbits, tomb, 2000))
    timed("scan L=2k exact", lambda: hamming_scan.scan(state, qbits, tomb, 2000, approx=False))
    timed("scan L=8k approx", lambda: hamming_scan.scan(state, qbits, tomb, 8000))


if __name__ == "__main__":
    import os
    if os.environ.get("SCAN"):
        scan_bench()
    else:
        main()
