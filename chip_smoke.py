#!/usr/bin/env python3
"""Bring-up check of the encrypted ANN serving path on NVIDIA GPUs.

Drives the system through its normal entry points at the served operating
point (1M x 128 LSH-hard corpus, 3,072-bit scan codes, f16 payloads, decrypt
budget L=2,000), compares every device stage with the repo's plain
reference, and times the scan's top-L selection.  One process; the only
child it starts is ``nvidia-smi``.

    python chip_smoke.py              # phases 1-5 on one GPU
    python chip_smoke.py --chips 4    # the four-GPU mesh phase alone

Exits 0 only when every phase passed; the last stdout line is then
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU it prints ``{"ok": false, ...}`` and exits non-zero.  Every
time printed here is informative: the benchmark is ``bench.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

# the served operating point (bench.py)
SERVE_N, SERVE_D, SERVE_Q = 1_000_000, 128, 1024
MESH_N, MESH_Q = 4_000_000, 256
LIMIT = 2000
BATCH = 64
INSERT_BATCH = 100_000
SEED = 42
MIN_RECALL10 = 0.99      # acceptance limits against exact ground truth
MAX_RATIO100 = 1.01
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet peak, at a 700 W limit


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(key: str, value) -> None:
    if not isinstance(value, str):
        value = json.dumps(value, sort_keys=True, default=str)
    print(f"{key}: {value}", flush=True)


def served_config():
    """The serving configuration of ``bench.py`` (scan routing, f16)."""
    from fspann.config import EvalConfig, SystemConfig

    cfg = SystemConfig()
    return dataclasses.replace(
        cfg, paper=dataclasses.replace(cfg.paper, tables=8, m=64),
        runtime=dataclasses.replace(
            cfg.runtime, routing_mode="scan", storage_dtype="f16",
            probe_override=16, block_size=128, refinement_limit=56_000,
            max_global_candidates=56_000, rerank_limit=LIMIT,
            adaptive_decrypt_margin=40),
        eval=EvalConfig(k_variants=(1, 10, 100))).validate()


# -- phase 1: device ----------------------------------------------------------

def host_cpu_flags() -> dict:
    """The ISA flags the native AES-GCM and scan libraries dispatch on
    (``__builtin_cpu_supports`` at run time)."""
    want = ("aes", "pclmulqdq", "vaes", "vpclmulqdq", "avx512f",
            "avx512bw", "avx512_vpopcntdq", "f16c")
    try:
        with open("/proc/cpuinfo") as f:
            line = next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        return {}
    have = set(line.split(":", 1)[-1].split())
    return {k: k in have for k in want}


def device_phase() -> dict:
    import jax
    import jaxlib

    devs = jax.devices()
    say("jax", f"{jax.__version__} jaxlib {jaxlib.__version__}")
    say("devices", str(devs))
    say("device_kind", devs[0].device_kind)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable: {e}"
    for line in smi.splitlines():
        print(line, flush=True)
    flags = host_cpu_flags()
    aes = "vaes+vpclmulqdq (avx512)" if (
        flags.get("vaes") and flags.get("vpclmulqdq")
        and flags.get("avx512f") and flags.get("avx512bw")) else "aes-ni+pclmul"
    scan = "avx512 vpopcntdq" if (
        flags.get("avx512f") and flags.get("avx512_vpopcntdq")) else "popcnt"
    say("host_cpu_flags", flags)
    say("host_paths", {"aes_gcm": aes, "native_scan": scan,
                       "cpus": os.cpu_count()})
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": smi}


# -- phase 2: serve -----------------------------------------------------------

def _search_all(sys_, queries, k: int, batch: int):
    """Ranked ids/distances for every query through the query service."""
    batches = [sys_.tokens.create_batch(queries[s:s + batch], k)
               for s in range(0, len(queries), batch)]
    res = sys_.query_service.search_batches(batches)
    return (np.concatenate([r.ids for r in res]),
            np.concatenate([r.distances for r in res]))


def _stage_means(rows) -> dict:
    nq = max(len(rows), 1)
    return {s: sum(getattr(r, s + "_ms") for r in rows) / nq
            for s in ("route", "decrypt", "refine")}


def serve_phase(workdir: str, n: int, d: int, nq: int, *, batch: int = BATCH,
                insert_batch: int = INSERT_BATCH, seed: int = SEED,
                require_device_scan: bool = True) -> dict:
    """Build, ground truth, serve every query, rotate + re-encrypt, serve
    again.  Raises unless recall/ratio hold and rotation changes nothing."""
    import jax
    from fspann.api.system import ForwardSecureANNSystem
    from fspann.io import groundtruth, synthetic

    base, queries = synthetic.lsh_hard_corpus(n, d, nq, seed=seed)
    sys_ = ForwardSecureANNSystem(served_config(), workdir, d,
                                  query_batch=batch)
    t0 = time.perf_counter()
    sys_.index_stream(base, batch_size=insert_batch)
    t_insert = time.perf_counter() - t0
    t0 = time.perf_counter()
    sys_.finalize_for_search()
    t_finalize = time.perf_counter() - t0
    st = sys_.index._scan_state
    if require_device_scan:
        check(st is not None, "no device scan state was built")
        plat = next(iter(st.bits.devices())).platform
        check(plat == jax.devices()[0].platform,
              f"scan state lives on {plat}")
    t0 = time.perf_counter()
    gtm = groundtruth.precompute(base, queries, k=100)
    t_gt = time.perf_counter() - t0

    sys_.run_queries(queries[:batch], gtm, base, ks=(10,))   # compile
    sys_.profiler.clear_rows()
    t0 = time.perf_counter()
    agg = sys_.run_queries(queries, gtm, base, ks=(1, 10, 100))
    wall = time.perf_counter() - t0
    rows = [r for r in sys_.profiler.rows if r.k == 10]
    ids0, dist0 = _search_all(sys_, queries, 100, batch)

    reenc = sys_.run_selective_reencryption()
    sys_.profiler.clear_rows()
    agg2 = sys_.run_queries(queries, gtm, base, ks=(1, 10, 100))
    ids1, dist1 = _search_all(sys_, queries, 100, batch)

    out = {
        "n": n, "d": d, "queries": nq,
        "code_bits": sys_.cfg.paper.num_groups * sys_.cfg.paper.code_bits,
        "recall_at_10": agg.recall_at_k[10],
        "recall_at_100": agg.recall_at_k[100],
        "distance_ratio_at_100": agg.ratio_at_k[100],
        "informative_times": {
            "build_s": t_insert + t_finalize, "insert_s": t_insert,
            "finalize_s": t_finalize, "gt_s": t_gt,
            "qps": nq / wall, "art_ms": agg.mean_art_ms,
            "stage_means_ms": _stage_means(rows)},
        "reencryption": {k: reenc.get(k) for k in
                         ("old_version", "new_version", "touched",
                          "reencrypted", "failed")},
        "recall_at_10_after_rotation": agg2.recall_at_k[10],
    }
    say("serve", out)
    check(reenc.get("new_version", 0) > reenc.get("old_version", 0),
          f"rotation did not advance the key version: {reenc}")
    check(reenc.get("reencrypted", 0) > 0, "nothing was re-encrypted")
    check(np.array_equal(ids0, ids1), "ids changed after rotation")
    check(np.array_equal(dist0, dist1), "distances changed after rotation")
    check(agg2.recall_at_k == agg.recall_at_k,
          "recall changed after rotation")
    check(out["recall_at_10"] >= MIN_RECALL10,
          f"recall@10 {out['recall_at_10']} < {MIN_RECALL10}")
    check(out["distance_ratio_at_100"] <= MAX_RATIO100,
          f"ratio@100 {out['distance_ratio_at_100']} > {MAX_RATIO100}")
    bank_sample = sys_.store.quantize(base[:insert_batch])
    return {"system": sys_, "base": base, "queries": queries,
            "bank_sample": bank_sample, "metrics": out}


# -- phase 3: scan vs the native reference ------------------------------------

def _hamming_host(codes: np.ndarray, qcode: np.ndarray,
                  ids: np.ndarray) -> np.ndarray:
    x = np.bitwise_xor(codes[ids].reshape(len(ids), -1),
                       qcode.reshape(1, -1))
    return np.unpackbits(x.view(np.uint8), axis=1).sum(axis=1)


def compare_topl(dev_ids, dev_sc, ref_ids, ref_sc, codes, qcodes) -> int:
    """Exact top-L equality: per-query score vectors equal, id sets equal
    except among ids tied at the L-th score, and each device id's reported
    score is its true Hamming distance.  Returns the tie-reordered count."""
    dev_ids, dev_sc = np.asarray(dev_ids), np.asarray(dev_sc)
    check(dev_ids.shape == ref_ids.shape,
          f"shape {dev_ids.shape} != reference {ref_ids.shape}")
    bad = np.flatnonzero(~np.all(dev_sc == ref_sc, axis=1))
    check(not len(bad), f"{len(bad)} queries' scores differ from the "
          f"reference (first: q{bad[:1]})")
    ties = 0
    for qi in range(len(dev_ids)):
        live = dev_ids[qi] >= 0
        check(np.array_equal(live, ref_ids[qi] >= 0),
              f"q{qi}: live counts differ")
        di, ri = dev_ids[qi][live], ref_ids[qi][live]
        check(len(np.unique(di)) == len(di), f"q{qi}: duplicate ids")
        if not len(di):
            continue
        s_l = dev_sc[qi][live][-1]
        head = dev_sc[qi][live] < s_l
        check(set(di[head]) == set(ri[head]),
              f"q{qi}: ids above the L-th score differ")
        ties += len(set(di[~head]) ^ set(ri[~head])) // 2
        true = _hamming_host(codes, qcodes[qi], di)
        check(np.array_equal(true, dev_sc[qi][live]),
              f"q{qi}: reported scores are not the true distances")
    return ties


def scan_phase(index, queries, limit: int = LIMIT, batch: int = BATCH,
               n_batches: int = 16) -> dict:
    """``hamming_scan.scan`` on the served scan state vs
    ``native_scan.scan_topl`` over the same packed codes."""
    import jax.numpy as jnp
    from fspann.ops import hamming_scan, native_scan

    codes = index._scan_codes
    cb = index.cfg.paper.code_bits
    state = index._scan_state
    if state is None:   # CPU serving keeps only the packed codes
        state = hamming_scan.build_scan_state(codes, cb)
    tomb = jnp.zeros(state.bits.shape[0], bool)
    ties = 0
    t_dev = t_ref = 0.0
    nb = min(n_batches, len(queries) // batch)
    check(nb > 0, "not enough queries for one batch")
    for b in range(nb):
        qc, _ = index.encode_queries(queries[b * batch:(b + 1) * batch])
        qc = np.asarray(qc)
        qbits = jnp.asarray(hamming_scan.unpack_bits_numpy(qc, cb))
        t0 = time.perf_counter()
        res = hamming_scan.scan(state, qbits, tomb, limit)
        dev_ids, dev_sc = np.asarray(res.ids), np.asarray(res.scores)
        t_dev += time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = native_scan.scan_topl(codes, qc, None, limit)
        t_ref += time.perf_counter() - t0
        ties += compare_topl(dev_ids, dev_sc, ref.ids, ref.scores, codes, qc)
    out = {"batches": nb, "queries": nb * batch, "limit": limit,
           "tie_reordered_ids": ties,
           "informative_times": {"device_s": t_dev, "native_s": t_ref}}
    say("scan_vs_native", out)
    return out


# -- phase 4: top-L selection, measured ----------------------------------------

def lowering_summary(hlo: str) -> dict:
    """What XLA made of a jitted function: library calls, fusion kinds,
    sorts."""
    return {
        "custom_calls": sorted(set(re.findall(
            r'custom_call_target="([^"]+)"', hlo))),
        "fusion_backends": sorted(set(re.findall(
            r'"kind":"(__[A-Za-z_$]+)"', hlo))),
        "sorts": len(re.findall(r"\bsort\(", hlo)),
        "topk_ops": len(re.findall(r"\btopk\(", hlo, re.I)),
    }


def _median_time(fn, *args, repeats: int) -> float:
    import jax

    jax.block_until_ready(fn(*args))   # warm-up (compiles)
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def topl_phase(state, qbits, limit: int = LIMIT, repeats: int = 20) -> dict:
    """Median times of the scan with each selection and of the int8 matmul
    alone, what each lowered to, and the matmul's byte-bound share."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from fspann.ops import hamming_scan

    n = state.bits.shape[0]
    tomb = jnp.zeros(n, bool)
    dot = jax.jit(lambda q, b: jax.lax.dot_general(
        q, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32))
    fns = {
        "scan_approx": partial(hamming_scan.scan, limit=limit, approx=True),
        "scan_exact": partial(hamming_scan.scan, limit=limit, approx=False),
    }
    out = {"shape": [int(qbits.shape[0]), int(n), int(qbits.shape[1])],
           "limit": limit, "times_ms": {}, "lowered": {}}
    results = {}
    for name, fn in fns.items():
        out["times_ms"][name] = 1e3 * _median_time(
            fn, state, qbits, tomb, repeats=repeats)
        hlo = hamming_scan.scan.lower(
            state, qbits, tomb, limit=limit,
            approx=name == "scan_approx").compile().as_text()
        out["lowered"][name] = lowering_summary(hlo)
        results[name] = fn(state, qbits, tomb)
    out["times_ms"]["int8_dot"] = 1e3 * _median_time(
        dot, qbits, state.bits, repeats=repeats)
    out["lowered"]["int8_dot"] = lowering_summary(
        dot.lower(qbits, state.bits).compile().as_text())
    matrix_bytes = int(state.bits.size) * state.bits.dtype.itemsize
    bound_ms = 1e3 * matrix_bytes / HBM_BYTES_PER_S
    out["int8_dot_byte_bound_ms"] = bound_ms
    out["int8_dot_share_of_byte_bound"] = bound_ms / out["times_ms"]["int8_dot"]
    say("topl", out)
    a, e = results["scan_approx"], results["scan_exact"]
    check(np.array_equal(np.asarray(a.scores), np.asarray(e.scores)),
          "approx and exact selections give different scores")
    return out


# -- phase 5: encode determinism ------------------------------------------------

def encode_phase(base, served_bank, bank_sample, rows: int = 100_000) -> dict:
    """Device ``coding.encode`` vs host ``coding.encode_numpy`` on corpus
    rows, and the LSH bank's pinning to the CPU backend."""
    import jax
    import jax.numpy as jnp
    from fspann.ops import coding

    b = served_bank
    x = np.ascontiguousarray(base[:rows], np.float32)
    bank_dev = coding.GBank(jnp.asarray(b.alpha), jnp.asarray(b.r),
                            jnp.asarray(b.omega), b.m, b.lam, b.tables,
                            b.divisions, b.seed)
    xd = jnp.asarray(x)
    jax.block_until_ready(coding.encode(xd, bank_dev))   # compile
    t0 = time.perf_counter()
    codes_dev = np.asarray(jax.block_until_ready(coding.encode(xd,
                                                               bank_dev))[0])
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    codes_np, _ = coding.encode_numpy(x, b)
    t_np = time.perf_counter() - t0
    diff = codes_dev != codes_np
    rebuilt = coding.build_bank_from_sample(
        bank_sample, b.m, b.lam, b.tables, b.divisions, b.seed)
    restored = coding.bank_from_stats(b.omega, b.r, b.d, b.m, b.lam,
                                      b.tables, b.divisions, b.seed)
    # what the stats would be if the bank were built on the default device
    dflt = jax.devices()[0]
    r_dev, om_dev = coding._omega_from_sample(
        jax.device_put(np.asarray(bank_sample, np.float32), dflt),
        jax.device_put(b.alpha, dflt),
        jax.device_put(coding._r_unit_from_seed(b.seed, b.g, b.m), dflt), 2.5)
    out = {
        "rows": rows,
        "code_rows_differ_share": float(diff.any(axis=(1, 2)).mean()),
        "code_words_differ": int(diff.sum()),
        "bank_host_arrays": all(isinstance(a, np.ndarray)
                                for a in (b.alpha, b.r, b.omega)),
        "default_device_bank_equal": bool(
            np.array_equal(np.asarray(om_dev), b.omega)
            and np.array_equal(np.asarray(r_dev), b.r)),
        "informative_times": {"device_encode_s": t_dev,
                              "numpy_encode_s": t_np},
    }
    say("encode", out)
    check(out["bank_host_arrays"], "the bank is not held in host arrays")
    for name, other in (("rebuilt", rebuilt), ("restored", restored)):
        for f in ("alpha", "r", "omega"):
            check(np.array_equal(getattr(other, f), getattr(b, f)),
                  f"{name} bank.{f} differs from the served bank")
    return out


# -- phase 6: the mesh (four GPUs) --------------------------------------------

def _host_codes(index) -> np.ndarray:
    """Packed uint32 codes [N_pad, G, W] rebuilt on the host from each
    shard's device bit matrix (MSB-first, ops/coding.py)."""
    bank = index.bank
    g, cb, w = bank.g, bank.code_bits, bank.code_words
    parts = []
    for shard in index._per_device(index.bits):
        bits = np.asarray(shard).view(np.uint8).reshape(-1, g, cb)
        if w * 32 > cb:
            bits = np.pad(bits, ((0, 0), (0, 0), (0, w * 32 - cb)))
        parts.append(np.packbits(bits, axis=-1).view(">u4")
                     .astype(np.uint32).reshape(-1, g, w))
    return np.concatenate(parts)


def _bucket_indices(codes: np.ndarray, m: int, lam: int) -> np.ndarray:
    """The lam-bit bucket index of every projection in packed codes
    [N, G, W] (the inverse of ``coding.pack_codes``): int64 [N, G, m]."""
    bits = np.unpackbits(codes.astype(">u4").view(np.uint8), axis=-1)
    bits = bits[..., :lam * m].reshape(*codes.shape[:-1], lam, m)
    weights = np.int64(1) << np.arange(lam - 1, -1, -1, dtype=np.int64)
    return np.einsum("...lm,l->...m", bits.astype(np.int64), weights)


def _encode_numpy_parallel(x: np.ndarray, bank, block: int = 131_072):
    from concurrent.futures import ThreadPoolExecutor

    from fspann.ops import coding

    with ThreadPoolExecutor(min(16, os.cpu_count() or 1)) as ex:
        parts = ex.map(lambda s: coding.encode_numpy(x[s:s + block], bank)[0],
                       range(0, len(x), block))
        return np.concatenate(list(parts))


def host_codes_checked(x, bank, dev_codes: np.ndarray,
                       what: str) -> tuple[np.ndarray, int]:
    """``coding.encode_numpy`` codes of ``x``, held against the codes the
    device holds for the same rows.  A row may differ only in projections
    that sit on a bucket edge, where f32 summation order decides the floor;
    such rows take the device's codes, so the result is what the device
    must score.  Any other difference (a misplaced shard row, a wrong
    unpack) raises.  Returns the codes and the count of rows that differ."""
    x = np.asarray(x, np.float32)
    codes = _encode_numpy_parallel(x, bank)
    check(codes.shape == dev_codes.shape,
          f"{what}: device codes {dev_codes.shape} != host {codes.shape}")
    rows = np.flatnonzero((codes != dev_codes).any(axis=(1, 2)))
    check(len(rows) <= max(8, len(x) // 1000),
          f"{what}: {len(rows)} of {len(x)} rows differ from the host encode")
    if len(rows):
        h_host = _bucket_indices(codes[rows], bank.m, bank.lam)
        h_dev = _bucket_indices(dev_codes[rows], bank.m, bank.lam)
        t = ((np.einsum("nd,gmd->ngm", x[rows].astype(np.float64),
                        np.asarray(bank.alpha, np.float64))
              + np.asarray(bank.r, np.float64))
             / np.asarray(bank.omega, np.float64))
        off = h_host != h_dev
        edge = np.abs(t - np.round(t)) <= 1e-4 * np.maximum(1.0, np.abs(t))
        step = (h_host - h_dev) % (1 << bank.lam)
        check(bool(np.all(edge[off]))
              and bool(np.all((step[off] == 1)
                              | (step[off] == (1 << bank.lam) - 1))),
              f"{what}: rows {rows[:4]} differ away from a bucket edge")
        codes[rows] = dev_codes[rows]
    return codes, len(rows)


def mesh_phase(workdir: str, n: int, d: int, nq: int, n_devices: int, *,
               batch: int = BATCH, insert_batch: int = INSERT_BATCH,
               seed: int = SEED, limit: int = LIMIT) -> dict:
    """``DistributedEncryptedSystem`` over ``n_devices``: shard placement,
    the codes each shard holds vs the host encode of every row, the mesh
    scan vs the native reference over those host codes, the host merge vs
    the device all_gather merge, recall vs brute force, rotation."""
    import jax
    import jax.numpy as jnp
    from fspann.io import groundtruth, synthetic
    from fspann.ops import coding, native_scan
    from fspann.parallel.serving import DistributedEncryptedSystem
    from fspann.parallel.sharded import make_mesh

    mesh = make_mesh(n_devices)
    check(mesh.devices.size == n_devices,
          f"mesh has {mesh.devices.size} devices, want {n_devices}")
    base, queries = synthetic.lsh_hard_corpus(n, d, nq, seed=seed)
    dsys = DistributedEncryptedSystem(served_config(), workdir, d, mesh=mesh)
    t0 = time.perf_counter()
    dsys.index_stream(base, batch_size=insert_batch)
    t_build = time.perf_counter() - t0
    idx = dsys.index

    mesh_devs = list(mesh.devices.flat)
    placement = {}
    for name in ("bits", "popc", "tombs"):
        shards = getattr(idx, name).addressable_shards
        devs = [s.device for s in shards]
        check(sorted(devs, key=lambda x: x.id)
              == sorted(mesh_devs, key=lambda x: x.id),
              f"{name} shards sit on {devs}, not one per mesh device")
        check(all(s.data.shape[0] == idx.shard_rows for s in shards),
              f"{name} shards are not {idx.shard_rows} rows each")
        placement[name] = [str(x) for x in devs]
    in_use = {}
    for dv in mesh_devs:
        stats = dv.memory_stats() or {}
        in_use[str(dv)] = stats.get("bytes_in_use")
    bits_shard = idx.shard_rows * idx.bits.shape[1]
    if all(v is not None for v in in_use.values()):
        check(all(v >= bits_shard for v in in_use.values()),
              f"a device holds less than one bit-matrix shard: {in_use}")

    batches = [queries[i * batch:(i + 1) * batch]
               for i in range(nq // batch)]
    check(len(batches) > 0, "not enough queries for one batch")
    res0 = dsys.search_batches(batches, k=10)

    t0 = time.perf_counter()
    # the mesh routes the corpus as the store will decode it (f16 here)
    codes, rows_differ = host_codes_checked(dsys.store.quantize(base),
                                            idx.bank, _host_codes(idx)[:n],
                                            "corpus")
    t_ref_encode = time.perf_counter() - t0
    enc = jax.jit(lambda q: coding.encode(q, idx.bank)[0])
    ties = q_rows_differ = 0
    for qb in batches:
        idx.merge_backend = "device"
        ids_d, sc_d = idx.scan_route(qb, limit=limit)
        idx.merge_backend = "host"
        ids_h, sc_h = idx.scan_route(qb, limit=limit)
        idx.merge_backend = "device"
        check(np.array_equal(ids_d, ids_h) and np.array_equal(sc_d, sc_h),
              "host merge differs from the device all_gather merge")
        qc, nd = host_codes_checked(
            qb, idx.bank, np.asarray(enc(jnp.asarray(qb, jnp.float32))),
            "queries")
        q_rows_differ += nd
        ref = native_scan.scan_topl(codes, qc, None, limit)
        ties += compare_topl(ids_d, sc_d, ref.ids, ref.scores, codes, qc)

    gt = groundtruth.precompute(base, queries[:len(batches) * batch], k=10)
    got = np.concatenate([r[0] for r in res0])
    recall10 = float(np.mean([len(set(got[i]) & set(gt.gt[i])) / 10
                              for i in range(len(got))]))
    migrated = dsys.rotate_and_migrate()
    res1 = dsys.search_batches(batches, k=10)
    same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(res0, res1))
    out = {"n": n, "devices": n_devices, "shard_rows": idx.shard_rows,
           "placement": placement, "bytes_in_use": in_use,
           "queries": len(got), "recall_at_10": recall10,
           "code_rows_differ": {"corpus": rows_differ,
                                "queries": q_rows_differ},
           "tie_reordered_ids": ties, "migrated": str(migrated),
           "informative_times": {"build_s": t_build,
                                 "host_encode_s": t_ref_encode}}
    say("mesh", out)
    check(same, "results changed after rotation")
    check(recall10 >= MIN_RECALL10, f"mesh recall@10 {recall10} < "
          f"{MIN_RECALL10}")
    dsys.close()
    return out


# -- driver -------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run the four-GPU mesh phase alone")
    args = ap.parse_args(argv)

    try:
        import fspann  # noqa: F401 — widens jax_platforms before backends start
    except ImportError as e:
        print(json.dumps({"ok": False, "error": f"fspann not importable: {e}"}),
              flush=True)
        return 2
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(json.dumps({"ok": False, "error": "no GPU: JAX platform is "
                          f"{devs[0].platform}"}), flush=True)
        return 2
    if len(devs) < args.chips:
        print(json.dumps({"ok": False, "error": f"--chips {args.chips} "
                          f"but JAX sees {len(devs)} devices"}), flush=True)
        return 2
    phase = "import"
    try:
        from fspann.utils.compile_cache import enable_compile_cache

        say("compile_cache", enable_compile_cache())
        # the native reference scan uses every host core
        os.environ.setdefault("FSPANN_SCAN_THREADS", "auto")
        phase = "device"
        dev = device_phase()
        with tempfile.TemporaryDirectory(prefix="fspann_smoke_") as work:
            if args.chips == 4:
                phase = "mesh"
                mesh_phase(os.path.join(work, "mesh"), MESH_N, SERVE_D,
                           MESH_Q, 4)
            else:
                phase = "serve"
                served = serve_phase(os.path.join(work, "db"), SERVE_N,
                                     SERVE_D, SERVE_Q)
                index = served["system"].index
                phase = "scan_vs_native"
                scan_phase(index, served["queries"])
                phase = "topl"
                import jax.numpy as jnp
                from fspann.ops import hamming_scan

                qc, _ = index.encode_queries(served["queries"][:BATCH])
                qbits = jnp.asarray(hamming_scan.unpack_bits_numpy(
                    np.asarray(qc), index.cfg.paper.code_bits))
                topl_phase(index._scan_state, qbits)
                phase = "encode"
                encode_phase(served["base"], index.bank,
                             served["bank_sample"])
                served["system"].shutdown()
    except Exception as e:  # noqa: BLE001 — report the phase, exit non-zero
        traceback.print_exc()
        print(json.dumps({"ok": False, "phase": phase,
                          "error": f"{type(e).__name__}: {e}"}), flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
