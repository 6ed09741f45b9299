"""Benchmark: encrypted query throughput on a SIFT1M-scale corpus.

Runs the FULL encrypted pipeline (device routing + host AES-GCM decrypt +
refine) on an NVIDIA GPU and prints ONE JSON line:

    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}

Baseline: the Java reference's best sub-1.5s profile on SIFT1M,
SIFT_P4_FAST — ART 1429.8 ms/query at recall@100 0.55 ⇒ 0.699 q/s
(BASELINE.md, measured on a ~354 GB-heap server).  The default BENCH_PROFILE
=parity runs OUR system at an operating point whose recall@100 on the
equally-hard corpus sits in the same band, so vs_baseline = q/s ÷ 0.699 is
a throughput ratio at comparable recall, not a recall-for-speed trade.

Env knobs: BENCH_N (default 1_000_000), BENCH_D (128), BENCH_Q (1024),
BENCH_BATCH (64), BENCH_DTYPE (f16 default | f32 | i8), BENCH_CORPUS
(hard|easy, default hard — the LSH-hard instance, io/synthetic.py),
BENCH_PROBES (-1 = profile default), BENCH_ROUTING (scan|probe),
BENCH_RERANK (decrypt budget L), BENCH_ENCODE (default|cpu), BENCH_REPEATS
(5 — timed pass repeats; best reported, all recorded; recall/ratio/decrypt
counts are deterministic and logged per pass).  The compile cache lives in
JAX_COMPILATION_CACHE_DIR when set, else in <repo>/.jax_cache.  A run that
finds no GPU fails.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _gpu_name_and_power() -> list[str]:
    """``nvidia-smi`` name and power limit of each card (a child process
    that stays off JAX); empty when the tool is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def _host_bw_probe(target_s: float = 2.0, size_mb: int = 128) -> float:
    """~2s host DRAM copy-bandwidth probe (GB/s = bytes copied one-way /
    elapsed; a copy moves 2x that through DRAM).  Recorded in the JSON so a
    reader of the artifact can tell host weather (shared hosts' DRAM
    bandwidth swings across minutes) from an insert-path regression — the
    host side of the build is DRAM-bound."""
    src = np.ones(size_mb * 1024 * 1024 // 8, np.float64)
    dst = np.empty_like(src)
    np.copyto(dst, src)   # touch both buffers
    reps, t0 = 0, time.perf_counter()
    while True:
        np.copyto(dst, src)
        reps += 1
        el = time.perf_counter() - t0
        if el >= target_s and reps >= 2:
            break
    return src.nbytes * reps / el / 1e9


BUILD_SEC: dict[str, float] = {}


def _timed(name, fn, sync=False):
    def wrap(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        if sync:
            import jax
            out = jax.block_until_ready(out)
        BUILD_SEC[name] = BUILD_SEC.get(name, 0.0) + time.perf_counter() - t0
        return out
    return wrap


def _install_build_stage_timers():
    """Per-stage insert/finalize wall-clock accumulators, recorded in the
    bench JSON (``build_stages``) so the artifact of record self-certifies
    the build number: a weather-slow build shows every DRAM-bound stage
    (seal/arena/quantize) proportionally inflated alongside a depressed
    ``host_bw_gbs``; a regression shows one stage growing across rounds.
    Same hooks as scripts/profile_build.py."""
    from fspann.crypto import aesgcm
    from fspann.index import service as idx_mod
    from fspann.ops import coding, hamming_scan, partition
    from fspann.store import arena as arena_mod
    from fspann.store import point_store as ps_mod

    coding.encode_numpy = _timed("encode", coding.encode_numpy)
    coding.encode = _timed("encode", coding.encode, sync=True)
    ps_mod.PointStore.quantize_parts = _timed(
        "quantize", ps_mod.PointStore.quantize_parts)
    aesgcm.seal_batch = _timed("seal", aesgcm.seal_batch)
    arena_mod.ArenaWriter.append_batch = _timed(
        "arena_write", arena_mod.ArenaWriter.append_batch)
    arena_mod.ArenaWriter.flush = _timed(
        "arena_write", arena_mod.ArenaWriter.flush)
    idx_mod.PartitionedIndex.stage = _timed(
        "stage_total", idx_mod.PartitionedIndex.stage)
    idx_mod.PartitionedIndex._init_bank = _timed(
        "bank_init", idx_mod.PartitionedIndex._init_bank)
    partition.build_partitions_numpy = _timed(
        "table_build", partition.build_partitions_numpy)
    hamming_scan.build_scan_state = _timed(
        "scan_state", hamming_scan.build_scan_state)
    hamming_scan.build_scan_state_packed = _timed(
        "scan_state", hamming_scan.build_scan_state_packed)


def _build_stage_summary(t_insert: float, t_finalize: float) -> dict:
    s = {k: round(v, 1) for k, v in BUILD_SEC.items()}
    encode = BUILD_SEC.get("encode", 0.0)
    bank_init = BUILD_SEC.get("bank_init", 0.0)
    stage_total = BUILD_SEC.get("stage_total", 0.0)
    out = {
        "encode_s": round(encode, 1),
        "quantize_s": s.get("quantize", 0.0),
        "seal_s": s.get("seal", 0.0),
        "arena_write_s": s.get("arena_write", 0.0),
        "bank_init_s": round(bank_init, 1),
        # staging minus the encode + bank init it contains = bookkeeping
        "stage_s": round(max(stage_total - encode - bank_init, 0.0), 1),
        "table_build_s": s.get("table_build", 0.0),
        "scan_state_s": s.get("scan_state", 0.0),
    }
    accounted = (BUILD_SEC.get("quantize", 0.0) + BUILD_SEC.get("seal", 0.0)
                 + BUILD_SEC.get("arena_write", 0.0) + stage_total)
    out["insert_other_s"] = round(max(t_insert - accounted, 0.0), 1)
    return out


def main():
    n = int(os.environ.get("BENCH_N", 1_000_000))
    d = int(os.environ.get("BENCH_D", 128))
    # 1024 queries (r5, was 256): at batch 64 a pass yields 16 per-batch
    # latency windows, and the tail percentiles pool all BENCH_REPEATS
    # passes (80 samples at the defaults) — 256 gave 4/pass, which made
    # p99 == p95 == max a tautology
    q = int(os.environ.get("BENCH_Q", 1024))
    batch = int(os.environ.get("BENCH_BATCH", 64))
    # f16 payloads are the serving default: full-pipeline recall at the 1M
    # parity point is BIT-EQUAL to f32 (0.9949 r@10 / 1.0007 ratio, CPU
    # exact-scan run; scoring-sim delta -0.04pp, scripts/sim_quant_recall)
    # while halving arena traffic on the AES-bound host.  i8 was measured
    # too costly for the parity gate (-1.29pp @10 at 1M; the sim shows no
    # 1-byte scheme under 0.9pp on this corpus) — it remains the capacity
    # option (storage_dtype=i8) for 100M-class hosts.
    dtype = os.environ.get("BENCH_DTYPE", "f16")
    # "default" encodes and builds on the device; "cpu" on the host
    encode_backend = os.environ.get("BENCH_ENCODE", "default")
    k = 10

    from fspann.api.system import ForwardSecureANNSystem
    from fspann.config import SystemConfig
    from fspann.io import groundtruth
    from fspann.utils.compile_cache import enable_compile_cache
    import jax

    devs = jax.devices()
    log(f"devices: {devs}")
    if devs[0].platform != "gpu":
        log(f"no GPU (JAX platform {devs[0].platform}) — refusing to run")
        sys.exit(2)
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs), "nvidia_smi": _gpu_name_and_power()}
    log(f"device: {device}")
    enable_compile_cache()
    # Corpus: "hard" (default) is the LSH-hard instance — heavy-tailed
    # anisotropic clusters + fringe queries, calibrated so recall sits in
    # the reference's real-SIFT band (R@100 0.52@5probes / 0.72@12probes at
    # 100k) instead of saturating at 1.0 like the round-1 easy mixture.
    from fspann.io import synthetic
    corpus_kind = os.environ.get("BENCH_CORPUS", "hard")
    if corpus_kind == "hard":
        base, queries = synthetic.lsh_hard_corpus(n, d, q, seed=42)
    else:
        base, queries = synthetic.easy_corpus(n, d, q, seed=42)

    work = tempfile.mkdtemp(prefix="fspann_bench_")
    try:
        import dataclasses
        cfg = SystemConfig()
        # BENCH_PROFILE=parity (default): the recall-parity operating point
        # on the hard corpus — recall@100 in the reference's measured
        # real-SIFT band (0.55-0.77), so vs_baseline compares THROUGHPUT AT
        # EQUAL RECALL, not a fast-but-blind configuration.
        # BENCH_PROFILE=fast: the default 5-probe profile (low recall on the
        # hard instance; matches round-1 conditions on the easy one).
        profile = os.environ.get("BENCH_PROFILE", "parity")
        paper_kw, rt_kw = {}, {}
        if profile == "parity" and corpus_kind == "hard":
            # Hamming scan (ops/hamming_scan.py): ONE int8 bit-matmul
            # scores every point's full code against the query batch, then
            # decrypt only the score-competitive head of the global top-2k
            # (adaptive per-query decrypt budget, margin=40 of 3,072 bits).
            # m=64 ⇒ 3,072-bit codes.  BENCH_M=48 gives the 2,304-bit
            # point, BENCH_MARGIN=0 disables the adaptive budget;
            # BENCH_ROUTING=probe gives the reference-parity multi-probe
            # path.
            paper_kw = {"tables": 8, "m": 64}
            rt_kw = {"probe_override": 16, "block_size": 128,
                     "refinement_limit": 56000,
                     "max_global_candidates": 56000,
                     "rerank_limit": 2000,
                     "adaptive_decrypt_margin": 40,
                     "routing_mode": "scan"}
        cfg = dataclasses.replace(
            cfg,
            paper=dataclasses.replace(cfg.paper, **paper_kw),
            runtime=dataclasses.replace(
                cfg.runtime, storage_dtype=dtype,
                encode_backend=encode_backend, **rt_kw))
        m_env = int(os.environ.get("BENCH_M", 0))
        if m_env:   # wider per-point codes (scan fine-ranking quality)
            cfg = dataclasses.replace(
                cfg, paper=dataclasses.replace(cfg.paper, m=m_env))
        probes_env = int(os.environ.get("BENCH_PROBES", 0))
        if probes_env:
            cfg = dataclasses.replace(
                cfg, runtime=dataclasses.replace(cfg.runtime,
                                                 probe_override=probes_env))
        limit_env = int(os.environ.get("BENCH_LIMIT", 0))
        if limit_env:
            cfg = dataclasses.replace(
                cfg, runtime=dataclasses.replace(
                    cfg.runtime, refinement_limit=limit_env,
                    max_global_candidates=limit_env))
        rerank_env = os.environ.get("BENCH_RERANK")
        if rerank_env is not None:   # "0" disables the parity default
            cfg = dataclasses.replace(
                cfg, runtime=dataclasses.replace(
                    cfg.runtime, rerank_limit=int(rerank_env)))
        margin_env = os.environ.get("BENCH_MARGIN")
        if margin_env is not None:   # adaptive per-query decrypt budget
            cfg = dataclasses.replace(
                cfg, runtime=dataclasses.replace(
                    cfg.runtime,
                    adaptive_decrypt_margin=int(margin_env)))
        routing_env = os.environ.get("BENCH_ROUTING")
        if routing_env:              # "scan" = Hamming scan stage A
            cfg = dataclasses.replace(
                cfg, runtime=dataclasses.replace(
                    cfg.runtime, routing_mode=routing_env))
        wide_env = os.environ.get("BENCH_WIDE")
        if wide_env is not None:     # 1/auto/on/off — full code-prefix
            cfg = dataclasses.replace(  # partition order past 63-bit keys
                cfg, runtime=dataclasses.replace(
                    cfg.runtime,
                    wide_keys={"1": "auto"}.get(wide_env, wide_env)))
        _install_build_stage_timers()
        host_bw_start = _host_bw_probe()
        log(f"host DRAM bandwidth probe (pre-build): {host_bw_start:.3f} GB/s")
        sys_ = ForwardSecureANNSystem(cfg, os.path.join(work, "db"),
                                      d, query_batch=batch)
        t0 = time.perf_counter()
        sys_.index_stream(base, batch_size=100_000)
        t_insert = time.perf_counter() - t0
        t0 = time.perf_counter()
        sys_.finalize_for_search()
        t_finalize = time.perf_counter() - t0
        t_build = t_insert + t_finalize
        build_stages = _build_stage_summary(t_insert, t_finalize)
        # finalize phases, measured BLOCKING inside the index (device
        # uploads + first compile land in their own keys, never in an
        # unaccounted residual)
        fin_sec = dict(getattr(sys_.index, "finalize_sec", {}))
        finalize_stages = {k + "_s": round(v, 1) for k, v in fin_sec.items()}
        finalize_stages["finalize_other_s"] = round(
            max(t_finalize - sum(fin_sec.values()), 0.0), 1)
        host_bw_post = _host_bw_probe()
        log(f"build: {t_build:.1f}s for {n} pts "
            f"(insert {t_insert:.1f} + finalize {t_finalize:.1f}; "
            f"{sys_.store.size_bytes()/1e6:.0f} MB ciphertext) "
            f"stages={build_stages} "
            f"host_bw post-build {host_bw_post:.3f} GB/s")

        t0 = time.perf_counter()
        gtm = groundtruth.precompute(base, queries, k=100)
        log(f"GT precompute: {time.perf_counter()-t0:.1f}s")

        # Warmup (compile) on a small slice, then timed runs.  The timed
        # pass repeats BENCH_REPEATS times (cheap: ~1-3s each) and the BEST
        # pass is reported, with every pass's q/s in the JSON.  Recall/ratio/decrypt counts are
        # deterministic and bit-identical across passes (logged per pass).
        sys_.run_queries(queries[:batch], gtm, base, ks=(10,))
        repeats = max(int(os.environ.get("BENCH_REPEATS", 5)), 1)
        best = None
        repeat_qps = []
        all_art = []   # per-query ART pooled over every pass (tail evidence)
        for rep in range(repeats):
            sys_.profiler.clear_rows()
            t0 = time.perf_counter()
            agg_i = sys_.run_queries(queries, gtm, base, ks=(1, 10, 100))
            wall_i = time.perf_counter() - t0
            qps_i = q / wall_i
            repeat_qps.append(round(qps_i, 1))
            rows_i = [r for r in sys_.profiler.rows if r.k == 10]
            all_art.extend(r.server_ms for r in rows_i)
            log(f"pass {rep + 1}/{repeats}: {agg_i.paper_line()}  "
                f"wall {wall_i:.2f}s -> {qps_i:.1f} q/s")
            if best is None or qps_i > best[0]:
                best = (qps_i, wall_i, agg_i, rows_i)
        qps, wall, agg, rows = best
        recall10 = agg.recall_at_k[10]
        ratio = agg.ratio_at_k.get(100, float("nan"))
        nq = max(len(rows), 1)
        log(f"stage means/query (best pass): "
            f"route {sum(r.route_ms for r in rows)/nq:.1f}ms "
            f"decrypt {sum(r.decrypt_ms for r in rows)/nq:.1f}ms "
            f"refine {sum(r.refine_ms for r in rows)/nq:.1f}ms")

        baseline_qps = 1000.0 / 1429.8   # SIFT_P4_FAST ART
        print(json.dumps({
            "metric": "encrypted_query_throughput_sift1m_like",
            "value": round(qps, 2),
            "unit": "queries/s",
            "vs_baseline": round(qps / baseline_qps, 1),
            "recall_at_10": round(recall10, 4),
            "recall_at_100": round(agg.recall_at_k.get(100, float("nan")), 4),
            "distance_ratio_at_100": round(ratio, 4),
            # ONE latency definition: art/p50/p95 all derive from the same
            # series (per-batch exclusive service time / batch size, which
            # sums to the pipeline wall) — see QueryService.search_batches
            "art_ms": round(agg.mean_art_ms, 2),
            "p50_art_ms": round(agg.p50_art_ms, 2),
            "p95_art_ms": round(agg.p95_art_ms, 2),
            "p99_art_ms": round(agg.p99_art_ms, 2),
            "p999_art_ms": round(agg.p999_art_ms, 2),
            # tail over the POOLED per-query series of every pass — weather
            # variation across passes is real tail, and pooling gives
            # repeats x queries samples instead of one pass's worth
            "tail_all_passes": {
                "p99_art_ms": round(float(np.percentile(all_art, 99)), 2),
                "p999_art_ms": round(float(np.percentile(all_art, 99.9)), 2),
                "max_art_ms": round(float(np.max(all_art)), 2),
                "samples": len(all_art),
            },
            "wall_s": round(wall, 2),
            "repeat_qps": repeat_qps,   # best-of-N vs host DRAM weather
            "build_s": round(t_build, 1),
            "insert_s": round(t_insert, 1),
            "finalize_s": round(t_finalize, 1),
            # self-certifying build: per-stage wall + measured host DRAM
            # bandwidth — weather shows as uniformly inflated DRAM-bound
            # stages with depressed host_bw_gbs; a regression shows one
            # stage growing at constant host_bw_gbs
            "build_stages": build_stages,
            "finalize_stages": finalize_stages,
            "host_bw_gbs": round(host_bw_start, 3),
            "host_bw_gbs_post_build": round(host_bw_post, 3),
            "n": n, "d": d, "queries": q, "device": device,
            "corpus": corpus_kind,
            "storage_dtype": dtype, "encode_backend": encode_backend,
            # the operating point, so the artifact is reproducible from
            # the JSON alone
            "operating_point": {
                "routing": cfg.runtime.routing_mode,
                "m": cfg.paper.m,
                "code_bits": cfg.paper.num_groups * cfg.paper.code_bits,
                "probes": cfg.runtime.probe_override,
                "rerank_limit": cfg.runtime.rerank_limit,
                "refinement_limit": cfg.runtime.refinement_limit,
                "adaptive_decrypt_margin":
                    cfg.runtime.adaptive_decrypt_margin,
                "block_size": cfg.runtime.block_size,
                "wide_keys": cfg.runtime.wide_keys,
                "batch": batch,
            },
        }))
        sys_.shutdown()
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
