"""Stretch-scale mesh lifecycle run (VERDICT r3 next-round #5).

Executes the FULL encrypted mesh lifecycle on the 8-virtual-device CPU mesh
with the PACKED scan layout at the largest N the host fits (default 10M):

  streamed build -> queries (recall/ratio vs exact GT) -> live insert ->
  delete/undelete -> rotation + touched migration -> checkpoint ->
  restore -> query equality

and reconciles measured per-shard memory against scripts/size_stretch.py's
100M x 768 sizing model (same formulas at this run's geometry).

The corpus is generated in chunks and never materialized beyond one chunk
on the host feed path (index_stream contract); GT is computed against a
RE-GENERATED chunk stream so the evidence is exact without holding the
corpus.  JSON-lines log: bench_results/stretch_10m.jsonl

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       JAX_PLATFORMS=cpu python scripts/run_stretch_10m.py
Env: STRETCH_N (10_000_000), STRETCH_D (96), STRETCH_Q (64),
     STRETCH_DTYPE (f16), STRETCH_M (64)
"""

import dataclasses
import json
import os
import resource
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "bench_results",
                   os.environ.get("STRETCH_OUT", "stretch_10m.jsonl"))

N = int(os.environ.get("STRETCH_N", 10_000_000))
D = int(os.environ.get("STRETCH_D", 96))
Q = int(os.environ.get("STRETCH_Q", 64))
DTYPE = os.environ.get("STRETCH_DTYPE", "f16")
M = int(os.environ.get("STRETCH_M", 64))
# encode transients scale with CHUNK * code_bits — at the 768-d / 6,144-bit
# stretch geometry a 500k chunk holds ~12 GB of H values, so wide-geometry
# runs shrink the chunk to keep peak RSS bounded
CHUNK = int(os.environ.get("STRETCH_CHUNK", 500_000))
# Latent dimensionality of the generated corpus (0 = pure ambient
# gaussian).  Real 768-d embedding corpora concentrate on a much lower
# latent manifold — the redcaps-family calibration measured d_eff=256
# reproducing the reference's recall band (NOTES_ROUND4.md) — so the
# 768-d stretch instance generates x = z @ W with z in R^d_eff.
D_EFF = int(os.environ.get("STRETCH_DEFF", 0))
RERANK = int(os.environ.get("STRETCH_RERANK", 2000))
SEED = 42


def emit(row):
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(json.dumps(row) + "\n")
    print("ROW", json.dumps(row), flush=True)


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _latent_w():
    rng = np.random.default_rng(SEED * 7 + 1)
    return rng.standard_normal((D_EFF, D), dtype=np.float32) \
        / np.sqrt(np.float32(D_EFF))


def chunk_stream():
    """Deterministic per-chunk corpus generation — the host never holds
    more than one chunk (the point of the streamed build)."""
    w = _latent_w() if D_EFF else None
    for s in range(0, N, CHUNK):
        e = min(s + CHUNK, N)
        rng = np.random.default_rng(SEED + s // CHUNK)
        if w is None:
            yield rng.standard_normal((e - s, D), dtype=np.float32)
        else:
            yield rng.standard_normal(
                (e - s, D_EFF), dtype=np.float32) @ w


def queries_arr():
    rng = np.random.default_rng(7)
    rows = next(chunk_stream())[:Q]              # perturb chunk-0 rows
    return rows + 0.05 * rng.standard_normal((Q, D), dtype=np.float32)


def exact_gt(queries, k=100):
    """Chunked exact brute force against the regenerated stream."""
    q2 = np.einsum("ij,ij->i", queries, queries)
    best_d = np.full((len(queries), k), np.inf, np.float32)
    best_i = np.full((len(queries), k), -1, np.int64)
    for s, chunk in zip(range(0, N, CHUNK), chunk_stream()):
        d2 = (np.einsum("ij,ij->i", chunk, chunk)[None, :]
              - 2.0 * (queries @ chunk.T) + q2[:, None])
        top = np.argpartition(d2, k - 1, axis=1)[:, :k]
        cd = np.take_along_axis(d2, top, axis=1).astype(np.float32)
        ci = (top + s).astype(np.int64)
        alld = np.concatenate([best_d, cd], axis=1)
        alli = np.concatenate([best_i, ci], axis=1)
        sel = np.argpartition(alld, k - 1, axis=1)[:, :k]
        best_d = np.take_along_axis(alld, sel, axis=1)
        best_i = np.take_along_axis(alli, sel, axis=1)
    order = np.argsort(best_d, axis=1, kind="stable")
    return np.take_along_axis(best_i, order, axis=1)


def recall(ids, gt, k):
    hits = sum(len(set(ids[i, :k].tolist()) & set(gt[i, :k].tolist()))
               for i in range(len(ids)))
    return hits / (len(ids) * k)


def main():
    from fspann.config import SystemConfig
    from fspann.parallel.serving import DistributedEncryptedSystem

    cfg = SystemConfig()
    cfg = dataclasses.replace(
        cfg,
        paper=dataclasses.replace(cfg.paper, tables=8, m=M),
        runtime=dataclasses.replace(
            cfg.runtime, routing_mode="scan", rerank_limit=RERANK,
            refinement_limit=56000, max_global_candidates=56000,
            adaptive_decrypt_margin=40, block_size=128,
            scan_packed="on",              # the stretch layout under test
            # emulated mesh: the host 2-key merge (bit-identical to the
            # device merge — tests/test_distributed_serving.py) avoids
            # XLA:CPU's 40s in-process rendezvous abort, which a 10M-row
            # per-shard scan on a 1-core host trips nondeterministically
            mesh_merge=os.environ.get("STRETCH_MERGE", "host"),
            storage_dtype=DTYPE, encode_backend="cpu"))
    code_bits = cfg.paper.num_groups * cfg.paper.code_bits

    work = tempfile.mkdtemp(prefix="fspann_stretch_",
                            dir=os.environ.get("STRETCH_TMP"))
    sys_ = DistributedEncryptedSystem(cfg, work, D)
    ndev = sys_.ndev

    t0 = time.time()
    sys_.index_stream(chunk_stream(), batch_size=CHUNK, n_total=N,
                      capacity=N + 4096)
    build_s = time.time() - t0
    rows_per_shard = sys_.index.shard_rows
    words_gb = rows_per_shard * code_bits / 8 / 1e9
    model_words_gb = (-(-N // ndev)) * code_bits / 8 / 1e9  # size_stretch
    emit({"step": "build", "n": N, "d": D, "d_eff": D_EFF, "rerank": RERANK,
          "dtype": DTYPE,
          "code_bits": code_bits, "ndev": ndev, "secs": round(build_s, 1),
          "rows_per_shard": int(rows_per_shard),
          "packed_words_gb_per_shard": round(words_gb, 3),
          "model_words_gb_per_shard": round(model_words_gb, 3),
          "arena_gb": round(sys_.size_bytes() / 1e9, 3),
          "model_arena_gb": round(
              N * (D * {"f32": 4, "f16": 2, "i8": 1}[DTYPE]
                   + (4 if DTYPE == "i8" else 0) + 46) / 1e9, 3),
          "rss_gb": round(rss_gb(), 2)})

    qs = queries_arr()
    t0 = time.time()
    gt = exact_gt(qs)
    emit({"step": "gt", "secs": round(time.time() - t0, 1),
          "rss_gb": round(rss_gb(), 2)})

    t0 = time.time()
    ids, dists = sys_.search_batch(qs, 10)
    first_q = time.time() - t0                    # includes compile
    t0 = time.time()
    ids, dists = sys_.search_batch(qs, 10)
    q_s = time.time() - t0
    r10 = recall(ids, gt, 10)
    emit({"step": "query", "recall_at_10": round(r10, 4),
          "art_ms": round(q_s / Q * 1000, 1), "qps": round(Q / q_s, 2),
          "compile_s": round(first_q, 1)})

    # live insert: new rows searchable immediately
    rng = np.random.default_rng(99)
    new_vecs = qs[:8] + 1e-4 * rng.standard_normal((8, D), dtype=np.float32)
    new_ids = sys_.insert_live(new_vecs)
    ids2, d2 = sys_.search_batch(qs[:8], 1)
    live_hit = float(np.mean(ids2[:, 0] == new_ids))
    emit({"step": "insert_live", "inserted": len(new_ids),
          "nearest_is_new": live_hit})

    # delete the inserted rows -> previous GT returns; undelete 2
    sys_.delete(new_ids)
    ids3, _ = sys_.search_batch(qs[:8], 10)
    gone = float(np.mean([not set(new_ids).intersection(row)
                          for row in ids3]))
    restored = sys_.undelete(new_ids[:2])
    emit({"step": "delete_undelete", "deleted_gone": gone,
          "undeleted": len(restored)})
    sys_.delete(new_ids[:2])                     # clean slate for equality

    # rotation + touched-set migration (bounded, selective)
    touched = np.unique(ids[ids >= 0])[:50_000]
    t0 = time.time()
    report = sys_.rotate_and_migrate(touched)
    emit({"step": "rotate_migrate", "touched": int(len(touched)),
          "reencrypted": report.reencrypted, "failed": report.failed,
          "secs": round(time.time() - t0, 1)})
    ids4, _ = sys_.search_batch(qs, 10)
    emit({"step": "post_rotation_query",
          "recall_at_10": round(recall(ids4, gt, 10), 4),
          "identical_to_pre": bool(np.array_equal(ids, ids4))})

    # checkpoint -> restore into a fresh facade -> query equality
    t0 = time.time()
    path = sys_.save_index()
    save_s = time.time() - t0
    sys_.close()
    t0 = time.time()
    sys2 = DistributedEncryptedSystem(cfg, work, D)
    n_restored = sys2.restore_index()
    restore_s = time.time() - t0
    ids5, d5 = sys2.search_batch(qs, 10)
    emit({"step": "checkpoint_restore", "save_s": round(save_s, 1),
          "restore_s": round(restore_s, 1), "restored_rows": int(n_restored),
          "query_identical": bool(np.array_equal(ids4, ids5)),
          "rss_gb": round(rss_gb(), 2),
          "checkpoint_gb": round(os.path.getsize(path) / 1e9, 3)})
    sys2.close()
    import shutil
    shutil.rmtree(work, ignore_errors=True)
    print("STRETCH DONE", flush=True)


if __name__ == "__main__":
    main()
