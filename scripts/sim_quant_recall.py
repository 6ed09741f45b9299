"""Simulate the recall cost of quantized ciphertext payloads at the parity
operating point, WITHOUT building stores: candidates = exact top-L per query
(the bit-matmul scan at parity is near-exact at L=2000), final top-k re-scored from
the quantized candidate rows vs the f32 query — exactly the error path of
storage_dtype != f32 (the store quantizes rows before sealing; the fused C
open dequantizes and scores).

Schemes:
  f32        — baseline (recall == scan-pipeline ceiling)
  f16        — IEEE half per component
  i8         — symmetric per-row scale = max|v|/127 (shipping storage_dtype=i8)
  i8n        — i8 + TRUE f32 norm persisted in the payload (d2 error halves:
               only the dot term keeps quantization noise)
  u8         — affine per-row: scale=(max-min)/255, zero=min (2x finer for
               one-sided rows; idempotent because 0 and 255 are attained)
  i8b16/i8b32— symmetric per-BLOCK scales (16/32 dims per block): heavy-tailed
               rows localize the big component, other blocks quantize finer

Usage: JAX_PLATFORMS=cpu python scripts/sim_quant_recall.py [N] [Q] [L]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np


def quant_f16(v):
    return v.astype(np.float16).astype(np.float32)


def quant_i8(v):
    amax = np.abs(v).max(axis=-1, keepdims=True)
    s = amax / np.float32(127.0)
    safe = np.where(s > 0, s, np.float32(1.0))
    q = np.clip(np.rint(v / safe), -127, 127).astype(np.int8)
    return s * q.astype(np.float32)


def quant_u8(v):
    lo = v.min(axis=-1, keepdims=True)
    hi = v.max(axis=-1, keepdims=True)
    s = (hi - lo) / np.float32(255.0)
    safe = np.where(s > 0, s, np.float32(1.0))
    q = np.clip(np.rint((v - lo) / safe), 0, 255).astype(np.uint8)
    return lo + s * q.astype(np.float32)


def quant_i8_block(v, block):
    n, d = v.shape
    assert d % block == 0
    vb = v.reshape(n, d // block, block)
    amax = np.abs(vb).max(axis=-1, keepdims=True)
    # scales stored f16 in this variant (payload prefix stays small)
    s = (amax / np.float32(127.0)).astype(np.float16).astype(np.float32)
    safe = np.where(s > 0, s, np.float32(1.0))
    q = np.clip(np.rint(vb / safe), -127, 127).astype(np.int8)
    return (s * q.astype(np.float32)).reshape(n, d)


def recall_with(base_q, queries, cand_ids, gt, k, true_norms=None):
    """Top-k from quantized candidate rows; recall vs exact GT."""
    nq, L = cand_ids.shape
    hits = 0
    for qi in range(nq):
        c = base_q[cand_ids[qi]]
        if true_norms is None:
            n2 = np.einsum("ij,ij->i", c, c)
        else:
            n2 = true_norms[cand_ids[qi]]
        d2 = n2 - 2.0 * (c @ queries[qi])
        top = cand_ids[qi][np.argpartition(d2, k - 1)[:k]]
        hits += len(set(top.tolist()) & set(gt[qi, :k].tolist()))
    return hits / (nq * k)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    nq = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    L = int(sys.argv[3]) if len(sys.argv) > 3 else 2000
    d, k = 128, 10

    from fspann.io import groundtruth, synthetic

    t0 = time.perf_counter()
    base, queries = synthetic.lsh_hard_corpus(n, d, nq, seed=42)
    print(f"corpus {n}x{d}: {time.perf_counter()-t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    gtm = groundtruth.precompute(base, queries, k=max(100, k))
    gt = np.asarray(gtm.gt)
    print(f"GT: {time.perf_counter()-t0:.1f}s", flush=True)

    # exact top-L candidates per query (stand-in for the near-exact scan)
    t0 = time.perf_counter()
    cand = groundtruth.precompute(base, queries, k=L)
    cand_ids = np.asarray(cand.gt)
    print(f"top-{L} candidates: {time.perf_counter()-t0:.1f}s", flush=True)

    schemes = {
        "f32": lambda v: v,
        "f16": quant_f16,
        "i8": quant_i8,
        "u8": quant_u8,
        "i8b32": lambda v: quant_i8_block(v, 32),
        "i8b16": lambda v: quant_i8_block(v, 16),
    }
    r_base = None
    for name, fn in schemes.items():
        bq = fn(base)
        r10 = recall_with(bq, queries, cand_ids, gt, 10)
        r100 = recall_with(bq, queries, cand_ids, gt, 100)
        extra = ""
        if name == "i8":
            # i8n: same i8 rows but the TRUE norm rides in the payload
            tn = np.einsum("ij,ij->i", base, base)
            r10n = recall_with(bq, queries, cand_ids, gt, 10, true_norms=tn)
            r100n = recall_with(bq, queries, cand_ids, gt, 100, true_norms=tn)
            extra = f"   [i8n: r@10 {r10n:.4f} r@100 {r100n:.4f}]"
        if r_base is None:
            r_base = r10
        print(f"{name:6s} r@10 {r10:.4f} ({(r10-r_base)*100:+.2f}pp) "
              f"r@100 {r100:.4f}{extra}", flush=True)
        del bq


if __name__ == "__main__":
    main()
