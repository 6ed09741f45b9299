"""Ground truth: load, precompute (device brute force), validate.

Reference counterparts: ``loader/GroundtruthManager.java`` (ivecs/CSV parse,
id-range validation, getGroundtruth:200-210), ``api/GroundtruthPrecompute.java``
(multithreaded exact top-K — here one chunked device matmul), and
``api/GroundtruthValidator.java`` (sampled brute-force-vs-GT gate that aborts
bad runs, wired at ForwardSecureANNSystem.java:2158-2186).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..ops.refine import bruteforce_topk
from .loaders import read_csv, read_ivecs


class GroundtruthManager:
    def __init__(self, gt: np.ndarray, base_size: int | None = None):
        gt = np.asarray(gt, np.int64)
        if gt.ndim != 2:
            raise ValueError(f"GT must be 2-D, got {gt.shape}")
        if base_size is not None:
            bad = (gt < 0) | (gt >= base_size)
            if bad.any():
                raise ValueError(
                    f"GT contains {int(bad.sum())} ids outside [0, {base_size})")
        self.gt = gt

    @classmethod
    def load(cls, path: str, base_size: int | None = None
             ) -> "GroundtruthManager":
        ext = os.path.splitext(path)[1].lower()
        if ext == ".ivecs":
            return cls(read_ivecs(path), base_size)
        if ext == ".csv":
            return cls(read_csv(path).astype(np.int64), base_size)
        raise ValueError(f"unsupported GT format {ext!r}")

    def get(self, query_idx: int, k: int) -> np.ndarray:
        """Top-k true neighbor ids for one query (reference :200-210)."""
        return self.gt[query_idx, :k]

    def save_ivecs(self, path: str) -> None:
        k = self.gt.shape[1]
        n = self.gt.shape[0]
        out = np.empty((n, k + 1), "<i4")
        out[:, 0] = k
        out[:, 1:] = self.gt.astype("<i4")
        out.tofile(path)

    def __len__(self) -> int:
        return len(self.gt)


def precompute(base: np.ndarray, queries: np.ndarray, k: int = 100,
               chunk: int = 262_144) -> GroundtruthManager:
    """Exact GT by device brute force (the reference spends a thread pool on
    this, GroundtruthPrecompute.java:249-268; a chunked matmul + top-k does
    it here, ``ops.refine.bruteforce_topk``)."""
    ids, _dist = bruteforce_topk(base, np.asarray(queries, np.float32),
                                 k, chunk)
    return GroundtruthManager(ids.astype(np.int64), base_size=len(base))


@dataclass
class ValidationResult:
    checked: int
    mismatches: int
    max_rel_error: float

    @property
    def ok(self) -> bool:
        return self.mismatches == 0


def validate(base: np.ndarray, queries: np.ndarray, gtm: GroundtruthManager,
             sample: int = 100, tolerance: float = 1e-3) -> ValidationResult:
    """Sampled sanity gate: brute-force NN distance vs GT top-1 distance
    must agree within tolerance (reference GroundtruthValidator.java:36-66)."""
    n = min(sample, len(gtm))
    idx = np.linspace(0, len(gtm) - 1, n).astype(np.int64)
    qs = np.asarray(queries, np.float32)[idx]
    ids, dist = bruteforce_topk(base, qs, 1)
    mismatches = 0
    max_rel = 0.0
    for row, qi in enumerate(idx):
        true_id = int(ids[row, 0])
        gt_id = int(gtm.get(int(qi), 1)[0])
        if true_id == gt_id:
            continue
        d_true = float(dist[row, 0])
        d_gt = float(np.linalg.norm(
            qs[row] - np.asarray(base[gt_id], np.float32)))
        rel = abs(d_gt - d_true) / max(d_true, 1e-12)
        max_rel = max(max_rel, rel)
        if rel > tolerance:
            mismatches += 1
    return ValidationResult(n, mismatches, max_rel)
