"""Vector file loaders: fvecs / bvecs / ivecs / csv + streaming batches.

Reference counterparts: ``loader/FvecsLoader.java`` (little-endian int dim +
dim LE floats per record), ``BvecsLoader.java`` (dim uint8 as doubles),
``IvecsLoader.java`` (int rows, the GT format), ``CsvLoader.java`` (tolerant
CSV), ``DefaultDataLoader.java`` (extension dispatch),
``StreamingBatchLoader.java`` (iterator → fixed batches).

All formats memory-map and slice as numpy arrays — a "load" is an
O(1) view; batches materialize as contiguous f32 blocks ready for device
transfer.
"""

from __future__ import annotations

import os

import numpy as np


def _mapped_records(path: str, elem_dtype, elem_size: int) -> np.ndarray:
    """Map a SIFT-style record file: each record is i32 dim + dim elements.

    Requires uniform dimension (true for all published corpora); validated
    against the file size.
    """
    raw = np.memmap(path, np.uint8, "r")
    if len(raw) < 4:
        raise ValueError(f"{path}: too small for a vecs file")
    dim = int(np.frombuffer(raw[:4].tobytes(), "<i4")[0])
    if dim <= 0 or dim > 1_000_000:
        raise ValueError(f"{path}: implausible dimension {dim}")
    rec_bytes = 4 + dim * elem_size
    n, rem = divmod(len(raw), rec_bytes)
    if rem:
        raise ValueError(f"{path}: size {len(raw)} not a multiple of record "
                         f"size {rec_bytes} (dim={dim})")
    mat = raw.reshape(n, rec_bytes)
    dims = mat[:, :4].reshape(-1).view("<i4")[::1]
    if not (dims == dim).all():
        raise ValueError(f"{path}: non-uniform record dimensions")
    body = mat[:, 4:]
    return body.view(elem_dtype).reshape(n, dim)


def read_fvecs(path: str) -> np.ndarray:
    """f32 [N, d] view of an fvecs file (reference FvecsLoader.java:21-39)."""
    return _mapped_records(path, "<f4", 4)


def read_bvecs(path: str) -> np.ndarray:
    """uint8 [N, d] view of a bvecs file (values 0..255; reference
    BvecsLoader.java:9-18 widens to double — we widen at batch time)."""
    return _mapped_records(path, np.uint8, 1)


def read_ivecs(path: str) -> np.ndarray:
    """i32 [N, k] view of an ivecs file (ground-truth format)."""
    return _mapped_records(path, "<i4", 4)


def read_csv(path: str) -> np.ndarray:
    """Tolerant CSV: skips BOM, header line, comment lines
    (reference CsvLoader.java:9-16)."""
    rows = []
    with open(path, "r", encoding="utf-8-sig") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p for p in line.replace(";", ",").split(",") if p != ""]
            try:
                rows.append([float(p) for p in parts])
            except ValueError:
                if not rows:
                    continue  # header
                raise
    if not rows:
        raise ValueError(f"{path}: no data rows")
    width = len(rows[0])
    if any(len(r) != width for r in rows):
        raise ValueError(f"{path}: ragged rows")
    return np.asarray(rows, np.float32)


_READERS = {
    ".fvecs": read_fvecs,
    ".bvecs": read_bvecs,
    ".ivecs": read_ivecs,
    ".csv": read_csv,
}


def load_vectors(path: str) -> np.ndarray:
    """Extension-dispatched load (reference DefaultDataLoader.lookup:23-32)."""
    ext = os.path.splitext(path)[1].lower()
    reader = _READERS.get(ext)
    if reader is None:
        raise ValueError(f"unsupported vector format {ext!r} "
                         f"(known: {sorted(_READERS)})")
    return reader(path)


def stream_batches(data: np.ndarray, batch_size: int,
                   limit: int | None = None):
    """Yield (start_id, f32 batch) blocks (reference
    StreamingBatchLoader.java:16-22; ids are file ordinals, preserving the
    reference's ID==base-index invariant)."""
    if batch_size <= 0:
        raise ValueError("batch_size must be > 0")
    n = len(data) if limit is None else min(limit, len(data))
    for s in range(0, n, batch_size):
        e = min(s + batch_size, n)
        yield s, np.ascontiguousarray(data[s:e], dtype=np.float32)
