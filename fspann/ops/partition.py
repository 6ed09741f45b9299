"""Greedy partition construction (reference "Algorithm-2") as device sorts.

Reference behavior (index/paper/GreedyPartitioner.java:37-76): per (table,
division) group, sort all (id, 63-bit key) pairs by key, chop into fixed
blocks of ``blockSize``, and record per block {minKey, maxKey, repCode =
median element's code, ids}.

Accelerator design: all G groups build in one ``jax.lax.sort`` call over a
``[G, N]`` batch (XLA batches the sort across the leading axis), then block
statistics are reshapes + reductions.  The per-point object soup becomes four
dense arrays that live in device memory for the life of the index.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

INT64_MAX = jnp.iinfo(jnp.int64).max


class PartitionTable(NamedTuple):
    """Dense partition layout for all groups.

    ``P = ceil(N / block)`` partitions per group; the final partition of each
    group may be partial (``counts`` < block) and is padded with id ``-1`` /
    key ``INT64_MAX``.
    """

    min_key: jax.Array    # int64 [G, P]
    max_key: jax.Array    # int64 [G, P]
    rep_codes: jax.Array  # uint32 [G, P, W]  median element's packed code
    ids: jax.Array        # int32 [G, P, B]   vector ids, -1 = pad
    counts: jax.Array     # int32 [G, P]      valid ids per block
    # wide-key mode (``build_partitions(wide=True)``): secondary 63-bit key
    # boundaries carrying code bits 63..125 (coding.keys2_from_codes) so the
    # partition order is the full code-prefix order instead of the
    # reference's 63-bit truncation.  None => reference-exact narrow order.
    min_key2: jax.Array | None = None   # int64 [G, P]
    max_key2: jax.Array | None = None   # int64 [G, P]

    @property
    def num_groups(self) -> int:
        return self.ids.shape[0]

    @property
    def num_partitions(self) -> int:
        return self.ids.shape[1]

    @property
    def block_size(self) -> int:
        return self.ids.shape[2]


@partial(jax.jit, static_argnames=("block_size", "wide"))
def build_partitions(keys: jax.Array, codes: jax.Array,
                     block_size: int = 64,
                     wide: bool = False) -> PartitionTable:
    """Build the partition table for all groups at once.

    Args:
      keys:  int64 ``[G, N]`` sortable routing keys (coding.keys_from_codes).
      codes: uint32 ``[G, N, W]`` packed codes (for repCode extraction).
      block_size: ids per partition (reference uses 64,
        PartitionedIndexService.java:412-425).
      wide: order by the (key, key2) pair — the full code-prefix order up
        to 126 bits (``runtime.wide_keys``) — instead of the reference's
        63-bit truncated order.
    """
    from . import coding

    g, n = keys.shape
    b = block_size
    p = -(-n // b)
    pad = p * b - n

    ids0 = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), (g, n))
    if wide:
        keys2 = coding.keys2_from_codes(codes)          # [G, N]
        skeys, skeys2, sids = jax.lax.sort((keys, keys2, ids0),
                                           dimension=-1, num_keys=3)
    else:
        # num_keys=2: ties in key break by id — deterministic (the
        # reference's tie order is HashMap-iteration arbitrary; any fixed
        # order is valid).
        skeys, sids = jax.lax.sort((keys, ids0), dimension=-1, num_keys=2)
        skeys2 = None
    if pad:
        skeys = jnp.pad(skeys, ((0, 0), (0, pad)), constant_values=INT64_MAX)
        sids = jnp.pad(sids, ((0, 0), (0, pad)), constant_values=-1)
        if skeys2 is not None:
            skeys2 = jnp.pad(skeys2, ((0, 0), (0, pad)),
                             constant_values=INT64_MAX)

    skeys = skeys.reshape(g, p, b)
    sids = sids.reshape(g, p, b)
    if skeys2 is not None:
        skeys2 = skeys2.reshape(g, p, b)

    # Valid count per block: only the final block can be partial.
    base = jnp.arange(p, dtype=jnp.int32) * b
    counts = jnp.clip(jnp.int32(n) - base, 0, b)          # [P]
    counts = jnp.broadcast_to(counts, (g, p))

    min_key = skeys[:, :, 0]
    last = jnp.maximum(counts - 1, 0)
    max_key = jnp.take_along_axis(skeys, last[..., None].astype(jnp.int32),
                                  axis=-1)[..., 0]
    min_key2 = max_key2 = None
    if skeys2 is not None:
        min_key2 = skeys2[:, :, 0]
        max_key2 = jnp.take_along_axis(
            skeys2, last[..., None].astype(jnp.int32), axis=-1)[..., 0]

    # repCode = code of the median element of the block (ref :60-70).
    mid = (counts - 1) // 2
    mid_ids = jnp.take_along_axis(sids, mid[..., None], axis=-1)[..., 0]  # [G, P]
    safe_mid = jnp.maximum(mid_ids, 0)
    garange = jnp.arange(g, dtype=jnp.int32)[:, None]                     # [G, 1]
    rep_codes = codes[garange, safe_mid]                                  # [G, P, W]
    # Degenerate (empty input) blocks keep zero codes.
    rep_codes = jnp.where((mid_ids >= 0)[..., None], rep_codes,
                          jnp.zeros_like(rep_codes))

    return PartitionTable(min_key, max_key, rep_codes, sids, counts,
                          min_key2, max_key2)


def build_partitions_numpy(keys: "np.ndarray", codes: "np.ndarray",
                           block_size: int = 64,
                           wide: bool = False) -> PartitionTable:
    """Host-side build with the same layout/semantics as
    :func:`build_partitions` (ties break by id); the resulting table is a
    pytree of numpy arrays ready for one ``jax.device_put``."""
    import numpy as np

    from . import coding

    g, n = keys.shape
    b = block_size
    p = -(-n // b)
    pad = p * b - n
    ids0 = np.arange(n, dtype=np.int32)

    keys2 = coding.keys2_from_codes_numpy(codes) if wide else None  # [G, N]
    skeys = np.empty((g, p * b), np.int64)
    sids = np.empty((g, p * b), np.int32)
    skeys2 = np.empty((g, p * b), np.int64) if wide else None
    for gi in range(g):
        if wide:
            order = np.lexsort((ids0, keys2[gi], keys[gi]))
            skeys2[gi, :n] = keys2[gi][order]
        else:
            order = np.lexsort((ids0, keys[gi]))
        skeys[gi, :n] = keys[gi][order]
        sids[gi, :n] = ids0[order]
    if pad:
        skeys[:, n:] = np.iinfo(np.int64).max
        sids[:, n:] = -1
        if wide:
            skeys2[:, n:] = np.iinfo(np.int64).max
    skeys = skeys.reshape(g, p, b)
    sids = sids.reshape(g, p, b)

    counts = np.clip(np.int64(n) - np.arange(p, dtype=np.int64) * b, 0, b
                     ).astype(np.int32)
    counts = np.broadcast_to(counts, (g, p)).copy()
    min_key = skeys[:, :, 0].copy()
    last = np.maximum(counts - 1, 0)
    max_key = np.take_along_axis(skeys, last[..., None], axis=-1)[..., 0]
    min_key2 = max_key2 = None
    if wide:
        skeys2 = skeys2.reshape(g, p, b)
        min_key2 = skeys2[:, :, 0].copy()
        max_key2 = np.take_along_axis(skeys2, last[..., None], axis=-1)[..., 0]
    mid = (counts - 1) // 2
    mid_ids = np.take_along_axis(sids, mid[..., None], axis=-1)[..., 0]
    safe_mid = np.maximum(mid_ids, 0)
    rep_codes = codes[np.arange(g)[:, None], safe_mid]
    rep_codes = np.where((mid_ids >= 0)[..., None], rep_codes, 0
                         ).astype(np.uint32)
    return PartitionTable(min_key, max_key, rep_codes, sids, counts,
                          min_key2, max_key2)
