"""Hamming scan: full-corpus fine-score ranking as an int8 bit matmul.

The probe+rerank pipeline bounds work by gathering candidate codes, one
random row per candidate; the scan instead scores EVERY point's full code
against the query batch with one dense matrix product, which streams the
corpus bit matrix once per query batch:

    Hamming(q, c) = popcount(q) + popcount(c) - 2 * <bits(q), bits(c)>

so ranking by Hamming is ranking by ``popc[c] - 2 * dot`` — one
``[Q, B] x [B, N]`` int8→int32 matmul (B = G·m·λ total code bits) plus a
top-L.  This replaces the reference's whole stage-A machinery (probe queue
over partitions, PartitionedIndexService.java:592-715, plus its stage-A.5
prefilter) with an exact *global* fine ranking — strictly better recall
than any probe schedule at the same decrypt budget L, with zero probe-miss
failure modes.  Device memory: N·B int8 (3.07 GB at 1M×3,072 bits).

Routing–ciphertext orthogonality is unchanged: the scan state is a pure
function of the LSH codes the server already stores.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .routing import RouteResult

_INF = jnp.int32(jnp.iinfo(jnp.int32).max)
# dead-entry sentinel for the rank key: must survive an int32→f32→int32
# round trip exactly (the approx selection works in f32; INT32_MAX would
# saturate implementation-defined on the way back).  2^30 is exact in f32
# and far above any real rank value (|part| ≤ B ≤ a few thousand).
_DEAD = jnp.int32(1 << 30)


class ScanState(NamedTuple):
    bits: jax.Array   # int8 [N, B] unpacked 0/1 code bits (MSB-first order)
    popc: jax.Array   # int32 [N] popcount per point


class PackedScanState(NamedTuple):
    """Scan state kept PACKED in device memory (uint32 words, 8× less than
    the int8 bit matrix): 10M rows × 3,072-bit codes = 3.84 GB instead of
    30.7 GB.  The chunked scan unpacks one chunk at a time on-device
    (shift/mask) right before its bit-matmul; the unpack scratch is one
    [chunk, B] block, reused across loop steps.  Trade-off: ~2× the memory
    traffic of an unpacked scan (words read + scratch write + matmul read),
    so the unpacked state stays the default whenever it fits."""

    words: jax.Array  # uint32 [N, G, W] packed codes (MSB-first, coding.py)
    popc: jax.Array   # int32 [N] popcount per point


def unpack_bits_numpy(codes: np.ndarray, code_bits: int) -> np.ndarray:
    """uint32 packed words [N, G, W] → int8 bit matrix [N, G*code_bits].

    Word packing is MSB-first (ops/coding.py), so big-endian byte view +
    ``np.unpackbits`` reproduces the bit order; each group's trailing pad
    bits (W*32 - code_bits) are dropped.
    """
    n, g, w = codes.shape
    by = np.ascontiguousarray(codes.astype(">u4")).view(np.uint8)
    bits = np.unpackbits(by.reshape(n, g, w * 4), axis=-1)  # [N, G, W*32]
    return np.ascontiguousarray(
        bits[:, :, :code_bits].reshape(n, g * code_bits)).astype(np.int8)


def unpack_bits_device(codes: jax.Array, code_bits: int) -> jax.Array:
    """Device-side unpack: uint32 [..., G, W] → int8 [..., G*code_bits].

    Same MSB-first convention as :func:`unpack_bits_numpy`; used inside
    shard_map where the codes already live in device memory.
    """
    g, w = codes.shape[-2], codes.shape[-1]
    shifts = jnp.arange(31, -1, -1, dtype=jnp.uint32)
    bits = ((codes[..., None] >> shifts) & jnp.uint32(1)).astype(jnp.int8)
    bits = bits.reshape(*codes.shape[:-1], w * 32)[..., :code_bits]
    return bits.reshape(*codes.shape[:-2], g * code_bits)


def build_scan_state(codes: np.ndarray, code_bits: int,
                     chunk: int = 262_144) -> ScanState:
    """Upload the PACKED words and unpack ON DEVICE.

    Packed words are 8× fewer bytes over the host↔device link than the
    unpacked int8 bit matrix (3 GB at 1M × 3,072-bit codes); the unpack is
    shift/mask work the device does in milliseconds.  Chunked ``dynamic_update_slice`` into a donated
    preallocated matrix keeps the device peak at bits + one chunk's
    scratch (a single whole-array unpack would let XLA materialize
    multi-GB broadcast intermediates); the tail reuses a full-size window
    ending at n (overlapped rows recompute identically) so only ONE shape
    compiles.  Popcounts come from one ``population_count`` pass over the
    words (pad bits are zero by the packers' construction, ops/coding.py).
    Bit-identical to the host unpack: same MSB-first convention
    (``unpack_bits_device`` vs ``unpack_bits_numpy`` equality is tested)."""
    n, g, _w = codes.shape
    words = jax.device_put(np.ascontiguousarray(codes, np.uint32))
    popc = jax.jit(lambda x: jnp.sum(
        jax.lax.population_count(x.reshape(x.shape[0], -1)),
        axis=-1).astype(jnp.int32))(words)
    if n <= chunk:
        bits = jax.jit(lambda x: unpack_bits_device(x, code_bits))(words)
        return ScanState(bits, popc)
    upd = jax.jit(
        lambda buf, ws, lo: jax.lax.dynamic_update_slice(
            buf,
            unpack_bits_device(
                jax.lax.dynamic_slice_in_dim(ws, lo, chunk), code_bits),
            (lo, 0)),
        donate_argnums=(0,))
    bits = jnp.zeros((n, g * code_bits), jnp.int8)
    lo = 0
    while lo < n:
        if lo + chunk > n:
            lo = n - chunk
        bits = upd(bits, words, np.int64(lo))
        lo += chunk
    return ScanState(bits, popc)


def build_scan_state_packed(codes: np.ndarray,
                            code_bits: int) -> PackedScanState:
    """Upload the packed words as-is; popcounts come from ONE device
    ``lax.population_count`` pass over the uploaded words (pad bits are
    zero by the packers' construction — ops/coding.py pads with zeros —
    so word popcounts equal bit-matrix row sums).  The old host path
    unpacked the full bit matrix (8× the packed bytes) on the
    bandwidth-starved host purely to sum it."""
    words = jax.device_put(np.ascontiguousarray(codes, np.uint32))
    popc = jax.jit(lambda w: jnp.sum(
        jax.lax.population_count(w.reshape(w.shape[0], -1)),
        axis=-1).astype(jnp.int32))(words)
    return PackedScanState(words, popc)


update_rows = jax.jit(
    lambda buf, new, lo: jax.lax.dynamic_update_slice_in_dim(
        buf, new, lo, axis=0),
    donate_argnums=(0,))
update_rows.__doc__ = """In-place row fill for capacity-padded scan state.

The start index is a TRACED scalar and the buffer is donated, so a stream
of same-sized live-insert batches reuses one compiled program and never
copies the resident state — the single-chip equivalent of the mesh path's
``append_scan_rows`` dynamic_update_slice (parallel/sharded.py)."""


def _adaptive_count(scores: jax.Array, anchor: int, margin: int,
                    floor: int, k: int) -> jax.Array:
    """Per-query adaptive decrypt budget from the ranked score matrix.

    ``scores`` is int32 [Q, L] ascending (best first), dead/pad = _INF.
    Budget = how many candidates sit within ``margin`` Hamming bits of the
    ``anchor``-th best score, clamped to [floor, L].  When fewer than
    ``anchor`` candidates are live the threshold clamp counts every live
    row.  Rationale: the exact-distance refine only changes the top-k
    among candidates whose code distance is near-tied with the k-th; rows
    beyond the margin are statistically never promoted into the top-k, so
    decrypting them is wasted host AES (calibrated: margin 150 at 2,304-bit
    codes holds recall@100 within noise of the full budget).
    """
    a = max(min(anchor, k), 1)
    s_a = scores[:, a - 1]
    # overflow guard: s_a == _INF (fewer than `a` live) must still count
    # all live rows, not wrap around
    thresh = jnp.minimum(s_a, _INF - margin - 1) + jnp.int32(margin)
    n_dec = jnp.sum(scores <= thresh[:, None], axis=-1, dtype=jnp.int32)
    return jnp.clip(n_dec, min(max(floor, a), k), k)


@partial(jax.jit, static_argnames=("limit", "approx", "anchor", "margin",
                                   "floor"))
def scan(state: ScanState, qbits: jax.Array, tombstones: jax.Array,
         limit: int, approx: bool = False, anchor: int = 0, margin: int = 0,
         floor: int = 0) -> RouteResult:
    """Global fine-Hamming ranking: top-``limit`` ids per query.

    Args:
      state: corpus bit matrix + popcounts.
      qbits: int8 [Q, B] unpacked query code bits.
      tombstones: bool [N] deleted mask.
      limit: L — decrypt budget per query.
      approx: select with ``lax.approx_max_k`` instead of the exact
        ``lax.top_k`` (the default).  XLA on GPU and CPU lowers both to an
        exact selection: on the H100 both compile to one segmented radix
        sort of the [Q, N] rank matrix, and the exact one was no slower
        (8.9 vs 9.5 ms at [64, 1M], L=2,000; PERF.md).
      anchor/margin/floor: when ``margin`` > 0, also return a per-query
        adaptive decrypt budget (:func:`_adaptive_count`) in
        ``RouteResult.n_dec``.
    """
    n = state.bits.shape[0]
    # int8 dot: [Q, B] x [N, B]^T -> int32 [Q, N]
    dots = jax.lax.dot_general(
        qbits, state.bits,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)
    qpopc = jnp.sum(qbits.astype(jnp.int32), axis=1)          # [Q]
    part = state.popc[None, :] - 2 * dots                     # rank key
    part = jnp.where(tombstones[None, :], _DEAD, part)
    k = min(limit, n)
    if approx:
        neg, idx = jax.lax.approx_max_k(-part.astype(jnp.float32), k,
                                        recall_target=0.98)
        fine_sel = (-neg).astype(jnp.int32)
    else:
        neg, idx = jax.lax.top_k(-part, k)
        fine_sel = -neg
    ids = idx.astype(jnp.int32)
    live = fine_sel < _DEAD
    scores = fine_sel + qpopc[:, None]
    ids = jnp.where(live, ids, -1)
    scores = jnp.where(live, scores, _INF)
    n_live = jnp.sum(live, axis=-1, dtype=jnp.int32)
    n_dec = _adaptive_count(scores, anchor, margin, floor, k) \
        if margin > 0 else None
    return RouteResult(ids, scores, n_live, jnp.full_like(n_live, n), n_dec)


def scan_chunk_merge(qbits: jax.Array, bits_c: jax.Array, popc_c: jax.Array,
                     dead_c: jax.Array, start: jax.Array, start_c: jax.Array,
                     carry: tuple, approx: bool) -> tuple:
    """One chunked-scan step: bit-matmul-score ``bits_c`` (int8 [chunk, B])
    against ``qbits``, mask dead + tail-duplicate rows (``start_c`` is the
    clamped slice origin; rows with index < ``start`` were already
    scanned), take the chunk top-k, and 2-key-merge (score, id) into the
    running carry.  SHARED by the single-chip :func:`scan_chunked` and the
    mesh packed step (``parallel/sharded.scan_route_step_fn_packed``) —
    the packed==unpacked and mesh==single-chip equalities require these
    to stay bit-identical, so the scoring/masking/merge lives once, here.
    All row arithmetic is pinned int32 (x64 is enabled package-wide)."""
    best_sc, best_id = carry
    q, k = best_sc.shape
    chunk = bits_c.shape[0]
    dots = jax.lax.dot_general(
        qbits, bits_c, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)                     # [Q, chunk]
    part = popc_c[None, :] - 2 * dots
    ridx = start_c.astype(jnp.int32) + jnp.arange(chunk, dtype=jnp.int32)
    dd = dead_c[None, :] | (ridx < start)[None, :]
    part = jnp.where(dd, _DEAD, part)
    if approx:
        neg, idx = jax.lax.approx_max_k(-part.astype(jnp.float32), k,
                                        recall_target=0.98)
        sc = (-neg).astype(jnp.int32)
    else:
        neg, idx = jax.lax.top_k(-part, k)
        sc = -neg
    cid = ridx[idx.reshape(-1)].reshape(q, k)
    cid = jnp.where(sc < _DEAD, cid, -1)
    # merge with carry: 2-key sort by (score, id) keeps scan()'s order
    msc, mid = jax.lax.sort(
        (jnp.concatenate([best_sc, sc.astype(jnp.int32)], axis=-1),
         jnp.concatenate([best_id, cid.astype(jnp.int32)], axis=-1)),
        dimension=-1, num_keys=2)
    return msc[:, :k], mid[:, :k]


@partial(jax.jit, static_argnames=("limit", "chunk", "approx", "anchor",
                                   "margin", "floor", "code_bits"))
def scan_chunked(state: ScanState | PackedScanState, qbits: jax.Array,
                 tombstones: jax.Array,
                 limit: int, chunk: int = 1 << 19,
                 approx: bool = False, anchor: int = 0, margin: int = 0,
                 floor: int = 0, code_bits: int = 0) -> RouteResult:
    """:func:`scan` with the corpus processed in ``chunk``-row blocks and a
    running top-L merge — the [Q, N] rank intermediate becomes [Q, chunk],
    so memory stays flat as N grows (the full-width scan needs Q·N·8 bytes
    of dots+rank scratch: 6.4 GB at 12.5M rows × 64 queries).

    With a :class:`PackedScanState` (pass ``code_bits``) each chunk's words
    are unpacked on-device right before the bit-matmul — the 8×-smaller
    packed matrix is what lives in device memory.

    The tail block re-reads already-scanned rows (dynamic_slice clamps);
    those duplicates are masked DEAD so every id appears at most once.
    Exact-mode merge sorts by (score, id), matching :func:`scan`'s order.
    """
    packed = isinstance(state, PackedScanState)
    if packed:
        if code_bits <= 0:
            raise ValueError("PackedScanState requires code_bits")
        n, g, w = state.words.shape
        b = g * code_bits
    else:
        n, b = state.bits.shape
    if n <= chunk:
        st = ScanState(unpack_bits_device(state.words, code_bits),
                       state.popc) if packed else state
        return scan(st, qbits, tombstones, limit, approx,
                    anchor, margin, floor)
    q = qbits.shape[0]
    k = min(limit, chunk, n)
    qpopc = jnp.sum(qbits.astype(jnp.int32), axis=1)
    nc = -(-n // chunk)

    def body(i, carry):
        start = (i * chunk).astype(jnp.int32)
        start_c = jnp.minimum(start, jnp.int32(n - chunk))
        zero = jnp.int32(0)
        if packed:
            words_c = jax.lax.dynamic_slice(state.words,
                                            (start_c, zero, zero),
                                            (chunk, g, w))
            bits_c = unpack_bits_device(words_c, code_bits)
        else:
            bits_c = jax.lax.dynamic_slice(state.bits, (start_c, zero),
                                           (chunk, b))
        popc_c = jax.lax.dynamic_slice(state.popc, (start_c,), (chunk,))
        tomb_c = jax.lax.dynamic_slice(tombstones, (start_c,), (chunk,))
        return scan_chunk_merge(qbits, bits_c, popc_c, tomb_c,
                                start, start_c, carry, approx)

    init = (jnp.full((q, k), _DEAD, jnp.int32),
            jnp.full((q, k), -1, jnp.int32))
    best_sc, best_id = jax.lax.fori_loop(0, nc, body, init)
    live = best_sc < _DEAD
    scores = jnp.where(live, best_sc + qpopc[:, None], _INF)
    ids = jnp.where(live, best_id, -1)
    n_live = jnp.sum(live, axis=-1, dtype=jnp.int32)
    n_dec = _adaptive_count(scores, anchor, margin, floor, k) \
        if margin > 0 else None
    return RouteResult(ids, scores, n_live, jnp.full_like(n_live, n), n_dec)
