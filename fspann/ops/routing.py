"""Multi-probe candidate generation as a fixed-shape jitted pipeline.

Reference behavior (index/paper/PartitionedIndexService.java:592-715): per
(table, division) group, locate the partition whose key range contains the
query key (binary search + closest-boundary fallback,
GreedyPartitioner.findNearestPartition:101-124), then run a best-first probe
over partitions ordered by Hamming(query code, partition repCode), expanding
left/right neighbors, for ``maxProbes`` partitions; collect ids scoring each
with its partition's repCode Hamming, dedupe keeping the minimum score, sort
ascending, and cap at HARD_CAP.

Fixed-shape equivalence proof used here: because partitions form a line and
expansion only ever enqueues the two outer neighbors of the probed interval,
the priority queue always contains exactly the two frontier blocks.  Hence
the probed set after k pops is a *contiguous interval* around the center, and
the walk is exactly: repeatedly extend toward whichever frontier has the
smaller repCode Hamming.  That walk is a ``lax.fori_loop`` with two pointers,
batched over ``[Q, G]`` — no data-dependent shapes, no host control flow.

Two deliberate deviations (documented for parity review):
* When HARD_CAP binds mid-collection the reference keeps earlier-table
  candidates; we keep the globally best-scored ones (strictly better).
* The reference's stage-A.5 "ranked Hamming prefilter with fallback fill"
  (QueryServiceImpl.java:167-214) is a no-op given its preceding global sort
  by score — taking the first ``refinementLimit`` of the score-sorted list is
  the identical set — so this module returns the score-ranked truncation.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .coding import keys2_from_codes
from .hamming import hamming
from .partition import PartitionTable

INT32_MAX = jnp.iinfo(jnp.int32).max
_INF = jnp.int32(INT32_MAX)


class RouteResult(NamedTuple):
    ids: jax.Array       # int32 [Q, R] candidate ids ranked by score, -1 = pad
    scores: jax.Array    # int32 [Q, R] min Hamming(query, repCode) per id
    n_unique: jax.Array  # int32 [Q] unique live candidates found
    n_raw: jax.Array     # int32 [Q] raw (pre-dedup) ids touched
    # int32 [Q] per-query adaptive decrypt budget (scan mode only, None
    # when disabled): how many of the ranked ids are score-competitive —
    # within ``adaptive_decrypt_margin`` Hamming bits of the anchor-th
    # best.  The host decrypts only ids[:n_dec[q]] per query, so easy
    # queries cost a few hundred AES opens while fringe queries keep the
    # full budget.  Computed on-device; ships with the existing counters.
    n_dec: jax.Array | None = None


def find_center(table: PartitionTable, qkeys: jax.Array,
                qkeys2: jax.Array | None = None) -> jax.Array:
    """Containing-or-closest partition per (query, group).

    ``qkeys``: int64 [Q, G] → int32 [Q, G] partition index.
    Vectorized equivalent of GreedyPartitioner.findNearestPartition:101-124:
    ``below`` (count of blocks entirely below the key) is the binary-search
    insertion point; then containment test, else closest flanking range.

    When the table was built wide (``min_key2`` present) and ``qkeys2`` is
    given, every comparison is over the lexicographic (key, key2) pair —
    the full 126-bit code-prefix order (coding.keys2_from_codes).
    """
    wide = table.min_key2 is not None and qkeys2 is not None
    g, p = table.min_key.shape
    garange = jnp.arange(g, dtype=jnp.int32)[None]                # [1, G]

    def pair_ge(a1, a2, b1, b2):
        if not wide:
            return a1 >= b1
        return (a1 > b1) | ((a1 == b1) & (a2 >= b2))

    # `below` = count of blocks with max_key < qk, via vectorized binary
    # search: log2(P) gather steps of [Q, G] instead of materializing a
    # [Q, G, P] comparison (180MB+ per batch at 10M-corpus scale)
    lo = jnp.zeros(qkeys.shape, jnp.int32)
    hi = jnp.full(qkeys.shape, p, jnp.int32)
    steps = max(1, (p + 1).bit_length())

    def bs_step(_, carry):
        lo_, hi_ = carry
        mid = (lo_ + hi_) // 2
        c = jnp.minimum(mid, p - 1)
        v = table.max_key[garange, c]
        v2 = table.max_key2[garange, c] if wide else None
        ge = pair_ge(v, v2, qkeys, qkeys2)
        return (jnp.where(ge, lo_, mid + 1), jnp.where(ge, mid, hi_))

    lo, hi = jax.lax.fori_loop(0, steps, bs_step, (lo, hi))
    below = lo
    c0 = jnp.minimum(below, p - 1)
    min_c0 = table.min_key[garange, c0]                           # [Q, G]
    min2_c0 = table.min_key2[garange, c0] if wide else None
    inside = (below < p) & pair_ge(qkeys, qkeys2, min_c0, min2_c0)

    left = jnp.maximum(below - 1, 0)
    max_left = table.max_key[garange, left]
    if wide:
        # closest flanking range under the 126-bit combined value:
        # |d| = d1*2^63 + d2 with both segments 63-bit non-negative; after
        # a borrow-normalization (d2 < 0 → d1-1, d2+2^63 — the +2^63 is an
        # int64 sign-bit flip) the pair compares lexicographically exactly.
        max2_left = table.max_key2[garange, left]

        def pair_diff(a1, a2, b1, b2):
            d1 = a1 - b1
            d2 = a2 - b2
            borrow = d2 < 0
            return (jnp.where(borrow, d1 - 1, d1),
                    jnp.where(borrow, d2 ^ jnp.int64(-2 ** 63), d2))

        dl1, dl2 = pair_diff(qkeys, qkeys2, max_left, max2_left)
        dr1, dr2 = pair_diff(min_c0, min2_c0, qkeys, qkeys2)
        dl_le = (dl1 < dr1) | ((dl1 == dr1) & (dl2 <= dr2))
    else:
        dl_le = (qkeys - max_left) <= (min_c0 - qkeys)
    mid = jnp.where(dl_le, left, c0)
    fallback = jnp.where(below <= 0, 0, jnp.where(below >= p, p - 1, mid))
    return jnp.where(inside, c0, fallback).astype(jnp.int32)


def _greedy_interval(ham_w: jax.Array, max_probes: int):
    """Greedy frontier walk over the probe window.

    ``ham_w``: int32 [..., V] window Hamming scores (INF marks out-of-range),
    window center at index ``max_probes - 1``.  Returns ``(lo, hi)`` int32
    [...] — the probed interval's window coordinates (≤ max_probes wide).
    """
    v = ham_w.shape[-1]
    c = max_probes - 1
    lo = jnp.full(ham_w.shape[:-1], c, jnp.int32)
    hi = jnp.full(ham_w.shape[:-1], c, jnp.int32)

    def step(_, state):
        lo_, hi_ = state
        hl = jnp.where(
            lo_ - 1 >= 0,
            jnp.take_along_axis(ham_w, jnp.maximum(lo_ - 1, 0)[..., None],
                                axis=-1)[..., 0], _INF)
        hr = jnp.where(
            hi_ + 1 <= v - 1,
            jnp.take_along_axis(ham_w, jnp.minimum(hi_ + 1, v - 1)[..., None],
                                axis=-1)[..., 0], _INF)
        both_dead = (hl == _INF) & (hr == _INF)
        go_left = (hl <= hr) & ~both_dead
        go_right = (hr < hl) & ~both_dead
        return (jnp.where(go_left, lo_ - 1, lo_),
                jnp.where(go_right, hi_ + 1, hi_))

    lo, hi = jax.lax.fori_loop(0, max_probes - 1, step, (lo, hi))
    return lo, hi


def _route_dedup(table: PartitionTable, qcodes: jax.Array, qkeys: jax.Array,
                 tombstones: jax.Array, max_probes: int,
                 need_scores: bool = True):
    """Shared front half of the route: probe walk → gather → dedup.

    Returns ``(sid, sscore, n_unique, n_raw)`` where ``sid``/``sscore`` are
    the flat probed candidates sorted by (id, score) with duplicates and
    pads masked to INT32_MAX/_INF — i.e. id-ascending among the live
    entries.  ``need_scores=False`` skips the score co-sort (a 1-key sort
    instead of 2-key — the rerank path recomputes scores anyway) and
    returns ``sscore=None``.
    """
    q, g, w = qcodes.shape
    p = table.num_partitions
    v = 2 * max_probes - 1
    garange = jnp.arange(g, dtype=jnp.int32)[None, :, None]       # [1, G, 1]

    # wide-key tables carry bits 63..125 boundaries; the matching query
    # secondary keys derive from the codes already in hand — callers never
    # thread them explicitly
    qkeys2 = keys2_from_codes(qcodes) if table.min_key2 is not None else None
    center = find_center(table, qkeys, qkeys2)                    # [Q, G]
    offs = jnp.arange(-(max_probes - 1), max_probes, dtype=jnp.int32)
    widx_raw = center[..., None] + offs                           # [Q, G, V]
    in_range = (widx_raw >= 0) & (widx_raw < p)
    widx = jnp.clip(widx_raw, 0, p - 1)

    # Window repCodes + Hamming scores (gathers, no [Q,G,P,*] materialization).
    rep_w = table.rep_codes[garange, widx]                        # [Q, G, V, W]
    ham_w = hamming(qcodes[:, :, None, :], rep_w)                 # [Q, G, V]
    ham_w = jnp.where(in_range, ham_w, _INF)

    lo, hi = _greedy_interval(ham_w, max_probes)                  # [Q, G]

    # Gather exactly the probed interval's blocks (≤ max_probes of them) —
    # the dedup sort then works on G*probes*B entries instead of the whole
    # G*(2*probes-1)*B window.
    woff = lo[..., None] + jnp.arange(max_probes, dtype=jnp.int32)  # [Q,G,Pr]
    in_probe = woff <= hi[..., None]
    woff_c = jnp.clip(woff, 0, v - 1)
    pidx = jnp.take_along_axis(widx, woff_c, axis=-1)             # [Q, G, Pr]
    ham_p = jnp.take_along_axis(ham_w, woff_c, axis=-1)
    in_probe &= ham_p < _INF

    cand_ids = table.ids[garange, pidx]                           # [Q,G,Pr,B]
    cand_scores = jnp.broadcast_to(ham_p[..., None], cand_ids.shape)

    alive = cand_ids >= 0
    dead = tombstones[jnp.maximum(cand_ids, 0)] & alive
    valid = in_probe[..., None] & alive & ~dead

    flat_ids = jnp.where(valid, cand_ids, INT32_MAX).reshape(q, -1)
    flat_scores = jnp.where(valid, cand_scores, _INF).reshape(q, -1)
    n_raw = jnp.sum(valid.reshape(q, -1), axis=-1, dtype=jnp.int32)

    # Dedupe keeping min score: sort by (id, score); first of each id-run wins.
    if need_scores:
        sid, sscore = jax.lax.sort((flat_ids, flat_scores), dimension=-1,
                                   num_keys=2)
    else:
        sid = jax.lax.sort(flat_ids, dimension=-1)
        sscore = None
    first = jnp.concatenate(
        [jnp.ones((q, 1), bool), sid[:, 1:] != sid[:, :-1]], axis=-1)
    live = first & (sid != INT32_MAX)
    n_unique = jnp.sum(live, axis=-1, dtype=jnp.int32)
    sid = jnp.where(live, sid, INT32_MAX)
    if need_scores:
        sscore = jnp.where(live, sscore, _INF)
    return sid, sscore, n_unique, n_raw


@partial(jax.jit, static_argnames=("max_probes", "refinement_limit"))
def route(table: PartitionTable, qcodes: jax.Array, qkeys: jax.Array,
          tombstones: jax.Array, max_probes: int,
          refinement_limit: int) -> RouteResult:
    """Stage A for a batch of queries: candidate ids ranked by Hamming score.

    Args:
      table: built PartitionTable (all groups).
      qcodes: uint32 [Q, G, W] packed query codes.
      qkeys: int64 [Q, G] query sort keys.
      tombstones: bool [N] deleted-id mask (device-resident; reference checks
        ``metadata.isDeleted`` per id, PartitionedIndexService.java:726-753).
      max_probes: partitions probed per group (effectiveMaxProbes).
      refinement_limit: R — ranked candidates returned per query.
    """
    sid, sscore, n_unique, n_raw = _route_dedup(table, qcodes, qkeys,
                                                tombstones, max_probes)

    # Final ranking by (score, id); truncate to R.
    rscore, rid = jax.lax.sort((sscore, sid), dimension=-1, num_keys=2)
    r = min(refinement_limit, rid.shape[-1])
    rid = rid[:, :r]
    rscore = rscore[:, :r]
    rid = jnp.where(rid == INT32_MAX, -1, rid)
    return RouteResult(rid, rscore, n_unique, n_raw)


@partial(jax.jit, static_argnames=("max_probes", "limit", "approx"))
def route_rerank(table: PartitionTable, qcodes: jax.Array, qkeys: jax.Array,
                 tombstones: jax.Array, point_codes: jax.Array,
                 max_probes: int, limit: int,
                 approx: bool = False) -> RouteResult:
    """Fused stage A + full-code rerank: ONE top_k instead of two sorts.

    Equivalent to ``rerank(point_codes, qcodes, route(...), limit)`` when
    the route's refinement_limit does not truncate (and a strict superset
    of its candidate pool otherwise): the coarse (score, id) ranking sort
    is skipped entirely — the fine score re-orders everything anyway — and
    the fine-score truncation uses ``lax.top_k`` on the id-sorted deduped
    array, whose lower-index tie-break reproduces the (fine, id) order
    bit-exactly.  Cuts two [Q, G·probes·B]-wide sorts from the serving
    step's critical path.
    """
    q, g, w = qcodes.shape
    sid, _, n_unique, n_raw = _route_dedup(table, qcodes, qkeys,
                                           tombstones, max_probes,
                                           need_scores=False)
    safe = jnp.minimum(sid, point_codes.shape[0] - 1)   # pads=INT32_MAX
    pc = point_codes[safe].reshape(q, sid.shape[1], g * w)
    fine = hamming(qcodes.reshape(q, 1, g * w), pc)
    k = min(limit, sid.shape[-1])
    if approx:
        # lax.approx_max_k: a platform may keep each true top-L element
        # with ~recall_target probability only (the dropped ones are
        # fine-score BOUNDARY candidates, the least likely true
        # neighbors); XLA on GPU and CPU lowers it to an exact top-k.
        # Deterministic given shapes (restore-equality safe).
        # Dead entries get the 2^30 sentinel, NOT _INF: INT32_MAX is not
        # f32-exact, and negating the saturated round trip would flip pads
        # to "best possible" (the hazard hamming_scan._DEAD documents).
        dead = jnp.int32(1 << 30)
        fa = jnp.where(sid != INT32_MAX, fine, dead)
        neg, idx = jax.lax.approx_max_k(-fa.astype(jnp.float32), k,
                                        recall_target=0.98)
        score = (-neg).astype(jnp.int32)
    else:
        fine = jnp.where(sid != INT32_MAX, fine, _INF)
        neg, idx = jax.lax.top_k(-fine, k)
        score = -neg
    rid = jnp.take_along_axis(sid, idx, axis=-1)
    score = jnp.where(rid == INT32_MAX, _INF, score)   # pads rank last
    rid = jnp.where(rid == INT32_MAX, -1, rid)
    return RouteResult(rid, score, jnp.minimum(n_unique, k), n_raw)


@partial(jax.jit, static_argnames=("limit",))
def rerank(point_codes: jax.Array, qcodes: jax.Array, res: RouteResult,
           limit: int) -> RouteResult:
    """Full-code re-rank: truncate the routed set by exact code Hamming.

    The partition-level score in :func:`route` is Hamming(query, block
    repCode) — every id in a probed block shares one coarse score.  This
    stage re-scores each candidate by the Hamming distance between the
    query's and the candidate's OWN packed codes summed across ALL
    (table, division) groups — the multi-probe LSH collision statistic at
    per-point resolution — and keeps the best ``limit``.  It is the
    per-candidate refinement of the reference's stage-A.5 ranked Hamming
    prefilter (QueryServiceImpl.java:167-214), computed from data the
    server already stores (the codes), so leakage is unchanged while the
    decrypt set (the AES wall) shrinks.

    Args:
      point_codes: uint32 [N, G, W] packed codes in dense row order.
      qcodes: uint32 [Q, G, W] packed query codes.
      res: ranked output of :func:`route` (ids are row indices, -1 pad).
      limit: decrypt budget L — ids kept per query after re-ranking.
    """
    q, g, w = qcodes.shape
    rid = res.ids                                              # [Q, R]
    safe = jnp.maximum(rid, 0)
    pc = point_codes[safe].reshape(q, rid.shape[1], g * w)     # [Q, R, G*W]
    fine = hamming(qcodes.reshape(q, 1, g * w), pc)            # [Q, R]
    fine = jnp.where(rid >= 0, fine, _INF)
    fscore, fid = jax.lax.sort((fine, rid), dimension=-1, num_keys=2)
    r = min(limit, rid.shape[-1])
    return RouteResult(fid[:, :r], fscore[:, :r],
                       jnp.minimum(res.n_unique, r), res.n_raw)
