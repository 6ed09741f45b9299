/* Native packed Hamming scan + exact top-L selection — the CPU-serving
 * twin of the device bit-matmul scan (ops/hamming_scan.py).
 *
 * Role: stage A of the serving pipeline when no accelerator is present
 * (CPU-only deployments).  The XLA:CPU path scores
 * through the UNPACKED int8 bit matrix (8 bytes streamed per code bit per
 * query batch: ~3 GB/batch at 1M x 3,072-bit codes); this kernel streams
 * the PACKED uint32 words once (384 MB), XOR+popcounts them against every
 * query (AVX-512 VPOPCNTDQ when available), and selects the exact global
 * top-L per query by score histogram — the same (score, id)-ascending
 * order as the device scan's exact mode, so results are interchangeable.
 *
 * Replaces the reference's stage-A probe machinery on CPU exactly like
 * the device scan does (reference PartitionedIndexService.java:592-715);
 * scoring semantics: Hamming(q, c) = popcount(q XOR c), identical to the
 * device rank popc[c] - 2*<q,c> + popc[q].
 *
 * Pass-1 shape (the hot loop): rows outer, queries inner in blocks of 8.
 * Per row the 8-query block shares the row's chunk loads and ends in ONE
 * 8-accumulator transpose-reduce tree (14 shuffles for 8 horizontal sums)
 * instead of 8 per-pair reduces — the per-pair cost is 3 VPU ops
 * (xor+vpopcntd+add) per 512-bit chunk plus ~0.5 shuffle, against ~30
 * cycles/pair for the naive per-pair loop on this class of core.
 *
 * Selection: scores are bounded by the code width (<= w32*32), so the
 * exact per-query L-th score comes from a histogram (no sort over N):
 *   pass 1  stream corpus, write uint16 scores[q][n] + histograms
 *   pass 2  per query: threshold from the histogram's running sum, then
 *           one sequential sweep of its score row collecting ids with
 *           score < t, plus the first (by row id) entries at score == t
 *   sort    the <= L collected entries by (score, id) — matches the
 *           device scan_chunked 2-key merge order bit-exactly.
 */

#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

#define DEAD16 0xFFFFu

/* ---- single-pair scoring (query-block tails, non-x86 fallback) --------- */

static uint32_t score_one_scalar(const uint32_t *row, const uint32_t *qw,
                                 uint32_t w32) {
    uint32_t h = 0, c = 0;
    for (; c + 2 <= w32; c += 2) {
        uint64_t a, b;
        memcpy(&a, row + c, 8);
        memcpy(&b, qw + c, 8);
        h += (uint32_t)__builtin_popcountll(a ^ b);
    }
    if (c < w32) h += (uint32_t)__builtin_popcount(row[c] ^ qw[c]);
    return h;
}

#if defined(__x86_64__)

__attribute__((target("avx512f,avx512vpopcntdq")))
static uint32_t score_one_avx512(const uint32_t *row, const uint32_t *qw,
                                 uint32_t w32) {
    const uint32_t tail = w32 & 15;
    const uint32_t body = w32 - tail;
    __m512i acc = _mm512_setzero_si512();
    for (uint32_t c = 0; c < body; c += 16) {
        __m512i r = _mm512_loadu_si512((const void *)(row + c));
        __m512i k = _mm512_loadu_si512((const void *)(qw + c));
        acc = _mm512_add_epi32(acc,
                               _mm512_popcnt_epi32(_mm512_xor_si512(r, k)));
    }
    if (tail) {
        const __mmask16 tm = (__mmask16)((1u << tail) - 1);
        __m512i r = _mm512_maskz_loadu_epi32(tm, row + body);
        __m512i k = _mm512_maskz_loadu_epi32(tm, qw + body);
        acc = _mm512_add_epi32(acc,
                               _mm512_popcnt_epi32(_mm512_xor_si512(r, k)));
    }
    return (uint32_t)_mm512_reduce_add_epi32(acc);
}

/* ---- 8-query block: shared row loads + one transpose-reduce tree ------- */

/* 8 lane-wise u32 accumulators -> 8 horizontal sums.  Two unpack levels
 * build per-128-bit-lane partials [q0..q3] / [q4..q7]; the shuffle_i32x4
 * level folds quarters pairwise; the final cross-quarter add happens on
 * the 16-word spill (free scalar ports — the VPU ports are the
 * bottleneck). */
__attribute__((target("avx512f")))
static inline void reduce8_avx512(__m512i a0, __m512i a1, __m512i a2,
                                  __m512i a3, __m512i a4, __m512i a5,
                                  __m512i a6, __m512i a7, uint32_t *out8) {
    __m512i s01 = _mm512_add_epi32(_mm512_unpacklo_epi32(a0, a1),
                                   _mm512_unpackhi_epi32(a0, a1));
    __m512i s23 = _mm512_add_epi32(_mm512_unpacklo_epi32(a2, a3),
                                   _mm512_unpackhi_epi32(a2, a3));
    __m512i s45 = _mm512_add_epi32(_mm512_unpacklo_epi32(a4, a5),
                                   _mm512_unpackhi_epi32(a4, a5));
    __m512i s67 = _mm512_add_epi32(_mm512_unpacklo_epi32(a6, a7),
                                   _mm512_unpackhi_epi32(a6, a7));
    __m512i lo4 = _mm512_add_epi32(_mm512_unpacklo_epi64(s01, s23),
                                   _mm512_unpackhi_epi64(s01, s23));
    __m512i hi4 = _mm512_add_epi32(_mm512_unpacklo_epi64(s45, s67),
                                   _mm512_unpackhi_epi64(s45, s67));
    /* quarters: [lo4.q0+lo4.q1, lo4.q2+lo4.q3, hi4.q0+q1, hi4.q2+q3] */
    __m512i t = _mm512_add_epi32(_mm512_shuffle_i32x4(lo4, hi4, 0x88),
                                 _mm512_shuffle_i32x4(lo4, hi4, 0xDD));
    uint32_t buf[16] __attribute__((aligned(64)));
    _mm512_store_si512((void *)buf, t);
    for (int i = 0; i < 4; i++) {
        out8[i] = buf[i] + buf[4 + i];
        out8[4 + i] = buf[8 + i] + buf[12 + i];
    }
}

__attribute__((target("avx512f,avx512vpopcntdq")))
static void score_block8_avx512(const uint32_t *row, const uint32_t *qblock,
                                uint32_t w32, uint32_t *out8) {
    const uint32_t tail = w32 & 15;
    const uint32_t body = w32 - tail;
    const uint32_t *q0 = qblock;
    const uint32_t *q1 = qblock + (size_t)w32;
    const uint32_t *q2 = qblock + (size_t)w32 * 2;
    const uint32_t *q3 = qblock + (size_t)w32 * 3;
    const uint32_t *q4 = qblock + (size_t)w32 * 4;
    const uint32_t *q5 = qblock + (size_t)w32 * 5;
    const uint32_t *q6 = qblock + (size_t)w32 * 6;
    const uint32_t *q7 = qblock + (size_t)w32 * 7;
    __m512i a0 = _mm512_setzero_si512(), a1 = a0, a2 = a0, a3 = a0;
    __m512i a4 = a0, a5 = a0, a6 = a0, a7 = a0;
#define STEP(LOAD, OFF)                                                     \
    do {                                                                    \
        __m512i r = LOAD(row + (OFF));                                    \
        a0 = _mm512_add_epi32(a0, _mm512_popcnt_epi32(                      \
                 _mm512_xor_si512(r, LOAD(q0 + (OFF)))));                 \
        a1 = _mm512_add_epi32(a1, _mm512_popcnt_epi32(                      \
                 _mm512_xor_si512(r, LOAD(q1 + (OFF)))));                 \
        a2 = _mm512_add_epi32(a2, _mm512_popcnt_epi32(                      \
                 _mm512_xor_si512(r, LOAD(q2 + (OFF)))));                 \
        a3 = _mm512_add_epi32(a3, _mm512_popcnt_epi32(                      \
                 _mm512_xor_si512(r, LOAD(q3 + (OFF)))));                 \
        a4 = _mm512_add_epi32(a4, _mm512_popcnt_epi32(                      \
                 _mm512_xor_si512(r, LOAD(q4 + (OFF)))));                 \
        a5 = _mm512_add_epi32(a5, _mm512_popcnt_epi32(                      \
                 _mm512_xor_si512(r, LOAD(q5 + (OFF)))));                 \
        a6 = _mm512_add_epi32(a6, _mm512_popcnt_epi32(                      \
                 _mm512_xor_si512(r, LOAD(q6 + (OFF)))));                 \
        a7 = _mm512_add_epi32(a7, _mm512_popcnt_epi32(                      \
                 _mm512_xor_si512(r, LOAD(q7 + (OFF)))));                 \
    } while (0)
#define LOADU(P) _mm512_loadu_si512((const void *)(P))
    for (uint32_t c = 0; c < body; c += 16) STEP(LOADU, c);
    if (tail) {
        const __mmask16 tm = (__mmask16)((1u << tail) - 1);
#define LOADT(P) _mm512_maskz_loadu_epi32(tm, (P))
        STEP(LOADT, body);
#undef LOADT
    }
#undef LOADU
#undef STEP
    reduce8_avx512(a0, a1, a2, a3, a4, a5, a6, a7, out8);
}

#endif /* __x86_64__ */

/* ---- pass 1: scores + histograms over a row range ---------------------- */

typedef struct {
    const uint32_t *words;
    const uint32_t *qwords;
    const uint8_t *dead;
    uint16_t *scores;     /* [q][n] */
    uint32_t *hist;       /* thread-private [q][bins] */
    uint64_t n, lo, hi;
    uint32_t w32, q, bins;
    int use_avx512;
} pass1_t;

static void *pass1_run(void *arg) {
    pass1_t *t = (pass1_t *)arg;
    const uint32_t q = t->q, w32 = t->w32, bins = t->bins;
    const uint64_t n = t->n;
    uint32_t out8[8];
    for (uint64_t r = t->lo; r < t->hi; r++) {
        if (t->dead && t->dead[r]) {
            for (uint32_t qi = 0; qi < q; qi++)
                t->scores[(size_t)qi * n + r] = DEAD16;
            continue;
        }
        const uint32_t *row = t->words + (size_t)r * w32;
        uint32_t qi = 0;
#if defined(__x86_64__)
        if (t->use_avx512) {
            for (; qi + 8 <= q; qi += 8) {
                score_block8_avx512(row, t->qwords + (size_t)qi * w32,
                                    w32, out8);
                for (uint32_t j = 0; j < 8; j++)
                    t->scores[(size_t)(qi + j) * n + r] =
                        (uint16_t)out8[j];
            }
            for (; qi < q; qi++)
                t->scores[(size_t)qi * n + r] = (uint16_t)score_one_avx512(
                    row, t->qwords + (size_t)qi * w32, w32);
        }
#else
        (void)out8;
#endif
        for (; qi < q; qi++)
            t->scores[(size_t)qi * n + r] = (uint16_t)score_one_scalar(
                row, t->qwords + (size_t)qi * w32, w32);
        for (uint32_t h = 0; h < q; h++)
            t->hist[(size_t)h * bins + t->scores[(size_t)h * n + r]]++;
    }
    return NULL;
}

/* ---- top-L assembly ---------------------------------------------------- */

static int cmp_u64(const void *a, const void *b) {
    uint64_t x = *(const uint64_t *)a, y = *(const uint64_t *)b;
    return (x > y) - (x < y);
}

typedef struct {
    const uint32_t *hist;   /* merged [q][bins] */
    const uint16_t *scores; /* [q][n] */
    int32_t *out_ids;
    int32_t *out_scores;
    uint64_t *keys;         /* thread-private [l] */
    uint64_t n, n_live;
    uint32_t bins, l, q_lo, q_hi;
} pass2_t;

static void *pass2_run(void *arg) {
    pass2_t *t = (pass2_t *)arg;
    const uint64_t n = t->n;
    const uint32_t bins = t->bins, l = t->l;
    for (uint32_t qi = t->q_lo; qi < t->q_hi; qi++) {
        const uint32_t *h = t->hist + (size_t)qi * bins;
        const uint16_t *sr = t->scores + (size_t)qi * n;
        /* threshold: smallest score s with cumcount(<=s) >= l */
        uint64_t cum = 0, below = 0;
        uint32_t thresh = bins;     /* > any score: take every live row */
        for (uint32_t b = 0; b < bins; b++) {
            cum += h[b];
            if (cum >= l) { thresh = b; below = cum - h[b]; break; }
        }
        uint64_t need_eq = (thresh < bins) ? (uint64_t)l - below : t->n_live;
        uint32_t filled = 0;
        for (uint64_t r = 0; r < n && filled < l; r++) {
            uint16_t s = sr[r];
            if (s == DEAD16) continue;
            if (thresh < bins) {
                if (s > thresh) continue;
                if (s == thresh) {
                    if (!need_eq) continue;
                    need_eq--;
                }
            }
            t->keys[filled++] = ((uint64_t)s << 32) | (uint32_t)r;
        }
        qsort(t->keys, filled, 8, cmp_u64);
        int32_t *oi = t->out_ids + (size_t)qi * l;
        int32_t *os = t->out_scores + (size_t)qi * l;
        for (uint32_t i = 0; i < filled; i++) {
            oi[i] = (int32_t)(t->keys[i] & 0xFFFFFFFFu);
            os[i] = (int32_t)(t->keys[i] >> 32);
        }
        for (uint32_t i = filled; i < l; i++) {
            oi[i] = -1;
            os[i] = INT32_MAX;
        }
    }
    return NULL;
}

/* Scores every corpus row against every query and writes the exact
 * per-query top-L by (score, row id) ascending.  out_ids: -1 pad,
 * out_scores: INT32_MAX pad.  Returns the number of live (non-dead)
 * rows, or -1 on allocation failure.
 *
 *   words   uint32 [n, w32]   packed corpus codes (group pads zero)
 *   qwords  uint32 [q, w32]   packed query codes (same packer)
 *   dead    uint8  [n] or NULL  nonzero = tombstoned/not-yet-live
 *   out_ids/out_scores int32 [q, l]
 *   threads pass-1 row-range split (per-thread histograms merged here)
 *           and pass-2 query-range split (per-thread key buffers)
 */
int fspann_hamming_topl(const uint32_t *words, uint64_t n, uint32_t w32,
                        const uint32_t *qwords, uint32_t q,
                        const uint8_t *dead, uint32_t l,
                        int32_t *out_ids, int32_t *out_scores,
                        int threads) {
    if (!n || !q || !l) return 0;
    const uint32_t bins = w32 * 32 + 1;
    if (threads < 1) threads = 1;
    if ((uint64_t)threads > n) threads = (int)n;

    if (threads > 64) threads = 64;
    uint16_t *scores = (uint16_t *)malloc((size_t)q * n * 2);
    uint32_t *hist =
        (uint32_t *)calloc((size_t)threads * q * bins, 4);
    uint64_t *keys = (uint64_t *)malloc((size_t)threads * l * 8);
    if (!scores || !hist || !keys) {
        free(scores); free(hist); free(keys);
        return -1;
    }

    int use_avx512 = 0;
#if defined(__x86_64__)
    use_avx512 = __builtin_cpu_supports("avx512f")
        && __builtin_cpu_supports("avx512vpopcntdq");
#endif
    pass1_t tasks[64];
    pthread_t tids[64];
    int spawned[64] = {0};
    uint64_t per = (n + threads - 1) / threads;
    for (int t = 0; t < threads; t++) {
        tasks[t] = (pass1_t){words, qwords, dead, scores,
                             hist + (size_t)t * q * bins,
                             n, (uint64_t)t * per, 0, w32, q, bins,
                             use_avx512};
        tasks[t].hi = tasks[t].lo + per < n ? tasks[t].lo + per : n;
        if (t + 1 < threads) {
            /* a failed create (EAGAIN on a loaded host) degrades to
             * running the range inline — never an unwritten range or a
             * join on an uninitialized handle */
            if (pthread_create(&tids[t], NULL, pass1_run, &tasks[t]) == 0)
                spawned[t] = 1;
            else
                pass1_run(&tasks[t]);
        }
    }
    pass1_run(&tasks[threads - 1]);     /* calling thread takes the tail */
    for (int t = 0; t + 1 < threads; t++)
        if (spawned[t]) pthread_join(tids[t], NULL);
    for (int t = 1; t < threads; t++)   /* merge per-thread histograms */
        for (size_t i = 0; i < (size_t)q * bins; i++)
            hist[i] += hist[(size_t)t * q * bins + i];

    uint64_t n_live = n;
    if (dead)
        for (uint64_t r = 0; r < n; r++) n_live -= (dead[r] != 0);

    /* pass 2: per-query threshold + collect + sort, split over queries */
    int t2 = threads < (int)q ? threads : (int)q;
    pass2_t sel[64];
    uint32_t qper = (q + t2 - 1) / t2;
    for (int t = 0; t < t2; t++) {
        uint32_t lo = (uint32_t)t * qper;
        uint32_t hi = lo + qper < q ? lo + qper : q;
        sel[t] = (pass2_t){hist, scores, out_ids, out_scores,
                           keys + (size_t)t * l, n, n_live, bins, l,
                           lo, hi};
        spawned[t] = 0;
        if (t + 1 < t2) {
            if (pthread_create(&tids[t], NULL, pass2_run, &sel[t]) == 0)
                spawned[t] = 1;
            else
                pass2_run(&sel[t]);     /* inline fallback, own keys slot */
        }
    }
    pass2_run(&sel[t2 - 1]);
    for (int t = 0; t + 1 < t2; t++)
        if (spawned[t]) pthread_join(tids[t], NULL);

    free(scores); free(hist); free(keys);
    return (int)(n_live > 0x7FFFFFFF ? 0x7FFFFFFF : n_live);
}
