"""LSH coding (reference "Algorithm-1") as batched device matmuls + bit packing.

Reference behavior being reproduced (index/paper/Coding.java):

* A ``GFunction`` per (table, division) group ``g``: row-normalized Gaussian
  projections ``alpha[g, m, d]``, offsets ``r[g, m] ∈ [0, ω)``, widths
  ``omega[g, m] > 0`` (Coding.java:52-97).
* ``H(v)_j = floor((alpha_j · v + r_j) / omega_j)`` (Coding.java:250-258).
* ``C(v)`` = MSB-first bit-interleaved code of ``m*lam`` bits: position
  ``p = l*m + j`` holds bit ``lam-1-l`` of ``H_j`` (Coding.java:285-301).
  The reference XORs ``0x8000_0000`` before extraction; that flips only bit
  31, which is never extracted for ``lam <= 8``, so it is a no-op we omit.
* Data-adaptive widths: ``omega_j = projected_range_j / OMEGA_DIVISOR`` from a
  sample (Coding.java:184-241, divisor 2.5).
* 63-bit sortable key: code bit ``p`` → key bit ``62-p``, ``p < 63``
  (GreedyPartitioner.java:87-96).

Accelerator design: the whole bank is one tensor, so coding N vectors for all
G = tables*divisions groups is a single ``[N,d] x [d, G*m]`` matmul, followed
by vectorized elementwise packing.  Codes are packed
MSB-first into uint32 words so that (a) Hamming distance is XOR+popcount on
words and (b) the int64 sort key is two shifts away.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.tree_util.register_dataclass,
         data_fields=("alpha", "r", "omega"),
         meta_fields=("m", "lam", "tables", "divisions", "seed"))
@dataclasses.dataclass(frozen=True)
class GBank:
    """All G = tables*divisions hash functions as one pytree.

    Replaces the reference's global mutable ``GFunctionRegistry`` singleton
    (index/paper/GFunctionRegistry.java) with an immutable value that is a
    deterministic function of ``(seed, m, lam, tables, divisions, sample)``.
    The integer hyperparameters are pytree metadata (static under ``jit``).
    """

    alpha: jax.Array   # f32 [G, m, d]  row-normalized Gaussian projections
    r: jax.Array       # f32 [G, m]     offsets in [0, omega)
    omega: jax.Array   # f32 [G, m]     bucket widths > 0
    # NOTE: banks are BUILT on the host CPU backend and held as numpy
    # arrays (device-free build — see _cpu_device below); device consumers
    # transfer them once (index service caches a device copy, the mesh
    # device_puts per shard).  jit accepts the numpy fields directly.
    m: int
    lam: int
    tables: int
    divisions: int
    seed: int

    @property
    def g(self) -> int:
        return self.tables * self.divisions

    @property
    def d(self) -> int:
        return self.alpha.shape[-1]

    @property
    def code_bits(self) -> int:
        return self.m * self.lam

    @property
    def code_words(self) -> int:
        return (self.code_bits + 31) // 32


def _cpu_device():
    """The host CPU device, on which every bank is built.

    Determinism: alpha regenerates from the seed on restore
    (``bank_from_stats``); pinning the RNG + normalize to one backend makes
    the bank bit-identical across CPU tests, GPU serving and any other
    platform (threefry bits are platform-stable; the f32 normalize
    reduction order is not guaranteed to be).

    The package ``__init__`` appends ``cpu`` to an explicit platform list,
    so this backend exists unless a caller narrowed the list afterwards.
    Then this raises: a bank built on another backend would silently break
    restore equality.
    """
    msg = ("no CPU backend: LSH banks are built on the host CPU for "
           "determinism — keep 'cpu' in jax_platforms")
    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        raise RuntimeError(msg)
    try:
        return jax.local_devices(backend="cpu")[0]
    except RuntimeError as e:
        raise RuntimeError(msg) from e


def _alpha_from_seed(seed: int, g: int, m: int, d: int) -> np.ndarray:
    with jax.default_device(_cpu_device()):
        key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                                 0x414C5048)
        a = jax.random.normal(key, (g, m, d), dtype=jnp.float32)
        norm = jnp.sqrt(jnp.maximum(jnp.sum(a * a, axis=-1, keepdims=True),
                                    1e-12))
        return np.asarray(a / norm)


def _r_unit_from_seed(seed: int, g: int, m: int) -> np.ndarray:
    with jax.default_device(_cpu_device()):
        key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                                 0x4F464653)
        return np.asarray(jax.random.uniform(key, (g, m), dtype=jnp.float32))


def build_random_bank(d: int, m: int, lam: int, tables: int, divisions: int,
                      seed: int, omega: float = 1.0) -> GBank:
    """Uniform-width bank when no sample statistics are available
    (reference Coding.buildRandomG:136-161)."""
    g = tables * divisions
    alpha = _alpha_from_seed(seed, g, m, d)
    om = np.full((g, m), np.float32(omega))
    r = _r_unit_from_seed(seed, g, m) * om
    return GBank(alpha, r, om, m, lam, tables, divisions, seed)


@partial(jax.jit, static_argnames=("omega_divisor",))
def _omega_from_sample(sample: jax.Array, alpha: jax.Array, r_unit: jax.Array,
                       omega_divisor: float) -> tuple:
    # [S, G, m] projections of the sample; one matmul.
    proj = jnp.einsum("sd,gmd->sgm", sample.astype(jnp.float32), alpha,
                      precision=jax.lax.Precision.HIGHEST)
    rng = jnp.max(proj, axis=0) - jnp.min(proj, axis=0)          # [G, m]
    omega = jnp.maximum(rng, 1e-6) / jnp.float32(omega_divisor)  # ref :224-236
    omega = jnp.where(omega > 0, omega, 1e-3)
    return r_unit * omega, omega


def build_bank_from_sample(sample: np.ndarray | jax.Array, m: int, lam: int,
                           tables: int, divisions: int, seed: int,
                           omega_divisor: float = 2.5) -> GBank:
    """Data-adaptive bank (reference Coding.buildFromSample:184-241).

    ``alpha`` is computed OUTSIDE the jitted stats function so a checkpoint
    rebuild (``bank_from_stats``) reproduces it bitwise — fusion inside jit
    can differ by 1 ULP from the op-by-op path.
    """
    g = tables * divisions
    d = np.shape(sample)[-1]
    alpha = _alpha_from_seed(seed, g, m, d)
    r_unit = _r_unit_from_seed(seed, g, m)
    with jax.default_device(_cpu_device()):
        r, omega = _omega_from_sample(
            jnp.asarray(np.asarray(sample), jnp.float32), alpha, r_unit,
            omega_divisor)
        r, omega = np.asarray(r), np.asarray(omega)
    return GBank(alpha, r, omega, m, lam, tables, divisions, seed)


def bank_from_stats(omega: np.ndarray, r: np.ndarray, d: int, m: int, lam: int,
                    tables: int, divisions: int, seed: int) -> GBank:
    """Rebuild a bank from persisted (omega, r) stats + seed — the checkpoint
    path: alpha is regenerated from the seed, stats are exact."""
    g = tables * divisions
    alpha = _alpha_from_seed(seed, g, m, d)
    return GBank(alpha, np.asarray(r, np.float32),
                 np.asarray(omega, np.float32), m, lam, tables, divisions,
                 seed)


# ----------------------------------------------------------------------------
# Coding kernels
# ----------------------------------------------------------------------------

def project_h(x: jax.Array, bank: GBank) -> jax.Array:
    """``H`` for a batch: int32 [N, G, m] (reference Coding.H:250-258)."""
    y = jnp.einsum("nd,gmd->ngm", x.astype(jnp.float32), bank.alpha,
                   precision=jax.lax.Precision.HIGHEST)
    h = jnp.floor((y + bank.r) / bank.omega)
    return h.astype(jnp.int32)


def pack_codes(h: jax.Array, m: int, lam: int) -> jax.Array:
    """Interleave + pack ``H`` into uint32 words, MSB-first.

    Position ``p = l*m + j`` (level l = 0 is the most significant bit of each
    h_j) is stored at bit ``31 - p%32`` of word ``p//32``, so word-wise
    unsigned lexicographic order == code prefix order.
    Output: uint32 [..., W].
    """
    bits_total = m * lam
    w = (bits_total + 31) // 32
    hu = h.astype(jnp.uint32)
    # levels l = 0..lam-1 extract bit lam-1-l of each h_j  -> [..., lam, m]
    shifts = jnp.arange(lam - 1, -1, -1, dtype=jnp.uint32)
    bits = (hu[..., None, :] >> shifts[:, None]) & jnp.uint32(1)
    bits = bits.reshape(*h.shape[:-1], bits_total)
    pad = w * 32 - bits_total
    if pad:
        bits = jnp.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    bits = bits.reshape(*h.shape[:-1], w, 32)
    weights = (jnp.uint32(1) << (jnp.uint32(31) - jnp.arange(32, dtype=jnp.uint32)))
    return jnp.sum(bits * weights, axis=-1, dtype=jnp.uint32)


def keys_from_codes(codes: jax.Array) -> jax.Array:
    """63-bit sortable key from packed code words
    (reference GreedyPartitioner.computeKey:87-96).

    key bit ``62-p`` = code bit ``p`` for ``p < 63``; with MSB-first packing
    this is ``(w0 << 31) | (w1 >> 1)``.
    """
    w0 = codes[..., 0].astype(jnp.int64)
    if codes.shape[-1] > 1:
        w1 = codes[..., 1].astype(jnp.int64)
        return (w0 << 31) | (w1 >> 1)
    return w0 << 31


def keys2_from_codes(codes: jax.Array) -> jax.Array:
    """Secondary sort key: code bits 63..125 (the bits the 63-bit primary
    key truncates), MSB-first — ``key2 bit 62-(p-63) = code bit p``.

    The reference's ``computeKey`` (GreedyPartitioner.java:87-96) keeps only
    the first 63 code bits, so at ``m*lam > 63`` (e.g. lambda=3 ladders, or
    the m=64 scan-parity geometry's 128-bit codes) the partition order is
    arbitrary within 63-bit ties.  Round-5 diagnostic
    (scripts/diag_lambda3.py): on the glove family at lambda=3 the
    full-code order recovers the ENTIRE truncation loss (r@100 0.5752 →
    0.6817 ≡ the lambda=2 point).  Sorting by the (key, key2) pair restores
    the exact code-prefix order up to 126 bits; for ``m*lam <= 63`` the
    packing pads with zeros so key2 == 0 everywhere and the pair order
    degenerates to the reference order (``runtime.wide_keys`` gates use).

    With MSB-first word packing (code bit ``p`` at bit ``31 - p%32`` of
    word ``p//32``): bit 63 is word1's LSB, bits 64..95 are word2, bits
    96..125 the top 30 bits of word3.
    """
    w = codes.shape[-1]
    z = jnp.zeros_like(codes[..., 0])
    w1 = codes[..., 1] if w > 1 else z
    w2 = codes[..., 2] if w > 2 else z
    w3 = codes[..., 3] if w > 3 else z
    return ((w1.astype(jnp.int64) & 1) << 62) \
        | (w2.astype(jnp.int64) << 30) | (w3.astype(jnp.int64) >> 2)


def keys2_from_codes_numpy(codes: "np.ndarray") -> "np.ndarray":
    """Numpy twin of :func:`keys2_from_codes` (host build path)."""
    w = codes.shape[-1]
    z = np.zeros(codes.shape[:-1], np.int64)
    w1 = codes[..., 1].astype(np.int64) if w > 1 else z
    w2 = codes[..., 2].astype(np.int64) if w > 2 else z
    w3 = codes[..., 3].astype(np.int64) if w > 3 else z
    return ((w1 & 1) << 62) | (w2 << 30) | (w3 >> 2)


def h1(x: jax.Array, bank: GBank) -> jax.Array:
    """Collapse multi-projection H into one int32 hash per (vector, group)
    via 31x+h mixing (reference Coding.H1:264-271) — a cheap bucketing hash
    for diagnostics/sharding."""
    h = project_h(x, bank)

    def mix(acc, col):
        return acc * jnp.int32(31) + col, None

    acc, _ = jax.lax.scan(mix, jnp.zeros(h.shape[:-1], jnp.int32),
                          jnp.moveaxis(h, -1, 0))
    return acc


@partial(jax.jit, static_argnames=())
def encode(x: jax.Array, bank: GBank) -> tuple[jax.Array, jax.Array]:
    """Full coding pipeline: vectors → (packed codes, sort keys).

    Returns ``codes: uint32 [N, G, W]`` and ``keys: int64 [N, G]``.
    Replaces the reference's per-vector ``Coding.C`` loops
    (PartitionedIndexService.java:331-346 hot loop) with one matmul and
    elementwise packing for the whole batch across all tables and divisions.
    """
    h = project_h(x, bank)
    codes = pack_codes(h, bank.m, bank.lam)
    keys = keys_from_codes(codes)
    return codes, keys


# ----------------------------------------------------------------------------
# Host (numpy) encode path — used when ingestion runs on the host
# ----------------------------------------------------------------------------

def encode_numpy(x: np.ndarray, bank: GBank,
                 chunk: int = 4096) -> tuple[np.ndarray, np.ndarray]:
    """Same pipeline as :func:`encode` in pure numpy (BLAS matmul + packing).

    Used for host-side ingestion (``runtime.encode_backend="cpu"``), which
    keeps the insert path free of per-batch device round trips.  Corpus and queries must be encoded on the SAME backend — f32 rounding can
    differ across backends exactly at bucket boundaries.

    Rows are processed in ``chunk`` blocks so the elementwise/packing
    temporaries (y, h, bits — ~10 bytes per code bit per row) stay
    cache-resident: a 100k-row batch at 3,072-bit codes otherwise streams
    ~6 GB of f32 projections through DRAM EIGHT times (projection, +r,
    /omega, floor, cast, shift/mask, pad, packbits), and on the
    bandwidth-starved serving host those passes — not the BLAS — dominated
    the whole 1M build (profile_build.py: encode 225 s of 236 s insert;
    chunking cuts it ~4x).  Per-chunk results are bit-identical to the
    whole-batch computation (all ops are elementwise or row-local)."""
    a = np.asarray(bank.alpha, np.float32)
    r = np.asarray(bank.r, np.float32)
    om = np.asarray(bank.omega, np.float32)
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    m, lam, w = bank.m, bank.lam, bank.code_words
    g = a.shape[0]
    a2 = np.ascontiguousarray(a.reshape(g * m, -1).T)   # [d, g*m] for BLAS
    shifts = np.arange(lam - 1, -1, -1, dtype=np.uint32)
    pad = w * 32 - lam * m
    codes = np.empty((n, g, w), np.uint32)
    keys = np.empty((n, g), np.int64)
    for lo in range(0, n, chunk):
        xs = x[lo:lo + chunk]
        y = (xs @ a2).reshape(len(xs), g, m)
        h = np.floor((y + r) / om).astype(np.int32)
        hu = h.astype(np.uint32)
        # uint8 bit matrix + np.packbits (MSB-first — exactly the weight
        # order of the packed-word layout)
        bits = (((hu[..., None, :] >> shifts[:, None]) & np.uint32(1))
                .astype(np.uint8))
        bits = bits.reshape(*h.shape[:-1], lam * m)
        if pad:
            bits = np.pad(bits,
                          [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
        packed = np.packbits(bits, axis=-1)        # [..., w*4] bytes
        c = (np.ascontiguousarray(packed)
             .view(">u4").astype(np.uint32))       # [..., w] MSB-first
        codes[lo:lo + len(xs)] = c
        k = c[..., 0].astype(np.int64) << 31
        if w > 1:
            k = k | (c[..., 1].astype(np.int64) >> 1)
        keys[lo:lo + len(xs)] = k
    return codes, keys
