"""System configuration: JSON + named profile overrides + runtime flags.

Mirrors the capability surface of the reference's config module
(``config/src/main/java/com/fspann/config/SystemConfig.java``): a top-level
config with nested ``paper`` / ``runtime`` / ``eval`` / ``ratio`` /
``reencryption`` / ``output`` blocks, named profiles that override blocks,
validation + clamping, and a provenance SHA-256 of the raw config file
(reference ``api/ApiSystemConfig.java:42,73``).

The device build treats the config as *static compile-time shape information*:
``paper`` + ``runtime`` fields fix the shapes of every jitted routing
computation, so a config change recompiles rather than re-branching.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings
from dataclasses import dataclass, field
from typing import Any


def _clamp(v: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, v))


@dataclass(frozen=True)
class PaperConfig:
    """LSH-coding hyperparameters (reference SystemConfig.PaperConfig:237-263)."""

    m: int = 24          # projections per (table, division)
    lam: int = 2         # bits kept per projection ("lambda")
    divisions: int = 3
    tables: int = 6
    seed: int = 13
    omega_divisor: float = 2.5  # data-adaptive bucket width = range / divisor

    @property
    def num_groups(self) -> int:
        """G = tables * divisions — the leading axis of all routing arrays."""
        return self.tables * self.divisions

    @property
    def code_bits(self) -> int:
        return self.m * self.lam

    @property
    def code_words(self) -> int:
        """uint32 words per packed code."""
        return (self.code_bits + 31) // 32

    def validate(self) -> None:
        if self.m <= 0 or self.lam <= 0 or self.divisions <= 0 or self.tables <= 0:
            raise ValueError(f"paper config must be positive: {self}")
        if self.lam > 8:
            raise ValueError("lambda > 8 unsupported (code would exceed sane width)")


@dataclass(frozen=True)
class RuntimeConfig:
    """Query-time bounds (reference SystemConfig.RuntimeConfig:265-338)."""

    refinement_limit: int = 20_000
    max_global_candidates: int = 20_000
    probe_override: int = -1          # -1 => default probes
    default_probes: int = 5           # reference PartitionedIndexService.java:93
    hamming_prefilter_threshold: int = 0  # 0 = disabled
    # Stage-A backend: "probe" = reference-parity multi-probe partition
    # routing (+ optional rerank below); "scan" = Hamming scan — score
    # EVERY point's full code against the query batch as one int8 bit
    # matmul and take the global top-L (ops/hamming_scan.py).  Scan is the
    # flagship: exact global fine ranking, no probe misses, costs
    # N*G*m*lambda int8 bytes of device memory (1.15 GB at 1M default).
    routing_mode: str = "probe"
    # Full-code re-rank (stage A.5): when > 0, the index keeps every
    # point's packed codes in device memory and re-scores the routed candidate
    # set by exact multi-table code Hamming (the per-CANDIDATE refinement of
    # the reference's partition-level hammingPrefilterThreshold,
    # QueryServiceImpl.java:167-214), truncating the decrypt set to this
    # many ids.  Uses only information the server already holds (the codes),
    # so the leakage profile is unchanged; costs G*W words/point.
    rerank_limit: int = 0
    # Flat-scan scratch budget in MB (scan mode): the [Q, N] rank scratch
    # switches to the chunked running-top-L scan past this.  0 = auto from
    # the scan device's reported free memory (index/service.py).
    scan_flat_budget_mb: int = 0
    # Scan-state device layout: "off" = unpacked int8 bit matrix (N*B
    # bytes, fastest — one read per scan), "on" = packed uint32 words
    # (N*B/8 bytes; the chunked scan unpacks per chunk on-device — ~2x
    # traffic but 8x less resident memory: 10M x 3,072-bit codes = 3.8 GB
    # instead of 30.7 GB), "auto" = pack only when the unpacked matrix would not fit
    # the device budget (index/service.py:_make_scan_state).
    scan_packed: str = "auto"
    # Stage-A scan backend when no accelerator serves the scan: "on" routes
    # through the native packed-word kernel (ops/native_scan — AVX XOR+
    # popcount over uint32 words + exact histogram top-L, bit-identical to
    # the device scan), "off" keeps XLA, "auto" uses the native kernel
    # whenever the scan state lives on a CPU device (the XLA:CPU fallback
    # streams the UNPACKED int8 matrix — 8x the bytes).
    scan_native: str = "auto"
    # Device scan-state row capacity (scan mode): when > n_rows the state
    # is padded to this many rows (padding tombstoned) so post-finalize
    # live inserts write into the padding with a fixed-shape
    # dynamic_update_slice instead of growing the array — no XLA
    # recompile per insert event (the mesh path's build(capacity=)
    # equivalent for single-chip serving).  0 = exact fit; growth past
    # capacity falls back to a reallocating append (one recompile,
    # capacity then grows geometrically).
    scan_capacity_rows: int = 0
    # Mesh scan-merge backend: "device" all_gathers per-shard top-Ls (a
    # collective XLA hands to NCCL on GPUs) and merges replicated on
    # device; "host" keeps them sharded and merges on the host with the
    # identical exact 2-key order — no collective in the query step (right
    # for emulated CPU meshes, whose in-process rendezvous hard-aborts
    # when one device lags ~40 s).
    mesh_merge: str = "device"
    block_size: int = 64              # greedy partition block size
    retry_probes: int = 10            # adaptive-retry probe count (QueryServiceImpl:335)
    # Where ingestion encoding + partition build run: "default" (the
    # session device) or "cpu" (numpy on the host: the built partition
    # table ships to the device once instead of every raw batch making a
    # round trip).  Corpus and queries are encoded on the same backend.
    encode_backend: str = "default"
    # Ciphertext payload dtype: "f32" (exact), "f16" (half the bytes —
    # exact for integer-valued corpora like SIFT, ~1e-3 relative elsewhere)
    # or "i8" (quarter the bytes — symmetric per-row int8 with an
    # in-ciphertext f32 scale, ~0.4% relative; the decrypt+refine stages
    # are DRAM-bandwidth bound, so payload bytes are ~linear in cost).
    storage_dtype: str = "f32"
    # Adaptive per-query decrypt budget (scan mode): when margin > 0 the
    # scan also returns n_dec[q] = |{i : score_i <= score_anchor + margin}|
    # clamped to [floor or anchor, L] and the host decrypts only that many
    # ranked ids — easy queries cost a few hundred AES opens, fringe
    # queries keep the full budget L.  Margin is in Hamming bits of the
    # full code (B = G*m*lambda); calibrate ~sqrt(B)*3 (150 at 2,304-bit
    # codes holds recall within noise of the full budget at ~3x fewer
    # opens).  Leakage unchanged: the server already sees every score.
    adaptive_decrypt_margin: int = 0   # 0 = off
    adaptive_decrypt_anchor: int = 100
    adaptive_decrypt_floor: int = 0    # 0 => anchor
    # Stage-C backend: "host" scores decrypted candidates on the host from
    # the fused decrypt-and-score outputs (no candidate upload); "device"
    # ships [Q,R,d] to the device and uses the jitted refine.
    refine_backend: str = "host"
    # Partition sort-key width: "off" = reference-exact 63-bit keys
    # (GreedyPartitioner.computeKey truncates codes past bit 62 — at
    # lambda*m > 63 the partition order is arbitrary within 63-bit ties);
    # "on"/"auto" add a secondary key with code bits 63..125 so the order
    # is the full code-prefix order up to 126 bits ("auto" activates it
    # exactly when lambda*m > 63, i.e. whenever it changes anything).
    # Round-5 diagnostic: the full order recovers the entire lambda=3
    # truncation loss on the glove family (diag_lambda3.jsonl).
    wide_keys: str = "off"

    def wide_keys_active(self, code_bits: int) -> bool:
        """Resolve the wide-key mode for a per-group code width."""
        if self.wide_keys == "on":
            return True
        return self.wide_keys == "auto" and code_bits > 63

    @property
    def hard_cap(self) -> int:
        """HARD_CAP = max(maxGlobalCandidates, refinementLimit) (ref index:479-482)."""
        return max(self.max_global_candidates, self.refinement_limit)

    def effective_probes(self) -> int:
        return self.probe_override if self.probe_override > 0 else self.default_probes

    def effective_refinement(self) -> int:
        """Candidates actually decrypted per query: the rerank truncation
        when enabled, else the full refinement limit."""
        if 0 < self.rerank_limit < self.refinement_limit:
            return self.rerank_limit
        return self.refinement_limit


@dataclass(frozen=True)
class EvalConfig:
    k_variants: tuple[int, ...] = (1, 10, 20, 40, 60, 80, 100)

    @property
    def max_k(self) -> int:
        return max(self.k_variants)


@dataclass(frozen=True)
class RatioConfig:
    source: str = "auto"     # gt | base | auto
    gt_sample: int = 100
    gt_mismatch_tolerance: float = 1e-3


@dataclass(frozen=True)
class ReencryptionConfig:
    enabled: bool = True
    mode: str = "end"            # end | immediate
    background_enabled: bool = False
    background_interval_s: float = 5.0
    background_batch: int = 2_000


@dataclass(frozen=True)
class CloakConfig:
    """Access-pattern decoys (reference SystemConfig CloakConfig +
    -Ddecoy.* flags, ForwardSecureANNSystem.java:172-183)."""

    enabled: bool = False
    rate: float = 0.3
    mode: str = "gaussian"     # gaussian | uniform | clustered
    seed: int = 1789


@dataclass(frozen=True)
class KAdaptiveConfig:
    """Probe-only adaptive widening — an ablation knob that multiplies the
    current probe count per invocation, capped at ``max_fanout``, WITHOUT
    executing a search (reference SystemConfig.KAdaptiveConfig:424-428 +
    runKAdaptiveProbeOnly, ForwardSecureANNSystem.java:1598-1617)."""

    enabled: bool = False
    probe_factor: float = 2.0
    max_fanout: int = 64


@dataclass(frozen=True)
class KeyConfig:
    ops_threshold: int = 1_000_000_000
    age_threshold_ms: int = 999_999_999_999
    retention_max: int = 5       # reference KeyManager.java:35


@dataclass(frozen=True)
class OutputConfig:
    results_dir: str = "results"
    export_artifacts: bool = True


@dataclass(frozen=True)
class SystemConfig:
    paper: PaperConfig = field(default_factory=PaperConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    ratio: RatioConfig = field(default_factory=RatioConfig)
    reencryption: ReencryptionConfig = field(default_factory=ReencryptionConfig)
    cloak: CloakConfig = field(default_factory=CloakConfig)
    kadaptive: KAdaptiveConfig = field(default_factory=KAdaptiveConfig)
    keys: KeyConfig = field(default_factory=KeyConfig)
    output: OutputConfig = field(default_factory=OutputConfig)
    profile_name: str = ""
    source_sha256: str = ""

    def validate(self) -> "SystemConfig":
        self.paper.validate()
        rt = self.runtime
        # Invariant from reference SystemConfig.java:121-127.
        if rt.max_global_candidates < self.eval.max_k:
            rt = dataclasses.replace(rt, max_global_candidates=self.eval.max_k)
        rt = dataclasses.replace(
            rt,
            refinement_limit=_clamp(rt.refinement_limit, self.eval.max_k, 10_000_000),
            block_size=_clamp(rt.block_size, 1, 1 << 16),
        )
        if rt.rerank_limit > 0:
            rt = dataclasses.replace(
                rt, rerank_limit=_clamp(rt.rerank_limit, self.eval.max_k,
                                        rt.refinement_limit))
        if rt.routing_mode not in ("probe", "scan"):
            raise ValueError(f"unknown routing_mode {rt.routing_mode!r}")
        if rt.scan_packed not in ("auto", "on", "off"):
            raise ValueError(f"scan_packed must be auto/on/off, "
                             f"got {rt.scan_packed!r}")
        if rt.scan_native not in ("auto", "on", "off"):
            raise ValueError(f"scan_native must be auto/on/off, "
                             f"got {rt.scan_native!r}")
        if rt.scan_capacity_rows < 0:
            raise ValueError("scan_capacity_rows must be >= 0")
        if rt.mesh_merge == "ici":   # deprecated name of "device"
            rt = dataclasses.replace(rt, mesh_merge="device")
        if rt.mesh_merge not in ("device", "host"):
            raise ValueError(f"mesh_merge must be device/host, "
                             f"got {rt.mesh_merge!r}")
        if rt.wide_keys not in ("auto", "on", "off"):
            raise ValueError(f"wide_keys must be auto/on/off, "
                             f"got {rt.wide_keys!r}")
        if rt.adaptive_decrypt_margin < 0:
            raise ValueError("adaptive_decrypt_margin must be >= 0")
        if rt.adaptive_decrypt_margin > 0:
            rt = dataclasses.replace(
                rt,
                adaptive_decrypt_anchor=_clamp(rt.adaptive_decrypt_anchor,
                                               self.eval.max_k, 1 << 20),
                adaptive_decrypt_floor=_clamp(rt.adaptive_decrypt_floor,
                                              0, 1 << 20))
        return dataclasses.replace(self, runtime=rt)


# ----------------------------------------------------------------------------
# JSON loading with profile overrides
# ----------------------------------------------------------------------------

_BLOCK_TYPES: dict[str, type] = {
    "paper": PaperConfig,
    "runtime": RuntimeConfig,
    "eval": EvalConfig,
    "ratio": RatioConfig,
    "reencryption": ReencryptionConfig,
    "cloak": CloakConfig,
    "kadaptive": KAdaptiveConfig,
    "keys": KeyConfig,
    "output": OutputConfig,
}

# accepted JSON key aliases -> dataclass field names
_FIELD_ALIASES = {
    "lambda": "lam",
    "refinementLimit": "refinement_limit",
    "maxGlobalCandidates": "max_global_candidates",
    "probeOverride": "probe_override",
    "hammingPrefilterThreshold": "hamming_prefilter_threshold",
    "blockSize": "block_size",
    "kVariants": "k_variants",
    "omegaDivisor": "omega_divisor",
    "opsThreshold": "ops_threshold",
    "ageThresholdMs": "age_threshold_ms",
    "retentionMax": "retention_max",
    "defaultProbes": "default_probes",
    "retryProbes": "retry_probes",
    "gtSample": "gt_sample",
    "gtMismatchTolerance": "gt_mismatch_tolerance",
    "resultsDir": "results_dir",
    "exportArtifacts": "export_artifacts",
    "backgroundEnabled": "background_enabled",
    "backgroundIntervalS": "background_interval_s",
    "backgroundBatch": "background_batch",
    "storageDtype": "storage_dtype",
    "encodeBackend": "encode_backend",
    "rerankLimit": "rerank_limit",
    "routingMode": "routing_mode",
    "scanFlatBudgetMb": "scan_flat_budget_mb",
    "scanPacked": "scan_packed",
    "scanNative": "scan_native",
    "wideKeys": "wide_keys",
    "adaptiveDecryptMargin": "adaptive_decrypt_margin",
    "adaptiveDecryptAnchor": "adaptive_decrypt_anchor",
    "adaptiveDecryptFloor": "adaptive_decrypt_floor",
    "probeFactor": "probe_factor",
    "maxFanout": "max_fanout",
}


def _coerce_block(cls: type, base: Any, data: dict[str, Any]) -> Any:
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        k = _FIELD_ALIASES.get(k, k)
        if k not in names:
            # tolerate foreign/vestigial keys (the reference configs carry
            # e.g. maxCandidateFactor, precisionMode — vestigial per SURVEY
            # §5) but surface them so typos aren't silent
            warnings.warn(f"ignoring unknown config field {k!r} "
                          f"for {cls.__name__}", stacklevel=2)
            continue
        if k == "k_variants":
            v = tuple(int(x) for x in v)
        kwargs[k] = v
    return dataclasses.replace(base, **kwargs)


def _profiles_table(data: dict[str, Any]) -> dict[str, dict]:
    """Profiles as {name: blocks}.  Accepts both our dict shape and the
    reference's list shape ``[{"name": ..., "overrides": {...}}, ...]``
    (reference SystemConfig.java:129-182)."""
    profiles = data.get("profiles", {})
    if isinstance(profiles, list):
        return {p["name"]: p.get("overrides", p) for p in profiles}
    return profiles


_TOP_LEVEL_KEYS = {
    # reference top-level scalars → our keys/reencryption blocks
    "opsThreshold": ("keys", "ops_threshold"),
    "ageThresholdMs": ("keys", "age_threshold_ms"),
    "reencryptionEnabled": ("reencryption", "enabled"),
}


def _apply_blocks(cfg: SystemConfig, data: dict[str, Any]) -> SystemConfig:
    if "kAdaptive" in data and "kadaptive" not in data:
        data = {**data, "kadaptive": data["kAdaptive"]}   # reference JSON key
    updates: dict[str, Any] = {}
    for block, cls in _BLOCK_TYPES.items():
        if block in data and data[block] is not None:
            updates[block] = _coerce_block(cls, getattr(cfg, block), data[block])
    cfg = dataclasses.replace(cfg, **updates)
    for key, (block, fieldname) in _TOP_LEVEL_KEYS.items():
        if key in data:
            blk = dataclasses.replace(getattr(cfg, block),
                                      **{fieldname: data[key]})
            cfg = dataclasses.replace(cfg, **{block: blk})
    return cfg


def load_config(path: str | os.PathLike | None = None,
                profile: str | None = None,
                overrides: dict[str, Any] | None = None) -> SystemConfig:
    """Load a SystemConfig from JSON with optional named profile + overrides.

    JSON shape::

        {"paper": {...}, "runtime": {...}, ...,
         "profiles": {"P4_FAST": {"paper": {...}, "runtime": {...}}, ...}}

    ``profile`` selects a named entry of ``profiles`` whose blocks are merged
    on top of the base config (reference SystemConfig.java:129-182).
    ``overrides`` is a final in-process layer of block dicts (the analogue of
    the reference's -D system-property surface).
    """
    cfg = SystemConfig()
    sha = ""
    if path is not None:
        raw = open(path, "rb").read()
        sha = hashlib.sha256(raw).hexdigest()
        data = json.loads(raw)
        cfg = _apply_blocks(cfg, data)
        if profile:
            profiles = _profiles_table(data)
            if profile not in profiles:
                raise KeyError(f"profile {profile!r} not found in {path}; "
                               f"available: {sorted(profiles)}")
            cfg = _apply_blocks(cfg, profiles[profile])
    elif profile:
        raise ValueError("profile requires a config path")
    if overrides:
        cfg = _apply_blocks(cfg, overrides)
    cfg = dataclasses.replace(cfg, profile_name=profile or "", source_sha256=sha)
    return cfg.validate()
