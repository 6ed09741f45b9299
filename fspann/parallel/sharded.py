"""Corpus-sharded index over a device mesh (SURVEY.md §7 step 7).

The reference is a single JVM; its only scale-out analogue is N independent
RocksDB shards (``common/ShardedMetadataManager.java``).  This scale-out
shards the *corpus* (rows of the ``[G, N]`` routing arrays) across
a ``jax.sharding.Mesh``:

* each device builds partitions over its own shard (sorts are local — no
  cross-chip sort needed because partition blocks never span shards),
* queries are replicated; each device routes + refines against its local
  shard and produces a local top-K,
* one ``all_gather`` over the mesh axis (NCCL over NVLink on GPUs) + a
  replicated merge yields the global top-K.  Collective payload is
  ``ndev * Q * K`` ids+distances — tiny next to the sharded device state.

This module implements the *plaintext/trusted-refine* serving mode (vectors
resident in device memory next to their routing shard).  The encrypted mode
keeps refine on the host exactly as in the single-chip path, with per-shard
ciphertext arenas (the host side is shard-agnostic: candidate ids are global).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import coding, hamming_scan, partition, routing
from ..ops.partition import PartitionTable


def make_mesh(n_devices: int | None = None, axis: str = "shard") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def resolve_scan_layout(mode, shard_rows: int, bits_per_row: int):
    """Map a scan-layout request to a concrete ``keep_bits`` value.

    ``mode``: False (no scan state), True/"off" (unpacked int8 bit matrix),
    "packed"/"on" (uint32 words, 8× less device memory, per-chunk unpack
    inside the scan: 25M rows × 6,144-bit codes are 19.2 GB packed and
    154 GB unpacked), or "auto" (pack only when the unpacked
    matrix would not fit ~60% of the device's free memory; 4 GiB fallback
    when the backend reports no stats).
    """
    if mode in (False, None):
        return False
    if mode in (True, "off"):
        return True
    if mode in ("packed", "on"):
        return "packed"
    if mode != "auto":
        raise ValueError(f"unknown scan layout {mode!r}")
    from ..utils.devmem import free_memory_budget
    budget = free_memory_budget(6, 10, fallback=4 << 30)
    return "packed" if shard_rows * bits_per_row > budget else True


def _assemble_dim1(arr) -> np.ndarray:
    """[Q, k*ndev] global array sharded on dim 1 → host numpy, shard by
    shard (plain D2H copies — no collective, no rendezvous)."""
    if isinstance(arr, np.ndarray):
        return arr
    shards = sorted(arr.addressable_shards,
                    key=lambda s: s.index[1].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards], axis=1)


def host_merge_topl(ids, sc, limit: int):
    """Exact host replica of the device scan merge: ascending 2-key
    (score, id) order over the union of per-shard top-Ls, first ``limit``
    kept, dead entries → id −1.  Packing both int32 keys into one int64
    (score<<32 | id, both non-negative) makes a single argpartition+sort
    reproduce ``lax.sort((sc, ids), num_keys=2)`` bit-exactly."""
    pad32 = np.iinfo(np.int32).max
    ids_np = _assemble_dim1(ids).astype(np.int64)
    sc_np = _assemble_dim1(sc).astype(np.int64)
    key = (sc_np << 32) | ids_np
    r = min(limit, key.shape[1])
    if r < key.shape[1]:
        head = np.take_along_axis(
            key, np.argpartition(key, r - 1, axis=1)[:, :r], axis=1)
    else:
        head = key
    head = np.sort(head, axis=1)
    sc_m = (head >> 32).astype(np.int32)
    ids_m = (head & 0xFFFFFFFF).astype(np.int32)
    return np.where(sc_m == pad32, -1, ids_m), sc_m


class ShardedIndex:
    """Plaintext corpus sharded over a mesh with per-shard partition tables."""

    def __init__(self, mesh: Mesh, bank: coding.GBank, block_size: int = 64,
                 wide_keys: bool = False):
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.bank = bank
        self.block_size = block_size
        # full code-prefix partition order past the 63-bit key
        # (ops/partition.build_partitions(wide=); runtime.wide_keys)
        self.wide_keys = wide_keys
        self.n_devices = mesh.devices.size
        self.table: PartitionTable | None = None
        self.base: jax.Array | None = None
        self.point_codes: jax.Array | None = None   # [N_pad, G, W] sharded
        self.bits: jax.Array | None = None          # [N_pad, B] int8 sharded
        self.words: jax.Array | None = None         # [N_pad, G, W] uint32
        #   sharded packed scan words (the 8x-smaller layout; mutually
        #   exclusive with `bits` — see resolve_scan_layout)
        self.popc: jax.Array | None = None          # [N_pad] int32 sharded
        self.tombs: jax.Array | None = None         # bool [N_pad] sharded
        self.shard_rows = 0
        self.n = 0
        self._steps: dict = {}   # jitted step cache per (probes, limit, k)
        # scan-merge backend: "device" = all_gather + replicated device
        # merge, "host" = per-shard top-Ls stay sharded and host_merge_topl
        # does the identical exact merge (right on emulated meshes —
        # XLA:CPU's in-process rendezvous hard-aborts at 40 s)
        self.merge_backend = "device"

    def _init_tombs(self) -> None:
        """Fresh all-false sharded tombstone mask (one bool per padded
        row).  Deletions are a runtime input to every query step, so a
        delete never recompiles or rebuilds anything."""
        nd, rows = self.n_devices, self.shard_rows
        shard = NamedSharding(self.mesh, P(self.axis))
        self.tombs = jax.device_put(np.zeros(rows * nd, bool), shard)

    def _set_tombstones(self, ids, value: bool) -> None:
        """Set/clear tombstone bits for global row ids: each shard's slice
        is updated ON its own device (committed ``.at[].set``), then the
        global mask is reassembled.  O(changes), no rebuild."""
        if self.tombs is None:
            raise RuntimeError("build before tombstone updates")
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if not len(ids):
            return
        if (ids < 0).any() or (ids >= self.n).any():
            raise ValueError("tombstone ids out of range")
        rows = self.shard_rows
        devs = list(self.mesh.devices.reshape(-1))
        parts = self._per_device(self.tombs)
        shard_of = ids // rows
        for s in np.unique(shard_of):
            s = int(s)
            local = jax.device_put(
                (ids[shard_of == s] - s * rows).astype(np.int32), devs[s])
            parts[s] = parts[s].at[local].set(value)
        shard = NamedSharding(self.mesh, P(self.axis))
        self.tombs = jax.make_array_from_single_device_arrays(
            (rows * self.n_devices,), shard, parts)

    def mark_deleted(self, ids) -> None:
        """Tombstone global row ids across the mesh — the sharded analogue
        of the single-chip ``PartitionedIndex.mark_deleted``."""
        self._set_tombstones(ids, True)

    def mark_undeleted(self, ids) -> None:
        """Clear tombstones (the mesh analogue of the single-chip
        undelete window — valid until the shard arenas compact/retire)."""
        self._set_tombstones(ids, False)

    # -- build ------------------------------------------------------------------

    def build(self, base: np.ndarray, keep_base: bool = True,
              keep_codes: bool = False, keep_bits: bool = False,
              capacity: int | None = None) -> None:
        """Pad to the mesh size, encode + build per-shard partitions.

        Sharding layout: every array's leading-N axis is split over the mesh
        axis; group/partition axes stay local, so the build sort and all
        query gathers are shard-local (no collectives until the final merge).

        ``keep_base=False`` drops the plaintext corpus from the device after the
        routing tables are built — the ENCRYPTED serving mode: the device
        holds only LSH routing state (codes/keys/partitions, no vector
        content), exactly like the single-chip index; refine happens on the
        hosts against the shard-aligned ciphertext stores.

        ``keep_codes=True`` additionally keeps each shard's per-point packed
        codes on device for the full-code rerank stage (G*W words/point).

        ``capacity`` reserves row headroom beyond ``len(base)``: the pad
        region (masked at query time) doubles as live-insert capacity for
        :meth:`append_scan_rows`.
        """
        n = len(base)
        nd = self.n_devices
        rows = -(-max(n, capacity or 0) // nd)
        pad = rows * nd - n
        if pad:
            # pad with copies of the last row; padded row ids are masked out
            base = np.concatenate([base, np.repeat(base[-1:], pad, 0)])
        self.n = n
        self.shard_rows = rows
        base = np.ascontiguousarray(base, np.float32)

        shard = NamedSharding(self.mesh, P(self.axis))
        base_dev = jax.device_put(base, shard)

        bank = self.bank
        block = self.block_size
        wide = self.wide_keys

        @partial(jax.shard_map, mesh=self.mesh,
                 in_specs=P(self.axis), out_specs=(P(self.axis), P(self.axis)))
        def build_local(vecs):
            codes, keys = coding.encode(vecs, bank)                  # local N
            table = partition.build_partitions(
                jnp.transpose(keys, (1, 0)),
                jnp.transpose(codes, (1, 0, 2)), block, wide=wide)
            # leading axis of each field must be the sharded one for
            # out_specs; stack under a fresh leading axis per shard
            return jax.tree.map(lambda x: x[None], table), codes

        self.table, codes_dev = build_local(base_dev)  # [ndev, G, P, ...]
        jax.block_until_ready(self.table)
        self._init_tombs()
        self.point_codes = codes_dev if keep_codes else None
        self.base = base_dev if keep_base else None
        self._set_scan_arrays(codes_dev, keep_bits)

    def build_stream(self, chunks, n_total: int, keep_codes: bool = False,
                     keep_bits: bool = False,
                     capacity: int | None = None) -> int:
        """Streaming build: consume an iterator of [b, d] f32 chunks and
        NEVER materialize the corpus (reference ingestion is a streaming
        loop, ForwardSecureANNSystem.java:438-479; the one-shot ``build``
        pads + device_puts the whole corpus — impossible at the 100M×768
        stretch where the plaintext alone is ~300 GB).

        Each chunk is sliced at shard-row boundaries and shipped to its
        OWN device, where it is encoded in place (device-consistent with
        query-time encoding — bit-identical codes) and the raw slice is
        dropped; host peak memory is one chunk, device peak is the shard's
        codes.  The per-device code arrays are then assembled into global
        mesh-sharded arrays (``jax.make_array_from_single_device_arrays``)
        and the per-shard partition build runs under ``shard_map`` exactly
        like the one-shot path.
        """
        nd = self.n_devices
        rows = -(-max(n_total, capacity or 0) // nd)
        self.n = n_total
        self.shard_rows = rows
        devs = list(self.mesh.devices.reshape(-1))
        bank = self.bank
        g, w = bank.g, bank.code_words
        banks = [jax.device_put(bank, dv) for dv in devs]

        parts_codes: list[list] = [[] for _ in range(nd)]
        parts_keys: list[list] = [[] for _ in range(nd)]
        pos = 0
        for c in chunks:
            c = np.ascontiguousarray(c, np.float32)
            o = 0
            while o < len(c):
                s = (pos + o) // rows
                if s >= nd:
                    raise ValueError(
                        f"stream longer than n_total={n_total}")
                take = min(len(c) - o, (s + 1) * rows - (pos + o))
                dev_chunk = jax.device_put(c[o:o + take], devs[s])
                codes_s, keys_s = coding.encode(dev_chunk, banks[s])
                parts_codes[s].append(codes_s)
                parts_keys[s].append(keys_s)
                o += take
            pos += len(c)
        if pos != n_total:
            raise ValueError(f"stream provided {pos} rows, "
                             f"expected n_total={n_total}")

        per_dev_codes, per_dev_keys = [], []
        for s in range(nd):
            have = sum(int(p.shape[0]) for p in parts_codes[s])
            cps, kps = parts_codes[s], parts_keys[s]
            if have < rows:
                # zero-pad the tail shard; pad rows are tombstoned at query
                # time by the local_valid mask (rows >= n)
                cps = cps + [jax.device_put(
                    np.zeros((rows - have, g, w), np.uint32), devs[s])]
                kps = kps + [jax.device_put(
                    np.zeros((rows - have, g), np.int64), devs[s])]
            per_dev_codes.append(jnp.concatenate(cps) if len(cps) > 1
                                 else cps[0])
            per_dev_keys.append(jnp.concatenate(kps) if len(kps) > 1
                                else kps[0])
            parts_codes[s] = parts_keys[s] = None   # free chunk parts

        shard = NamedSharding(self.mesh, P(self.axis))
        codes_global = jax.make_array_from_single_device_arrays(
            (rows * nd, g, w), shard, per_dev_codes)
        keys_global = jax.make_array_from_single_device_arrays(
            (rows * nd, g), shard, per_dev_keys)
        block = self.block_size
        wide = self.wide_keys

        @partial(jax.shard_map, mesh=self.mesh,
                 in_specs=(P(self.axis), P(self.axis)),
                 out_specs=P(self.axis))
        def build_local(keys_l, codes_l):
            table = partition.build_partitions(
                jnp.transpose(keys_l, (1, 0)),
                jnp.transpose(codes_l, (1, 0, 2)), block, wide=wide)
            return jax.tree.map(lambda x: x[None], table)

        self.table = build_local(keys_global, codes_global)
        jax.block_until_ready(self.table)
        self._init_tombs()
        self.base = None
        self.point_codes = codes_global if keep_codes else None
        self._set_scan_arrays(codes_global, keep_bits)
        return pos

    def _set_scan_arrays(self, codes_global, keep_bits) -> None:
        """Materialize the scan state from the sharded packed codes in the
        requested layout: True = per-shard unpacked int8 bit matrix,
        "packed" = keep the uint32 words (popcounts via one
        ``lax.population_count`` pass — pad bits are zero by the packers'
        contract, ops/coding.py pack_codes), False = none."""
        self.bits = self.words = self.popc = None
        if not keep_bits:
            return
        if keep_bits == "packed":
            @partial(jax.shard_map, mesh=self.mesh,
                     in_specs=P(self.axis), out_specs=P(self.axis))
            def popc_local(codes):
                return jnp.sum(
                    jax.lax.population_count(codes).astype(jnp.int32),
                    axis=(-2, -1))

            self.words = codes_global
            self.popc = popc_local(codes_global)
            jax.block_until_ready(self.popc)
            return
        cb = self.bank.code_bits

        @partial(jax.shard_map, mesh=self.mesh,
                 in_specs=P(self.axis),
                 out_specs=(P(self.axis), P(self.axis)))
        def unpack_local(codes):
            bits = hamming_scan.unpack_bits_device(codes, cb)
            return bits, jnp.sum(bits.astype(jnp.int32), axis=-1)

        self.bits, self.popc = unpack_local(codes_global)
        jax.block_until_ready(self.bits)

    # -- checkpoint / restore ----------------------------------------------------

    def save_state(self, path: str) -> None:
        """Persist the mesh routing state: per-point packed codes + bank
        stats + geometry.  The mesh analogue of the single-chip table
        checkpoint (index/service.save_table): codes are the generator of
        every routing structure (tables/bits rebuild deterministically), so
        the checkpoint is N·G·W words instead of all derived state."""
        import os

        codes = self.point_codes if self.point_codes is not None \
            else self.words
        if codes is None and self.bits is None:
            raise RuntimeError("nothing to save: build with keep_codes or "
                               "keep_bits first")
        if codes is not None:
            codes_np = self._gather_host(codes)
        else:
            # scan-only build: re-pack from bits is lossy-free but wide;
            # instead re-encode is wrong (needs base) — so repack bits
            bits = self._gather_host(self.bits)             # [N_pad, B]
            g, cb = self.bank.g, self.bank.code_bits
            w = self.bank.code_words
            by = np.packbits(
                np.pad(bits.reshape(len(bits), g, cb),
                       ((0, 0), (0, 0), (0, w * 32 - cb))), axis=-1)
            codes_np = by.view(">u4").astype(np.uint32).reshape(
                len(bits), g, w)
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(tmp, codes=codes_np, n=self.n, shard_rows=self.shard_rows,
                 ndev=self.n_devices, block=self.block_size,
                 wide=self.wide_keys,
                 omega=np.asarray(self.bank.omega), r=np.asarray(self.bank.r),
                 m=self.bank.m, lam=self.bank.lam, tables=self.bank.tables,
                 divisions=self.bank.divisions, seed=self.bank.seed,
                 dim=self.bank.d)
        os.replace(tmp + ".npz", path)

    @classmethod
    def restore_state(cls, path: str, mesh: Mesh,
                      keep_codes: bool = False, keep_bits: bool = True
                      ) -> "ShardedIndex":
        """Rebuild a ShardedIndex from :meth:`save_state` — per-shard code
        slices ship straight to their devices (no re-encode, no plaintext)
        and tables/bits rebuild under shard_map.  Fails if the mesh size
        disagrees with the checkpoint's shard geometry."""
        z = np.load(path)
        nd = int(z["ndev"])
        if mesh.devices.size != nd:
            raise ValueError(f"checkpoint is for {nd} devices, mesh has "
                             f"{mesh.devices.size}")
        bank = coding.bank_from_stats(
            z["omega"], z["r"], int(z["dim"]), int(z["m"]), int(z["lam"]),
            int(z["tables"]), int(z["divisions"]), int(z["seed"]))
        idx = cls(mesh, bank, block_size=int(z["block"]),
                  wide_keys=bool(z["wide"]) if "wide" in z.files else False)
        idx.n = int(z["n"])
        rows = int(z["shard_rows"])
        idx.shard_rows = rows
        codes_np = z["codes"].astype(np.uint32)
        devs = list(mesh.devices.reshape(-1))
        per_dev = [jax.device_put(codes_np[s * rows:(s + 1) * rows], devs[s])
                   for s in range(nd)]
        shard = NamedSharding(mesh, P(mesh.axis_names[0]))
        g, w = bank.g, bank.code_words
        codes_global = jax.make_array_from_single_device_arrays(
            (rows * nd, g, w), shard, per_dev)

        axis = idx.axis
        block = idx.block_size
        wide = idx.wide_keys

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=P(axis), out_specs=P(axis))
        def build_local(codes_l):
            keys_l = coding.keys_from_codes(codes_l)
            table = partition.build_partitions(
                jnp.transpose(keys_l, (1, 0)),
                jnp.transpose(codes_l, (1, 0, 2)), block, wide=wide)
            return jax.tree.map(lambda x: x[None], table)

        idx.table = build_local(codes_global)
        jax.block_until_ready(idx.table)
        idx._init_tombs()
        idx.point_codes = codes_global if keep_codes else None
        idx._set_scan_arrays(codes_global, keep_bits)
        return idx

    # -- live insert (scan mode) -------------------------------------------------

    def _per_device(self, arr) -> list:
        """The global sharded array as per-device single-device arrays,
        ordered by shard row range."""
        shards = sorted(arr.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        return [s.data for s in shards]

    def _gather_host(self, arr) -> np.ndarray:
        """Sharded global array → host, shard by shard.  A plain
        ``np.asarray`` on a fully-sharded array lowers to an XLA
        all-gather — a COLLECTIVE inside a checkpoint path, which the
        CPU in-process communicator hard-aborts after 40 s when one
        emulated device lags (observed at 10M rows on a 1-core host).
        Per-shard D2H copies carry no rendezvous and the same bytes."""
        return np.concatenate([np.asarray(x) for x in self._per_device(arr)])

    def append_scan_rows(self, vecs: np.ndarray) -> np.ndarray:
        """Live insert on the mesh (scan mode) — the mesh analogue of the
        single-chip ``PartitionedIndex.append_rows`` (index/service.py):
        encode the new rows ON their owning shard device, splice them into
        that shard's bit matrix (``dynamic_update_slice``), reassemble the
        global sharded arrays, and bump ``n`` — the scan step reads the
        live row count as a traced scalar, so appended rows are searchable
        immediately with NO recompile.

        Capacity is the pad region reserved by ``build(capacity=...)`` /
        ``build_stream(capacity=...)``; appending past it raises.  Returns
        the assigned global row ids (the next ordinals — range placement
        demands contiguity)."""
        packed = self.words is not None
        if self.bits is None and not packed:
            raise RuntimeError("mesh live insert requires "
                               "build(keep_bits=True) (routing_mode='scan')")
        vecs = np.ascontiguousarray(vecs, np.float32)
        b = len(vecs)
        nd, rows = self.n_devices, self.shard_rows
        if self.n + b > rows * nd:
            raise RuntimeError(
                f"mesh capacity exhausted ({rows * nd} rows, {self.n} "
                "live) — rebuild with capacity headroom")
        devs = list(self.mesh.devices.reshape(-1))
        cb = self.bank.code_bits
        mat_parts = self._per_device(self.words if packed else self.bits)
        popc_parts = self._per_device(self.popc)
        pos, o = self.n, 0
        while o < b:
            s = (pos + o) // rows
            off = (pos + o) - s * rows
            take = min(b - o, rows - off)
            dv = devs[s]
            chunk = jax.device_put(vecs[o:o + take], dv)
            bank_s = jax.device_put(self.bank, dv)
            codes_s, _ = coding.encode(chunk, bank_s)
            if packed:
                new_rows = codes_s
                new_popc = jnp.sum(
                    jax.lax.population_count(codes_s).astype(jnp.int32),
                    axis=(-2, -1))
                mat_parts[s] = jax.lax.dynamic_update_slice(
                    mat_parts[s], new_rows, (off, 0, 0))
            else:
                new_rows = hamming_scan.unpack_bits_device(codes_s, cb)
                new_popc = jnp.sum(new_rows.astype(jnp.int32), axis=-1)
                mat_parts[s] = jax.lax.dynamic_update_slice(
                    mat_parts[s], new_rows, (off, 0))
            popc_parts[s] = jax.lax.dynamic_update_slice(
                popc_parts[s], new_popc, (off,))
            o += take
        shard = NamedSharding(self.mesh, P(self.axis))
        if packed:
            g, w = self.bank.g, self.bank.code_words
            self.words = jax.make_array_from_single_device_arrays(
                (rows * nd, g, w), shard, mat_parts)
        else:
            bdim = self.bits.shape[1]
            self.bits = jax.make_array_from_single_device_arrays(
                (rows * nd, bdim), shard, mat_parts)
        self.popc = jax.make_array_from_single_device_arrays(
            (rows * nd,), shard, popc_parts)
        # kept packed codes (rerank path) don't cover the appended rows —
        # drop them so save_state repacks from the (current) bit matrix
        # instead of checkpointing a stale code array
        self.point_codes = None
        ids = np.arange(self.n, self.n + b, dtype=np.int64)
        self.n += b
        return ids

    # -- query ------------------------------------------------------------------

    def query_step_fn(self, probes: int, refinement_limit: int, k: int,
                      probe_shards: int | None = None):
        """Return the jittable sharded query step (route → local refine →
        cross-chip top-k merge).  Suitable for jit over the mesh.

        ``probe_shards`` restricts results to the first N shards (reference
        ``-Dprobe.shards``, ForwardSecureANNSystem.java:1598-1617).  Under
        SPMD every device still executes — the subset semantics are applied
        by masking the unprobed shards' contributions out of the merge."""
        bank = self.bank
        axis = self.axis
        rows = self.shard_rows
        n = self.n
        shard_cap = self.n_devices if probe_shards is None \
            else max(1, min(probe_shards, self.n_devices))

        @partial(jax.shard_map, mesh=self.mesh,
                 in_specs=(jax.tree.map(lambda _: P(axis), self.table),
                           P(axis), P(axis), P(None)),
                 out_specs=(P(None), P(None)),
                 check_vma=False)
        def step(table_stacked, base_local, tombs_local, queries):
            table = jax.tree.map(lambda x: x[0], table_stacked)
            qcodes, qkeys = coding.encode(queries, bank)
            local_valid = jnp.arange(rows) + jax.lax.axis_index(axis) * rows < n
            local_valid &= jax.lax.axis_index(axis) < shard_cap
            tomb = ~local_valid | tombs_local
            routed = routing.route(table, qcodes, qkeys, tomb, probes,
                                   refinement_limit)
            cand = routed.ids                                    # local rows
            safe = jnp.maximum(cand, 0)
            cand_vecs = base_local[safe]                         # [Q, R, d]
            diff = cand_vecs - queries[:, None, :]
            d2 = jnp.sum(diff * diff, axis=-1)
            d2 = jnp.where(cand >= 0, d2, jnp.float32(3.4e38))
            kk = min(k, cand.shape[-1])
            neg, idx = jax.lax.top_k(-d2, kk)
            local_ids = jnp.take_along_axis(cand, idx, axis=-1)
            global_ids = jnp.where(
                local_ids >= 0,
                local_ids + jax.lax.axis_index(axis) * rows, -1)
            # ---- cross-device merge (all_gather of tiny top-K blocks) ----
            all_ids = jax.lax.all_gather(global_ids, axis, axis=1,
                                         tiled=True)             # [Q, ndev*K]
            all_d2 = jax.lax.all_gather(-neg, axis, axis=1, tiled=True)
            mneg, midx = jax.lax.top_k(-all_d2, k)
            out_ids = jnp.take_along_axis(all_ids, midx, axis=-1)
            dist = jnp.sqrt(jnp.maximum(-mneg, 0.0))
            dist = jnp.where(out_ids >= 0, dist, jnp.float32(jnp.inf))
            return out_ids, dist

        return step

    def route_step_fn(self, probes: int, refinement_limit: int,
                      probe_shards: int | None = None,
                      rerank_limit: int = 0):
        """Route-ONLY sharded step for encrypted serving: per-shard
        multi-probe routing, global-id conversion, all_gather of the
        per-shard ranked (id, score) blocks, replicated merge by Hamming
        score.  No vector content touches the device — the candidate ids
        go back to the hosts for decrypt+refine against the shard-aligned
        ciphertext arenas.

        ``rerank_limit > 0`` (needs build(keep_codes=True)) re-scores each
        shard's routed set by exact full-code Hamming (ops/routing.rerank)
        and truncates LOCALLY before the collective — the global top-L by
        fine score is contained in the union of per-shard top-Ls, so the
        merge is exact while the collective payload shrinks from refinement_limit
        to rerank_limit per shard."""
        bank = self.bank
        axis = self.axis
        rows = self.shard_rows
        n = self.n
        limit = refinement_limit
        shard_cap = self.n_devices if probe_shards is None \
            else max(1, min(probe_shards, self.n_devices))
        pad32 = jnp.iinfo(jnp.int32).max
        use_rerank = rerank_limit > 0
        if use_rerank and self.point_codes is None:
            raise RuntimeError("rerank requires build(keep_codes=True)")
        codes_spec = (P(axis),) if use_rerank else ()

        @partial(jax.shard_map, mesh=self.mesh,
                 in_specs=(jax.tree.map(lambda _: P(axis), self.table),
                           P(axis), P(None)) + codes_spec,
                 out_specs=(P(None), P(None)),
                 check_vma=False)
        def step(table_stacked, tombs_local, queries, *maybe_codes):
            table = jax.tree.map(lambda x: x[0], table_stacked)
            qcodes, qkeys = coding.encode(queries, bank)
            local_valid = jnp.arange(rows) + jax.lax.axis_index(axis) * rows < n
            local_valid &= jax.lax.axis_index(axis) < shard_cap
            dead_rows = ~local_valid | tombs_local
            if use_rerank:
                routed = routing.route_rerank(table, qcodes, qkeys,
                                              dead_rows, maybe_codes[0],
                                              probes, rerank_limit)
            else:
                routed = routing.route(table, qcodes, qkeys, dead_rows,
                                       probes, limit)
            live = routed.ids >= 0
            gids = jnp.where(live,
                             routed.ids + jax.lax.axis_index(axis) * rows,
                             pad32)
            scores = jnp.where(live, routed.scores, pad32)
            all_ids = jax.lax.all_gather(gids, axis, axis=1, tiled=True)
            all_sc = jax.lax.all_gather(scores, axis, axis=1, tiled=True)
            sc, ids = jax.lax.sort((all_sc, all_ids), dimension=-1,
                                   num_keys=2)
            r = min(rerank_limit if use_rerank else limit, ids.shape[-1])
            ids = jnp.where(ids[:, :r] == pad32, -1, ids[:, :r])
            return ids, sc[:, :r]

        return step

    def scan_route_step_fn(self, limit: int, probe_shards: int | None = None,
                           approx: bool = False, merge: str = "device"):
        """Hamming scan over the mesh: per-shard int8 bit-matmul + local
        top-L, then all_gather + exact merge by fine score (global top-L
        ⊆ union of per-shard top-Ls).  The collective payload is L ids+
        scores per shard — no vector content, no codes cross the wire.

        ``merge="host"`` skips the collective entirely: per-shard top-Ls
        come back SHARDED (out dim 1) and :func:`host_merge_topl` does the
        same exact 2-key merge on the host — bit-identical results.  Right
        when the mesh is emulated (XLA:CPU's in-process communicator
        hard-aborts rendezvous after 40 s when one emulated device lags)."""
        bank = self.bank
        axis = self.axis
        rows = self.shard_rows
        shard_cap = self.n_devices if probe_shards is None \
            else max(1, min(probe_shards, self.n_devices))
        pad32 = jnp.iinfo(jnp.int32).max
        dead = jnp.int32(1 << 30)   # survives the f32 round trip exactly
        cb = bank.code_bits

        def local_topl(bits_local, popc_local, tombs_local, queries, n_live):
            qcodes, _ = coding.encode(queries, bank)
            qbits = hamming_scan.unpack_bits_device(qcodes, cb)
            dots = jax.lax.dot_general(
                qbits, bits_local,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32)            # [Q, rows]
            qpopc = jnp.sum(qbits.astype(jnp.int32), axis=1)
            part = popc_local[None, :] - 2 * dots
            local_valid = (jnp.arange(rows)
                           + jax.lax.axis_index(axis) * rows < n_live)
            local_valid &= jax.lax.axis_index(axis) < shard_cap
            local_valid &= ~tombs_local
            part = jnp.where(local_valid[None, :], part, dead)
            k = min(limit, rows)
            if approx:
                neg, idx = jax.lax.approx_max_k(
                    -part.astype(jnp.float32), k, recall_target=0.98)
                fine = (-neg).astype(jnp.int32)
            else:
                neg, idx = jax.lax.top_k(-part, k)
                fine = -neg
            live = fine < dead
            gids = jnp.where(live,
                             idx.astype(jnp.int32)
                             + jax.lax.axis_index(axis) * rows, pad32)
            sc = jnp.where(live, fine + qpopc[:, None], pad32)
            return gids, sc

        # n_live is a TRACED scalar (not a closure constant) so live
        # inserts extend the served row count without recompiling the step
        if merge == "host":
            @partial(jax.shard_map, mesh=self.mesh,
                     in_specs=(P(axis), P(axis), P(axis), P(None), P()),
                     out_specs=(P(None, axis), P(None, axis)),
                     check_vma=False)
            def step(bits_local, popc_local, tombs_local, queries, n_live):
                return local_topl(bits_local, popc_local, tombs_local,
                                  queries, n_live)

            return step

        @partial(jax.shard_map, mesh=self.mesh,
                 in_specs=(P(axis), P(axis), P(axis), P(None), P()),
                 out_specs=(P(None), P(None)),
                 check_vma=False)
        def step(bits_local, popc_local, tombs_local, queries, n_live):
            gids, sc = local_topl(bits_local, popc_local, tombs_local,
                                  queries, n_live)
            all_ids = jax.lax.all_gather(gids, axis, axis=1, tiled=True)
            all_sc = jax.lax.all_gather(sc, axis, axis=1, tiled=True)
            msc, mids = jax.lax.sort((all_sc, all_ids), dimension=-1,
                                     num_keys=2)
            r = min(limit, mids.shape[-1])
            ids = jnp.where(mids[:, :r] == pad32, -1, mids[:, :r])
            return ids, msc[:, :r]

        return step

    def scan_route_step_fn_packed(self, limit: int,
                                  probe_shards: int | None = None,
                                  approx: bool = False, chunk: int = 1 << 19,
                                  merge: str = "device"):
        """Packed-layout mesh scan: each shard runs a chunked running-top-L
        loop — slice ``chunk`` packed rows, unpack on-device,
        bit-matmul, 2-key merge — so only [chunk, B] of unpacked scratch
        ever exists per device (the resident state is the 8×-smaller word
        matrix).  Merge + collective identical to the unpacked step;
        ``merge="host"`` returns per-shard top-Ls sharded for
        :func:`host_merge_topl` (no collective — see scan_route_step_fn)."""
        bank = self.bank
        axis = self.axis
        rows = self.shard_rows
        shard_cap = self.n_devices if probe_shards is None \
            else max(1, min(probe_shards, self.n_devices))
        pad32 = jnp.iinfo(jnp.int32).max
        dead = jnp.int32(1 << 30)
        cb = bank.code_bits
        g, w = bank.g, bank.code_words
        chunk = min(chunk, rows)
        nc = -(-rows // chunk)

        def local_topl(words_local, popc_local, tombs_local, queries,
                       n_live):
            qcodes, _ = coding.encode(queries, bank)
            qbits = hamming_scan.unpack_bits_device(qcodes, cb)
            qpopc = jnp.sum(qbits.astype(jnp.int32), axis=1)
            q = qbits.shape[0]
            base_gid = jax.lax.axis_index(axis) * rows
            local_valid = (jnp.arange(rows) + base_gid < n_live)
            local_valid &= jax.lax.axis_index(axis) < shard_cap
            deadmask = ~local_valid | tombs_local              # [rows]
            k = min(limit, chunk)

            def body(i, carry):
                # x64 is enabled package-wide: the fori_loop index arrives
                # int64 here — pin the row arithmetic to int32 so the merge
                # carry dtypes stay fixed
                start = (i * chunk).astype(jnp.int32)
                start_c = jnp.minimum(start, jnp.int32(rows - chunk))
                zero = jnp.int32(0)
                words_c = jax.lax.dynamic_slice(
                    words_local, (start_c, zero, zero), (chunk, g, w))
                bits_c = hamming_scan.unpack_bits_device(words_c, cb)
                popc_c = jax.lax.dynamic_slice(popc_local, (start_c,),
                                               (chunk,))
                dead_c = jax.lax.dynamic_slice(deadmask, (start_c,),
                                               (chunk,))
                # scoring/masking/top-k/merge shared with the single-chip
                # scan_chunked — the packed==unpacked and mesh==single-chip
                # equalities need the chunk body to stay bit-identical
                return hamming_scan.scan_chunk_merge(
                    qbits, bits_c, popc_c, dead_c, start, start_c,
                    carry, approx)

            init = (jnp.full((q, k), dead, jnp.int32),
                    jnp.full((q, k), -1, jnp.int32))
            best_sc, best_id = jax.lax.fori_loop(0, nc, body, init)
            live = best_sc < dead
            gids = jnp.where(live, best_id + base_gid, pad32)
            sc = jnp.where(live, best_sc + qpopc[:, None], pad32)
            return gids, sc

        if merge == "host":
            @partial(jax.shard_map, mesh=self.mesh,
                     in_specs=(P(axis), P(axis), P(axis), P(None), P()),
                     out_specs=(P(None, axis), P(None, axis)),
                     check_vma=False)
            def step(words_local, popc_local, tombs_local, queries, n_live):
                return local_topl(words_local, popc_local, tombs_local,
                                  queries, n_live)

            return step

        @partial(jax.shard_map, mesh=self.mesh,
                 in_specs=(P(axis), P(axis), P(axis), P(None), P()),
                 out_specs=(P(None), P(None)),
                 check_vma=False)
        def step(words_local, popc_local, tombs_local, queries, n_live):
            gids, sc = local_topl(words_local, popc_local, tombs_local,
                                  queries, n_live)
            all_ids = jax.lax.all_gather(gids, axis, axis=1, tiled=True)
            all_sc = jax.lax.all_gather(sc, axis, axis=1, tiled=True)
            msc, mids = jax.lax.sort((all_sc, all_ids), dimension=-1,
                                     num_keys=2)
            r = min(limit, mids.shape[-1])
            ids = jnp.where(mids[:, :r] == pad32, -1, mids[:, :r])
            return ids, msc[:, :r]

        return step

    @staticmethod
    def _start_host_copy(*arrays) -> None:
        """Begin async D2H transfers so a later ``np.asarray`` finds the
        host literal already resident — lets a pipelined caller overlap
        the transfer with the previous batch's host AES work."""
        for a in arrays:
            if hasattr(a, "copy_to_host_async"):
                try:
                    a.copy_to_host_async()
                except Exception:
                    return

    def scan_route_dispatch(self, queries: np.ndarray, limit: int = 2048,
                            probe_shards: int | None = None,
                            approx: bool = False):
        """Non-blocking stage-A dispatch (device arrays, D2H started).
        With ``merge_backend="host"`` the merge happens here and the
        return is host numpy (the call blocks on the shard top-Ls)."""
        packed = self.words is not None
        if self.bits is None and not packed:
            raise RuntimeError("scan requires build(keep_bits=True)")
        key = ("scanp" if packed else "scan", limit, probe_shards, approx,
               self.merge_backend)
        step = self._steps.get(key)
        if step is None:
            mk = self.scan_route_step_fn_packed if packed \
                else self.scan_route_step_fn
            step = jax.jit(mk(limit, probe_shards, approx,
                              merge=self.merge_backend))
            self._steps[key] = step
        ids, sc = step(self.words if packed else self.bits, self.popc,
                       self.tombs, jnp.asarray(queries, jnp.float32),
                       jnp.int32(self.n))
        if self.merge_backend == "host":
            return host_merge_topl(ids, sc, limit)
        self._start_host_copy(ids, sc)
        return ids, sc

    def scan_route(self, queries: np.ndarray, limit: int = 2048,
                   probe_shards: int | None = None, approx: bool = False):
        """Stage A via the mesh Hamming scan (needs build(keep_bits=True)
        or the packed layout, keep_bits="packed")."""
        ids, sc = self.scan_route_dispatch(queries, limit, probe_shards,
                                           approx)
        return np.asarray(ids), np.asarray(sc)

    def route_dispatch(self, queries: np.ndarray, probes: int = 5,
                       refinement_limit: int = 2048,
                       probe_shards: int | None = None,
                       rerank_limit: int = 0):
        """Non-blocking probe-route dispatch (device arrays, D2H started)."""
        key = ("route", probes, refinement_limit, probe_shards, rerank_limit)
        step = self._steps.get(key)
        if step is None:
            step = jax.jit(self.route_step_fn(probes, refinement_limit,
                                              probe_shards, rerank_limit))
            self._steps[key] = step
        args = (self.table, self.tombs,
                jnp.asarray(queries, jnp.float32))
        if rerank_limit > 0:
            args += (self.point_codes,)
        ids, sc = step(*args)
        self._start_host_copy(ids, sc)
        return ids, sc

    def route(self, queries: np.ndarray, probes: int = 5,
              refinement_limit: int = 2048,
              probe_shards: int | None = None,
              rerank_limit: int = 0):
        """Candidate generation across the mesh (encrypted serving stage A):
        ranked global candidate ids [Q, R] (-1 pad) + Hamming scores."""
        ids, sc = self.route_dispatch(queries, probes, refinement_limit,
                                      probe_shards, rerank_limit)
        return np.asarray(ids), np.asarray(sc)

    def query(self, queries: np.ndarray, probes: int = 5,
              refinement_limit: int = 2048, k: int = 10,
              probe_shards: int | None = None):
        if self.base is None:
            raise RuntimeError(
                "plaintext refine unavailable: index built with "
                "keep_base=False (encrypted mode) — use route() + host "
                "decrypt/refine")
        key = (probes, refinement_limit, k, probe_shards)
        step = self._steps.get(key)
        if step is None:
            step = jax.jit(self.query_step_fn(probes, refinement_limit, k,
                                              probe_shards))
            self._steps[key] = step
        ids, dist = step(self.table, self.base, self.tombs,
                         jnp.asarray(queries, jnp.float32))
        return np.asarray(ids), np.asarray(dist)
