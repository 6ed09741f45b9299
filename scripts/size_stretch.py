#!/usr/bin/env python
"""Byte sizing of the multi-GPU stretch configuration (BASELINE.json
config 5: 100M × 768-d RAG corpus, distributed routing + cross-device merge).

Bytes only, from shapes: the scan state per card, the chunk scratch, the
collective payload and the host ciphertext.  No time is modelled — times
come from runs on the card (PERF.md).

Usage: python scripts/size_stretch.py [N] [D] [cards]
"""
import sys

N = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000_000
D = int(sys.argv[2]) if len(sys.argv) > 2 else 768
CARDS = int(sys.argv[3]) if len(sys.argv) > 3 else 4

# served config: tables=8, m=64 ⇒ 3,072-bit codes
G, M, LAM = 8 * 3, 64, 2
B = G * M * LAM                     # code bits/point
Q, L = 64, 2000                     # query batch, decrypt budget
CHUNK = 1 << 19                     # packed-scan chunk rows
MEM_PER_CARD = 80e9                 # H100 80GB
USABLE = 0.75                       # JAX's default preallocation fraction

rows = -(-N // CARDS)
bits_bytes = rows * B               # int8 unpacked: 1 byte/bit
words_bytes = rows * B // 8         # packed uint32 layout (scan_packed)
scratch = CHUNK * B + Q * CHUNK * 8  # per-chunk unpack + dots/rank scratch
flat_scratch = Q * rows * 12        # [Q, rows] dots + rank + ids (flat scan)
ct_bytes = N * (D * 4 + 46)         # record = payload + iv/tag/header
merge_mb = CARDS * Q * L * 8 / 1e6

budget = MEM_PER_CARD * USABLE
unp = "fits" if bits_bytes + flat_scratch <= budget else "OVER"
pk_total = words_bytes + scratch
pk = "fits" if pk_total <= budget else "OVER"
print(f"stretch config: N={N:,} D={D} cards={CARDS} "
      f"(code bits B={B}, L={L})")
print(f"  rows/card:            {rows:,}")
print(f"  unpacked bit matrix:  {bits_bytes/1e9:.2f} GB int8 + "
      f"{flat_scratch/1e9:.2f} GB flat-scan scratch per card — {unp} "
      f"({budget/1e9:.0f} GB usable of {MEM_PER_CARD/1e9:.0f} GB)")
print(f"  PACKED scan state:    {words_bytes/1e9:.2f} GB words + "
      f"{scratch/1e9:.2f} GB chunk scratch = {pk_total/1e9:.2f} GB — {pk} "
      f"(scan_packed=auto picks it when the unpacked matrix does not fit)")
print(f"  scan bytes read:      {bits_bytes/1e9:.2f} GB unpacked / "
      f"~{2 * words_bytes / 1e9 + bits_bytes / 1e9:.2f} GB packed "
      f"(words + unpack scratch write + read) per {Q}-query batch")
print(f"  merge payload:        {merge_mb:.1f} MB / batch (all_gather)")
ct_f16 = N * (D * 2 + 46)
ct_i8 = N * (D + 4 + 46)
print(f"  ciphertext (hosts):   {ct_bytes/1e9:.0f} GB sharded arenas f32 "
      f"/ {ct_f16/1e9:.0f} GB f16 / {ct_i8/1e9:.0f} GB i8 (storage_dtype)")
print(f"  AES bytes opened:     {L * (D * 2 + 46) / 1e3:.0f} kB/query f16 "
      f"at the full budget L")
