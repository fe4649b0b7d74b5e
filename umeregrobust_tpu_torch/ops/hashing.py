"""Static-shape open-addressing hash table for integer voxel coordinates
(port of umeregrobust_tpu/ops/hashing.py; the same slots, fingerprints
and lookups, bit for bit).

- build: iterative scatter-min linear probing. Each unplaced key proposes
  its next probe slot; a scatter-min elects the lowest row per slot;
  losers advance their probe offset. At load <= 0.25 this converges in a
  couple of rounds.
- lookup: probe rounds compare a 32-bit key fingerprint (a second
  independent hash stored per slot) instead of the 4-wide coordinates;
  the winning hit is verified once against the full coordinates, so a
  fingerprint false positive becomes a miss, not a wrong row.
- early exit: an empty slot on the probe path proves absence (linear
  probing invariant). Extra rounds after every key is placed or every
  query resolved change nothing, so the loops read their stop condition
  on the host only every CHECK_EVERY rounds: the same result with fewer
  synchronizations on the card.

Keys are (b, x, y, z) int32 rows. Invalid rows (mask False) are never
inserted and always miss. MurmurHash3 runs on int64 holding uint32
values (torch's uint32 lacks the arithmetic): every product is split in
16-bit halves so that no int64 product overflows, and every result is
masked to 32 bits. Fingerprints are stored as int32 with the uint32's
bits. A table is built on the card unless the caller passes
device="cpu" (without CUDA the default raises, as devices.resolve_device
does); lookups run where the table is.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from umeregrobust_tpu_torch.devices import resolve_device, to_device

__all__ = ["HashTable", "build_hash_table", "lookup"]

_M32 = 0xFFFFFFFF
CHECK_EVERY = 4  # rounds between host reads of the loops' stop condition
ROUNDS = {"build": 0, "lookup": 0}  # rounds the last build / lookup ran


class HashTable(NamedTuple):
    slots: torch.Tensor  # (S,) int32: index into coords, or -1 if empty
    fps: torch.Tensor  # (S,) int32: the stored key's fingerprint (uint32 bits)
    coords: torch.Tensor  # (N, 4) int32 the inserted keys (by reference)
    mask: torch.Tensor  # (N,) bool validity of coords rows


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) (int64), c < 2^32, with no
    int64 product past 2^48."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _murmur3(c: torch.Tensor, seed: int) -> torch.Tensor:
    """MurmurHash3 (32-bit) over the 4 int32 coordinate words, as int64
    in [0, 2^32)."""
    u = c.to(torch.int64) & _M32
    h = torch.full(u.shape[:-1], seed, dtype=torch.int64, device=c.device)
    for i in range(4):
        k = _mul32(u[..., i], 0xCC9E2D51)
        k = _rotl(k, 15)
        k = _mul32(k, 0x1B873593)
        h = h ^ k
        h = _rotl(h, 13)
        h = (_mul32(h, 5) + 0xE6546B64) & _M32
    h = h ^ 16  # length in bytes
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _hash4(c: torch.Tensor) -> torch.Tensor:
    """Probe-sequence hash."""
    return _murmur3(c, 0x811C9DC5)


def _fingerprint(c: torch.Tensor) -> torch.Tensor:
    """Independent second hash used as the per-slot key fingerprint, as
    int32 with the uint32's bits."""
    h = _murmur3(c, 0x7E3779B9)
    return (h - ((h >> 31) << 32)).to(torch.int32)


def _table_size(capacity: int) -> int:
    s = 1
    while s < 4 * capacity:  # load <= 0.25: ~1-2 probe rounds typical
        s *= 2
    return max(s, 32)


def _build(coords, mask, S: int, max_rounds: int) -> torch.Tensor:
    N = coords.shape[0]
    dev = coords.device
    h = _hash4(coords)
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    slots = torch.full((S,), -1, dtype=torch.int32, device=dev)
    probe = torch.zeros((N,), dtype=torch.int64, device=dev)
    placed = torch.zeros((N,), dtype=torch.bool, device=dev)
    r = 0
    while r < max_rounds:
        if r % CHECK_EVERY == 0 and bool(torch.all(placed | ~mask)):
            break
        slot = (h + probe) & (S - 1)
        active = mask & ~placed
        # propose: scatter-min of row index into each slot; slot S takes
        # the inactive rows and is dropped (JAX's mode="drop")
        proposal = torch.full((S + 1,), N, dtype=torch.int32, device=dev)
        proposal.scatter_reduce_(0, torch.where(active, slot, S), idx,
                                 reduce="amin")
        proposal = proposal[:S]
        taken = slots >= 0
        winner = torch.where(~taken & (proposal < N), proposal, -1)
        slots = torch.where(winner >= 0, winner, slots)
        won = active & (slots[slot] == idx)
        placed = placed | won
        probe = torch.where(active & ~won, probe + 1, probe)
        r += 1
    ROUNDS["build"] = r
    return slots


def build_hash_table(coords, mask, max_rounds: int = 128,
                     device="cuda") -> HashTable:
    """Insert all valid coordinate rows. coords (N, 4) int32, mask (N,)
    (tensors or numpy arrays), on `device`.

    Table size is the next power of two >= 4N (load <= 0.25). Duplicate
    keys should not occur (coords are the output of a unique/quantize
    pass); if they do, one of the duplicates stays unplaced and lookups
    resolve to the placed one.
    """
    dev = resolve_device(device)
    coords = to_device(coords, dev, torch.int32)
    mask = to_device(mask, dev, torch.bool)
    S = _table_size(coords.shape[0])
    slots = _build(coords, mask, S, max_rounds)
    safe = torch.where(slots >= 0, slots, 0).to(torch.int64)
    fps = torch.where(slots >= 0, _fingerprint(coords[safe]), 0)
    return HashTable(slots=slots, fps=fps.to(torch.int32), coords=coords,
                     mask=mask)


def lookup(table: HashTable, queries, q_mask=None,
           max_probes: int = 128) -> torch.Tensor:
    """Find the row index of each query key; -1 if absent.

    queries: (M, 4) int32, on the table's device. Fingerprint-compare per
    probe; the final hit is verified against full coordinates (a
    fingerprint false positive becomes a miss rather than a wrong row).
    """
    S = table.slots.shape[0]
    dev = table.slots.device
    queries = to_device(queries, dev, torch.int32)
    q_mask = to_device(q_mask, dev, torch.bool)
    h = _hash4(queries)
    fp_q = _fingerprint(queries)
    M = queries.shape[0]
    found = torch.full((M,), -1, dtype=torch.int32, device=dev)
    if q_mask is None:
        dead = torch.zeros((M,), dtype=torch.bool, device=dev)
    else:
        dead = ~q_mask  # invalid queries resolve immediately to -1
    p = 0
    while p < max_probes:
        if p % CHECK_EVERY == 0 and not bool(torch.any((found < 0) & ~dead)):
            break
        slot = (h + p) & (S - 1)
        row = table.slots[slot]
        fp_s = table.fps[slot]
        empty = row < 0
        match = (row >= 0) & (fp_s == fp_q)
        open_q = (found < 0) & ~dead
        found = torch.where(open_q & match, row, found)
        dead = dead | (open_q & empty)
        p += 1
    ROUNDS["lookup"] = p
    # verify fingerprint hits against the actual keys (collision safety)
    hit = found >= 0
    cand = torch.where(hit, found, 0).to(torch.int64)
    ok = hit & torch.all(table.coords[cand] == queries, dim=-1)
    found = torch.where(ok, found, -1)
    if q_mask is not None:
        found = torch.where(q_mask, found, -1)
    return found
