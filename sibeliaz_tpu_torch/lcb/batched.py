"""Path.Init for a whole phase on the host: every lane's initial instance
set as padded [lanes, cap] arrays (path.h:33-46), in numpy.

A copy of sibeliaz_tpu/lcb/batched.py's `SeedBatch` and `seed_batch`, the
host seeding that the fused engine's lanes over a device list start from
(lcb/resident.py `_seed_lanes`).  How it differs: the rest of that module
is left out.  `used_prefix`, `used_range_any`, `first_votes`,
`first_votes_device` and `_first_votes_kernel` serve only the JAX
package's test-only development slices (ROADMAP "Do not port"); the fused
engine reads the used flags through its device tables' prefix instead.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from sibeliaz_tpu_torch.junctions.table import JunctionTable
from sibeliaz_tpu_torch.lcb.oracle import Bundle


@dataclasses.dataclass
class SeedBatch:
    """Initial instances per lane; row b = bundle b of the phase."""

    chr: np.ndarray  # [lanes, cap] int32, -1 padding
    idx: np.ndarray  # [lanes, cap] int64
    strand: np.ndarray  # [lanes, cap] int8
    n: np.ndarray  # [lanes] int32 — live instances per lane


def seed_batch(table: JunctionTable, bundles: Sequence[Bundle]) -> SeedBatch:
    """Vectorized Path.Init for every bundle of a phase.

    An occurrence seeds an instance iff its strand-aware used slot is clear
    and its sequential out-char equals the bundle char (the annotation
    chars already encode the sequential-iterator semantics incl. the
    chromosome-end '\\0' and pos-0 'N' conventions)."""
    lanes = len(bundles)
    if lanes == 0:
        return SeedBatch(
            chr=np.zeros((0, 0), np.int32),
            idx=np.zeros((0, 0), np.int64),
            strand=np.zeros((0, 0), np.int8),
            n=np.zeros(0, np.int32),
        )
    occ_off = table.occ_off
    cap = int(
        max(
            int(occ_off[abs(b.vid) + 1] - occ_off[abs(b.vid)])
            for b in bundles
        )
    )
    out_chr = np.full((lanes, cap), -1, np.int32)
    out_idx = np.zeros((lanes, cap), np.int64)
    out_str = np.zeros((lanes, cap), np.int8)
    out_n = np.zeros(lanes, np.int32)

    # flat used array for strand-aware slot tests
    chr_off = np.zeros(table.n_chr + 1, dtype=np.int64)
    for c in range(table.n_chr):
        chr_off[c + 1] = chr_off[c] + len(table.used[c])
    used_all = (
        np.concatenate(table.used)
        if table.n_chr
        else np.zeros(0, np.uint8)
    )
    jid_all = (
        np.concatenate(table.jid) if table.n_chr else np.zeros(0, np.int64)
    )

    for b, bundle in enumerate(bundles):
        v = abs(bundle.vid)
        lo, hi = int(occ_off[v]), int(occ_off[v + 1])
        cs = table.occ_chr[lo:hi].astype(np.int64)
        is_ = table.occ_idx[lo:hi]
        flat = chr_off[cs] + is_
        stored = jid_all[flat]
        s = np.where(stored == bundle.vid, 1, -1).astype(np.int8)
        # strand-aware used slot: + uses its own slot, - uses idx-1 (idx 0
        # on the minus strand is never used)
        slot = np.where(s > 0, flat, flat - 1)
        usable = np.where(
            (s > 0) | (is_ > 0), used_all[np.maximum(slot, 0)] == 0, True
        )
        charv = np.where(s > 0, table.occ_ch[lo:hi], table.occ_revch[lo:hi])
        keep = usable & (charv == bundle.ch)
        m = int(keep.sum())
        out_chr[b, :m] = cs[keep]
        out_idx[b, :m] = is_[keep]
        out_str[b, :m] = s[keep]
        out_n[b] = m
    return SeedBatch(chr=out_chr, idx=out_idx, strand=out_str, n=out_n)
