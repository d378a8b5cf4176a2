"""Junction table: the in-memory graph model consumed by the LCB engine.

Flat-array redesign of the reference's JunctionStorage
(SibeliaZ-LCB/junctionstorage.h:116-698).  Same observable semantics:

  * two passes over the junction stream: count abundance per |id|, then keep
    records with abundance < threshold (junctionstorage.h:576-617),
  * per-chromosome arrays of (pos, signed id) in position order, with a
    per-record `used` flag,
  * per-vertex occurrence lists sorted by (chr, idx) (:646-649),
  * per-occurrence annotation chars: ch = seq[pos+k] (note: one past the
    chromosome end yields byte 0, matching std::string::operator[](size())),
    revCh = complement(seq[pos-1]), or 'N' at pos 0 (:635-644),
  * vertex-count V = max |id| in the *unfiltered* stream + 1 (vertex slots
    are allocated during the abundance pass, :585-591).

Everything is numpy so the native engine can borrow the buffers zero-copy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from sibeliaz_tpu_torch.core import alphabet
from sibeliaz_tpu_torch.io.dbg import JunctionChr


@dataclasses.dataclass
class JunctionTable:
    k: int
    names: List[str]
    seqs: List[np.ndarray]  # uint8 ASCII
    jpos: List[np.ndarray]  # int64 junction positions per chr
    jid: List[np.ndarray]  # int64 signed ids per chr (as stored)
    used: List[np.ndarray]  # uint8 flags per chr
    n_vertices: int  # max |id| over the unfiltered stream, + 1
    # CSR occurrence lists per abs vertex id: slice [occ_off[v], occ_off[v+1])
    occ_off: np.ndarray  # int64, len n_vertices+1
    occ_chr: np.ndarray  # int32
    occ_idx: np.ndarray  # int64 (index into jpos[chr])
    occ_ch: np.ndarray  # uint8 annotation char (successor on + strand)
    occ_revch: np.ndarray  # uint8 annotation char (predecessor complement)

    # Flat concatenations with per-chr offsets.  jpos/jid/used above are
    # zero-copy VIEWS into these (used mutations write through), so
    # consumers that need the flat layout (the native engine's C ABI,
    # DeviceTables, the per-phase used refresh) never re-concatenate.
    chr_off: np.ndarray = None  # int64 [n_chr+1]
    jpos_flat: np.ndarray = None
    jid_flat: np.ndarray = None
    used_flat: np.ndarray = None
    seq_off: np.ndarray = None  # int64 [n_chr+1]
    seq_flat: np.ndarray = None

    @property
    def n_chr(self) -> int:
        return len(self.seqs)

    def instances_count(self, vid: int) -> int:
        v = abs(vid)
        return int(self.occ_off[v + 1] - self.occ_off[v])

    @classmethod
    def build(
        cls,
        records: Sequence[JunctionChr],
        seqs: Sequence[np.ndarray],
        names: Sequence[str],
        k: int,
        abundance_threshold: int,
    ) -> "JunctionTable":
        if len(records) > len(seqs):
            raise ValueError("more junction chromosomes than sequences")
        # Pass 1: abundance per |id| across the whole stream.
        all_ids = (
            np.concatenate([r.ids for r in records])
            if records
            else np.zeros(0, np.int64)
        )
        max_abs = int(np.abs(all_ids).max()) if len(all_ids) else 0
        n_vertices = max_abs + 1
        abundance = np.bincount(np.abs(all_ids).astype(np.int64), minlength=n_vertices)

        # Pass 2: keep records whose vertex abundance < threshold.
        jpos_l: List[np.ndarray] = []
        jid_l: List[np.ndarray] = []
        occ_v: List[np.ndarray] = []
        occ_c: List[np.ndarray] = []
        occ_i: List[np.ndarray] = []
        # Divergence note (investigated, deliberate): the reference's
        # per-occurrence idx counter resets via `if (GetChr() > chr)
        # { chr++; idx = 0; }` ONCE PER RECORD (junctionstorage.h:600-613),
        # so a chromosome with zero junction records (e.g. all-N) desyncs
        # vertex idx from the dense position index on the next chromosome
        # (its first two records both get idx 0) — and the reference binary
        # then ABORTS on such inputs (verified: SIGABRT on an all-N middle
        # chromosome).  We keep the dense indexing and simply work.
        for c in range(len(seqs)):
            if c < len(records):
                ids = records[c].ids.astype(np.int64)
                pos = records[c].pos.astype(np.int64)
                keep = abundance[np.abs(ids)] < abundance_threshold
                ids, pos = ids[keep], pos[keep]
            else:
                ids = np.zeros(0, np.int64)
                pos = np.zeros(0, np.int64)
            jpos_l.append(pos)
            jid_l.append(ids)
            occ_v.append(np.abs(ids))
            occ_c.append(np.full(len(ids), c, dtype=np.int32))
            occ_i.append(np.arange(len(ids), dtype=np.int64))

        # flat layout once; per-chr entries become zero-copy views
        chr_off = np.zeros(len(seqs) + 1, dtype=np.int64)
        for c in range(len(seqs)):
            chr_off[c + 1] = chr_off[c] + len(jpos_l[c])
        jpos_flat = (
            np.concatenate(jpos_l) if jpos_l else np.zeros(0, np.int64)
        )
        jid_flat = (
            np.concatenate(jid_l) if jid_l else np.zeros(0, np.int64)
        )
        used_flat = np.zeros(len(jpos_flat), dtype=np.uint8)
        seq_off = np.zeros(len(seqs) + 1, dtype=np.int64)
        for c in range(len(seqs)):
            seq_off[c + 1] = seq_off[c] + len(seqs[c])
        seq_flat = (
            np.concatenate([np.asarray(s, dtype=np.uint8) for s in seqs])
            if len(seqs) else np.zeros(0, np.uint8)
        )
        jpos = [
            jpos_flat[chr_off[c]:chr_off[c + 1]] for c in range(len(seqs))
        ]
        jid = [
            jid_flat[chr_off[c]:chr_off[c + 1]] for c in range(len(seqs))
        ]
        used = [
            used_flat[chr_off[c]:chr_off[c + 1]] for c in range(len(seqs))
        ]

        # Occurrence CSR sorted by (vertex, chr, idx): chromosome-order concat
        # is already (chr, idx)-sorted, so a stable sort by vertex suffices.
        vv = np.concatenate(occ_v) if occ_v else np.zeros(0, np.int64)
        cc = np.concatenate(occ_c) if occ_c else np.zeros(0, np.int32)
        ii = np.concatenate(occ_i) if occ_i else np.zeros(0, np.int64)
        order = np.argsort(vv, kind="stable")
        vv, cc, ii = vv[order], cc[order], ii[order]
        occ_off = np.zeros(n_vertices + 1, dtype=np.int64)
        np.add.at(occ_off, vv + 1, 1)
        occ_off = np.cumsum(occ_off)

        # Annotation chars, vectorized per chromosome then gathered.
        ch_per_chr: List[np.ndarray] = []
        revch_per_chr: List[np.ndarray] = []
        for c in range(len(seqs)):
            pos = jpos[c]
            L = len(seqs[c])
            nxt = np.where(pos + k < L, np.minimum(pos + k, max(L - 1, 0)), 0)
            chc = np.where(pos + k < L, seqs[c][nxt] if L else 0, 0).astype(np.uint8)
            prv = np.maximum(pos - 1, 0)
            rvc = np.where(
                pos > 0,
                alphabet.complement_char(seqs[c][prv] if L else np.zeros(0, np.uint8)),
                ord("N"),
            ).astype(np.uint8)
            ch_per_chr.append(chc)
            revch_per_chr.append(rvc)
        ch_cat = (
            np.concatenate(ch_per_chr) if ch_per_chr else np.zeros(0, np.uint8)
        )
        revch_cat = (
            np.concatenate(revch_per_chr) if revch_per_chr else np.zeros(0, np.uint8)
        )
        ch = ch_cat[order]
        revch = revch_cat[order]

        return cls(
            k=k,
            names=list(names),
            seqs=list(seqs),
            jpos=jpos,
            jid=jid,
            used=used,
            n_vertices=n_vertices,
            occ_off=occ_off,
            occ_chr=cc,
            occ_idx=ii,
            occ_ch=ch,
            occ_revch=revch,
            chr_off=chr_off,
            jpos_flat=jpos_flat,
            jid_flat=jid_flat,
            used_flat=used_flat,
            seq_off=seq_off,
            seq_flat=seq_flat,
        )
