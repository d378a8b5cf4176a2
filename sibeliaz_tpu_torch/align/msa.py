"""Block MSA batching and MAF assembly.

A copy of sibeliaz_tpu/align/msa.py, except that it compiles the port's
own copy of the native POA engine (align/native/poa.cpp) into the port's
build directory, runs the device engine of
align/device_poa.py for engine="tpu", counts what the routing did in
utils/metrics.GLOBAL, and leaves the budget at None (each engine's own
default) unless the caller gives one.

Drives the native POA engine over all LCBs and writes the MAF exactly the
way the reference pipeline's bash stage assembles it
(SibeliaZ-LCB/sibeliaz:119-134):

  * header: `##maf version=1`, a version stamp, and `# cmd=<args>`,
  * one MAF block per LCB: blank line, `a`, then an `s` line per copy:
    `s <name> <start> <len> <strand> <chrSize> <alignedrow>`, rows in the
    (id, chr, start) block order; negative-strand rows carry the reverse
    complement with start = chrSize - end (blocksfinder.h:563-574),
  * file-level block order replicates the chunked fan-out + C-locale merge:
    LCB group g goes to chunk g mod chunks, chunks are concatenated in
    string-sorted name order (sibeliaz:128-131),
  * blocks whose POA DP exceeds the memory budget are written as FASTA into
    `<outdir>/blocks/` (the reference README documents this intent but its
    script silently drops them, sibeliaz:69-73 — we keep them).
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from sibeliaz_tpu_torch.core import alphabet
from sibeliaz_tpu_torch.lcb.blocks import Block
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics
from sibeliaz_tpu_torch.utils.nativebuild import build_native

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native", "poa.cpp")
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_native(_SRC, "libszpoa.so"))
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.sz_poa_run.restype = ctypes.c_void_p
    lib.sz_poa_run.argtypes = [u8p, i64p, i64p, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int64, i64p]
    lib.sz_poa_block_bytes.restype = ctypes.c_int64
    lib.sz_poa_block_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.sz_poa_block_rows.restype = u8p
    lib.sz_poa_block_rows.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.sz_poa_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def ensure_built() -> None:
    """Build (or load the disk-cached) native POA engine; idempotent."""
    _load()


def poa_msa_batch(
    blocks_seqs: Sequence[Sequence[np.ndarray]],
    threads: int = 1,
    budget_bytes: int = 2 << 30,
) -> List[List[bytes] | None]:
    """MSA per block (list of uint8 sequences); None if over budget."""
    lib = _load()
    flat: List[np.ndarray] = []
    blk_off = np.zeros(len(blocks_seqs) + 1, dtype=np.int64)
    for b, seqs in enumerate(blocks_seqs):
        flat.extend(np.ascontiguousarray(s, dtype=np.uint8) for s in seqs)
        blk_off[b + 1] = blk_off[b] + len(seqs)
    seq_off = np.zeros(len(flat) + 1, dtype=np.int64)
    for i, s in enumerate(flat):
        seq_off[i + 1] = seq_off[i] + len(s)
    data = (
        np.concatenate(flat) if flat else np.zeros(0, np.uint8)
    ).astype(np.uint8, copy=False)
    widths = np.zeros(len(blocks_seqs), dtype=np.int64)
    h = lib.sz_poa_run(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        seq_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        blk_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(blocks_seqs), threads, budget_bytes,
        widths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    try:
        out: List[List[bytes] | None] = []
        for b, seqs in enumerate(blocks_seqs):
            w = int(widths[b])
            if w < 0:
                out.append(None)
                continue
            nbytes = lib.sz_poa_block_bytes(h, b)
            ptr = lib.sz_poa_block_rows(h, b)
            buf = bytes(
                np.ctypeslib.as_array(ptr, shape=(nbytes,))
            ) if nbytes else b""
            rows = [buf[i * w : (i + 1) * w] for i in range(len(seqs))]
            out.append(rows)
    finally:
        lib.sz_poa_free(h)
    return out


def block_copies(
    blocks: Sequence[Block],
) -> List[Tuple[int, List[Block]]]:
    """Group trimmed blocks (already (id,chr,start)-sorted) by id."""
    groups: Dict[int, List[Block]] = {}
    order: List[int] = []
    for b in blocks:
        if b.block_id not in groups:
            groups[b.block_id] = []
            order.append(b.block_id)
        groups[b.block_id].append(b)
    return [(bid, groups[bid]) for bid in sorted(order)]


def copy_sequence(b: Block, seqs: Sequence[np.ndarray]) -> np.ndarray:
    s = seqs[b.chr][b.start : b.end]
    return s if b.signed_id > 0 else alphabet.reverse_complement(s)


def maf_s_line(b: Block, name: str, chr_size: int, row: bytes) -> str:
    if b.signed_id > 0:
        start = b.start
    else:
        start = chr_size - b.end
    strand = "+" if b.signed_id > 0 else "-"
    return (
        f"s {name} {start} {b.length} {strand} {chr_size} "
        + row.decode("ascii")
        + "\n"
    )


def align_blocks_to_maf(
    blocks: Sequence[Block],
    seqs: Sequence[np.ndarray],
    names: Sequence[str],
    maf_path: str,
    cmd: str = "",
    chunks: int = 256,
    threads: int = 1,
    budget_bytes: int | None = None,
    version_stamp: str = "sibeliaz v1.2.7",
    engine: str = "native",
    tie_policy: str = "first",
    device: str = "cuda",
) -> List[int]:
    """Align all LCBs and write the MAF; returns the ids of overflow blocks
    (their copies are written to <dir>/blocks/<id>.fa).

    engine="native" runs the OpenMP C++ POA; engine="tpu" runs the batched
    device DP (align/device_poa.py) on `device` ("cuda": the K3 kernel,
    "cpu": its plain PyTorch version) with native fallback for blocks that
    exceed its memory budget — both produce identical MSAs (tested).

    budget_bytes is the -f memory budget: it caps the native engine's
    per-process DP memory and, on the tpu engine, the device DP's H + dirs
    scratch.  None (the default, as the CLI passes without -f) means 2 GiB
    for the native engine and device_poa.default_budget(device), read once
    here at the start of the stage, for the device DP.

    tie_policy="last" is the spoa-envelope ANALYSIS mode: it aligns every
    block with the executable spec under the OPPOSITE (still optimal) tie
    preferences (poa_ref.poa_msa_alt_ties) — any correct implementation
    of spoa's invoked scoring (sibeliaz:67) produces an MSA between the
    two policies' outputs.  Spec-speed; not for production runs."""
    device_budget = budget_bytes
    if budget_bytes is None:
        budget_bytes = 2 << 30
    groups = block_copies(blocks)
    blocks_seqs = [
        [copy_sequence(b, seqs) for b in grp] for _, grp in groups
    ]
    if tie_policy == "last":
        from sibeliaz_tpu_torch.align.poa_ref import poa_msa_alt_ties

        msas = [poa_msa_alt_ties(rows) for rows in blocks_seqs]
    elif engine == "tpu":
        import threading

        from sibeliaz_tpu_torch.align import device_poa

        if device_budget is None:
            device_budget = device_poa.default_budget(device)
        # blocks over the device scratch budget are known up front — run
        # them on the native engine CONCURRENTLY with the device
        # dispatches (ctypes releases the GIL), instead of serially
        # afterwards
        elig = device_poa.device_budget_eligible(
            blocks_seqs, budget_bytes=device_budget
        )
        dev_idx = [g for g, e in enumerate(elig) if e]
        nat_idx = [g for g, e in enumerate(elig) if not e]
        metrics.count("poa_native_routed", len(nat_idx))
        msas: List[List[bytes] | None] = [None] * len(blocks_seqs)

        def _native_side():
            out = poa_msa_batch(
                [blocks_seqs[g] for g in nat_idx],
                threads=threads, budget_bytes=budget_bytes,
            )
            for g, m in zip(nat_idx, out):
                msas[g] = m

        th = None
        if nat_idx:
            th = threading.Thread(target=_native_side)
            th.start()
        dev_out = device_poa.poa_msa_batch_tpu(
            [blocks_seqs[g] for g in dev_idx], budget_bytes=device_budget,
            device=device,
        )
        if th is not None:
            th.join()
        for g, m in zip(dev_idx, dev_out):
            msas[g] = m
        # runtime fallbacks (extract overflow etc.) redo natively
        missing = [g for g, m in enumerate(msas) if m is None]
        metrics.count("poa_native_redo", len(missing))
        if missing:
            redo = poa_msa_batch(
                [blocks_seqs[g] for g in missing],
                threads=threads,
                budget_bytes=budget_bytes,
            )
            for g, m in zip(missing, redo):
                msas[g] = m
    else:
        msas = poa_msa_batch(
            blocks_seqs, threads=threads, budget_bytes=budget_bytes
        )

    out_dir = os.path.dirname(os.path.abspath(maf_path))
    overflow: List[int] = []

    # chunk fan-out order: group g -> chunk g % chunks; merge order = chunk
    # names string-sorted; within a chunk, groups in ascending g.
    n_chunks = max(1, chunks)
    chunk_names = sorted(str(i) for i in range(n_chunks))
    by_chunk: Dict[str, List[int]] = {cn: [] for cn in chunk_names}
    for g in range(len(groups)):
        by_chunk[str(g % n_chunks)].append(g)

    with open(maf_path, "w") as f:
        f.write("##maf version=1\n")
        f.write(f"# {version_stamp} \n")
        f.write(f"# cmd={cmd}\n")
        for cn in chunk_names:
            for g in by_chunk[cn]:
                bid, grp = groups[g]
                rows = msas[g]
                if rows is None:
                    overflow.append(bid)
                    continue
                f.write("\na\n")
                for b, row in zip(grp, rows):
                    f.write(
                        maf_s_line(b, names[b.chr], len(seqs[b.chr]), row)
                    )

    if overflow:
        from sibeliaz_tpu_torch.io import fasta as fasta_io

        bdir = os.path.join(out_dir, "blocks")
        os.makedirs(bdir, exist_ok=True)
        gid = {bid: grp for bid, grp in groups}
        for bid in overflow:
            recs = [
                fasta_io.FastaRecord(
                    f"{names[b.chr]};{b.start if b.signed_id > 0 else len(seqs[b.chr]) - b.end};"
                    f"{b.length};{'+' if b.signed_id > 0 else '-'};{len(seqs[b.chr])}",
                    copy_sequence(b, seqs),
                )
                for b in gid[bid]
            ]
            fasta_io.write_fasta(os.path.join(bdir, f"{bid}.fa"), recs)
    return overflow
