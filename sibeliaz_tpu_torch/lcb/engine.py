"""Native LCB engine binding.

Compiles the JAX package's sibeliaz_tpu/lcb/native/engine.cpp by file path
on first use (g++ -O3 -fopenmp, cached by mtime) and drives it through
ctypes — the engine's interface is a handful of flat numpy buffers, so a C
ABI is the natural boundary.  The C++ stays single-sourced: the port reads
the file and never imports the JAX package.
"""

from __future__ import annotations

import ctypes
import os
from typing import List

import numpy as np

from sibeliaz_tpu_torch.junctions.table import JunctionTable
from sibeliaz_tpu_torch.lcb.blocks import Block
from sibeliaz_tpu_torch.utils.nativebuild import build_native

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "sibeliaz_tpu", "lcb", "native", "engine.cpp",
)

_lib = None


def ensure_built():
    """Build (or load the disk-cached) native engine; idempotent."""
    _load()


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_native(_SRC, "libszlcb.so"))
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.sz_lcb_run.restype = ctypes.c_void_p
    lib.sz_lcb_run.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, i64p,
        ctypes.POINTER(ctypes.c_uint8),
        i64p, ctypes.POINTER(ctypes.c_uint8),
        i64p, ctypes.POINTER(ctypes.c_int32), i64p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, i64p,
    ]
    lib.sz_lcb_blocks.restype = i64p
    lib.sz_lcb_blocks.argtypes = [ctypes.c_void_p]
    lib.sz_lcb_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _pu8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def run_native(
    table: JunctionTable,
    min_block_size: int,
    max_branch_size: int,
    max_flanking_size: int,
    looking_depth: int = 8,
    threads: int = 1,
) -> List[Block]:
    """Run the native engine; mutates table.used like the reference does."""
    lib = _load()
    n_chr = table.n_chr
    # zero-copy: the table's flat layout is shared with its per-chr views,
    # so the engine's in-place `used` mutations are immediately visible
    # through table.used — no concatenate, no copy-back
    chr_off = table.chr_off
    jpos = table.jpos_flat
    jid = table.jid_flat
    used = table.used_flat
    seq_off = table.seq_off
    seq = table.seq_flat
    occ_off = table.occ_off.astype(np.int64, copy=False)
    occ_chr = table.occ_chr.astype(np.int32, copy=False)
    occ_idx = table.occ_idx.astype(np.int64, copy=False)

    n_blocks = ctypes.c_int64(0)
    found = ctypes.c_int64(0)
    failures = ctypes.c_int64(0)
    handle = lib.sz_lcb_run(
        table.k, table.n_vertices, n_chr,
        _p64(chr_off), _p64(jpos), _p64(jid), _pu8(used),
        _p64(seq_off), _pu8(seq),
        _p64(occ_off),
        occ_chr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _p64(occ_idx),
        _pu8(table.occ_ch), _pu8(table.occ_revch),
        min_block_size, max_branch_size, max_flanking_size,
        looking_depth, threads,
        ctypes.byref(n_blocks), ctypes.byref(found), ctypes.byref(failures),
    )
    try:
        n = n_blocks.value
        ptr = lib.sz_lcb_blocks(handle)
        flat = np.ctypeslib.as_array(ptr, shape=(n * 4,)).copy() if n else np.zeros(0, np.int64)
    finally:
        lib.sz_lcb_free(handle)

    blocks = [
        Block(int(flat[4 * i]), int(flat[4 * i + 1]), int(flat[4 * i + 2]), int(flat[4 * i + 3]))
        for i in range(n)
    ]
    return blocks
