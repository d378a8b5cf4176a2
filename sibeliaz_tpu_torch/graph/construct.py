"""Compacted-dBG junction enumeration on a CUDA card (the TwoPaCo stage).

The same exact sort-based formulation as sibeliaz_tpu/graph/construct.py,
in PyTorch around two hand-written kernels (graph/kernels.py):

  1. all chromosomes are joined with one 'N' separator and packed on the
     host into 2-bit codes plus a validity bitmap (0.375 B/position),
  2. K1 `front_half` computes, per position, the canonical k-mer key and the
     packed extension/boundary/orientation word; the key is one int64 for
     k <= 31 and two base-2^62 limbs (hi, lo) for 33 <= k <= 61,
  3. a stable torch.sort by key groups each vertex class, keeping genome
     order inside a class; two limbs sort as two stable passes, the low
     limb first,
  4. K2 `class_analysis` gives each sorted row its junction verdict and the
     position of its class's first occurrence,
  5. torch ops scatter both back to genome order, rank the class-first
     positions into dense signed ids and compact the junction rows.

Semantics contract: identical output to graph/oracle.py and to the JAX
package's build_junctions (tested).  k <= 61.  An input whose monolithic
stage does not fit the card (or the memory budget), or that has 2^31
positions or more, runs the streamed stage instead (graph/streamed.py: the
same records, in rounds).
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Sequence

import numpy as np
import torch

from sibeliaz_tpu_torch.core import alphabet
from sibeliaz_tpu_torch.graph import kernels
from sibeliaz_tpu_torch.graph.assemble import split_chromosomes
from sibeliaz_tpu_torch.io.dbg import JunctionChr
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

# Device bytes per position the graph stage may hold at its peak (the sort:
# the key and packed word, torch.sort's values and int64 indices and its
# scratch).  chip_smoke.py measures the peak with
# torch.cuda.max_memory_allocated: 52.2 B/position at 12 and 16 Mbp on an
# NVIDIA H100 80GB HBM3 with a 700 W power limit (PERF.md); the bound keeps
# ~20% headroom over that.
PEAK_BYTES_PER_POS = 64
# The same for two-limb keys (k >= 33: a second int64 limb, the sort's
# second pass and its gathers): 68.2 B/position on examples/large (12 Mbp,
# chip_smoke.py phase 6) and on the 16 Mbp strains (phase 9) at k=33, same
# card; ~20% headroom again.
PEAK_BYTES_PER_POS_WIDE = 82


def pack_codes_host(codes: np.ndarray):
    """Pack a BAD_CODE-carrying uint8 code stream into (2-bit codes,
    1-bit validity bitmap) for upload: 0.375 B/position instead of 1.  The
    tail is padded to a multiple of 8 with BAD_CODE, which the kernels never
    read past len(codes)."""
    pad = -len(codes) % 8
    if pad:
        codes = np.concatenate([codes, np.full(pad, alphabet.BAD_CODE, np.uint8)])
    valid = codes != alphabet.BAD_CODE
    c = np.where(valid, codes, 0).astype(np.uint8).reshape(-1, 4)
    packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    nmask = np.packbits(
        valid.reshape(-1, 8), axis=1, bitorder="little"
    ).ravel()
    return packed, nmask


def pack_codes_device(codes_u8: torch.Tensor):
    """pack_codes_host in torch ops on the codes' own device: (2-bit codes,
    validity bitmap), the tail padded to a multiple of 8 with BAD_CODE."""
    pad = -codes_u8.shape[0] % 8
    codes = torch.cat([codes_u8, torch.full((pad,), alphabet.BAD_CODE, dtype=torch.uint8,
                                            device=codes_u8.device)]) if pad else codes_u8
    valid = codes != alphabet.BAD_CODE
    c = torch.where(valid, codes, 0).view(-1, 4)
    packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    bit = torch.arange(8, device=codes.device)
    nmask = (valid.view(-1, 8).long() << bit).sum(dim=1).to(torch.uint8)
    return packed, nmask


def check_k(k: int) -> None:
    """Refuse k > 61, as the JAX package does."""
    if k > kernels.MAX_K:
        raise NotImplementedError(
            f"k={k}: the graph stage takes k <= {kernels.MAX_K} (two 62-bit "
            "limbs), as the JAX package does; no ROADMAP.md item goes wider"
        )


def device_budget(device: torch.device, budget: int | None) -> int | None:
    """The device bytes the graph stage may use: `budget` where one is given;
    else on a CUDA card its free memory and what PyTorch's allocator holds
    unused; else None (no limit: the CPU path)."""
    if budget is not None or device.type != "cuda":
        return budget
    free = torch.cuda.mem_get_info(device)[0]
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def check_fits(n: int, k: int, budget: int | None) -> bool:
    """Refuse k > 61; say whether the monolithic graph stage runs n
    positions: fewer than 2^31 (its int32 positions), with a peak within
    `budget` bytes (None: no limit)."""
    check_k(k)
    need = n * (PEAK_BYTES_PER_POS if k <= kernels.ONE_LIMB_MAX_K else PEAK_BYTES_PER_POS_WIDE)
    return n < 1 << 31 and (budget is None or need <= budget)


@contextlib.contextmanager
def _step(name: str, device: torch.device):
    """A metrics stage that ends when the device has finished its work."""
    with metrics.stage(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def sort_keys(keys):
    """Stable sort of the rows by their keys, lexicographic over the limbs
    (as lax.sort(num_keys=len(keys), is_stable=True)): two limbs take two
    stable passes, the low limb first, so ties keep genome order and a
    class's first row is its first occurrence.  Takes ownership of `keys`
    (a list, emptied here so that each buffer is freed once it is spent).

    Returns (sorted keys tuple, int64 row order)."""
    if len(keys) == 1:
        key_s, order = torch.sort(keys.pop(), stable=True)
        return (key_s,), order
    lo = keys.pop()
    lo_s, o1 = torch.sort(lo, stable=True)
    del lo
    hi1 = keys.pop()[o1]
    hi_s, o2 = torch.sort(hi1, stable=True)
    del hi1
    order = o1[o2]
    del o1
    return (hi_s, lo_s[o2]), order


def class_verdicts(keys, packed, step=lambda name: contextlib.nullcontext()):
    """The vertex class analysis of rows in insertion order: a stable sort
    by key (sort_keys, which takes ownership of the `keys` list), K2
    class_analysis with each row's insertion rank as its position, and the
    verdicts scattered back.  Rows of a class must lie in genome order, so
    that a class's least rank is its first occurrence.  `step(name)` wraps
    the sort ("graph_sort") and the analysis ("graph_class_analysis").

    Returns (junction flag, the rank of the class's first row), each in
    insertion order."""
    with step("graph_sort"):
        keys_s, order = sort_keys(keys)
        packed_s = packed[order]
        ranks_s = order.to(torch.int32)
        del order
    with step("graph_class_analysis"):
        junction_s, first_s = kernels.class_analysis(keys_s, packed_s, ranks_s)
        del keys_s, packed_s
        isj = torch.empty_like(junction_s)
        isj[ranks_s] = junction_s
        first = torch.empty_like(first_s)
        first[ranks_s] = first_s
    return isj, first


def front_verdicts(codes, n: int, k: int, step=lambda name: contextlib.nullcontext()):
    """K1 front_half, then class_verdicts, on K1's packed input: `codes`
    is the list [2-bit codes, validity bitmap], whose buffers this takes
    over (the list is emptied, so that they are freed before the sort).
    `step(name)` wraps K1 ("graph_front_half") and class_verdicts' steps.

    Returns (junction flag, the first occurrence's position, K1's packed
    word), each in genome order."""
    with step("graph_front_half"):
        keys, packed = kernels.front_half(codes[0], codes[1], n, k)
        keys = list(keys)  # class_verdicts frees each limb once it is sorted
        codes.clear()
    isj, first = class_verdicts(keys, packed, step)
    return isj, first, packed


def build_junctions(
    seqs: Sequence[np.ndarray],
    k: int,
    device: str | torch.device = "cuda",
    memory_budget_bytes: int | None = None,
) -> List[JunctionChr]:
    """Run junction enumeration on `device`; return per-chromosome records.

    `memory_budget_bytes`: device bytes the stage may use (default: the
    card's free memory; no limit on the CPU).  Where the monolithic stage
    does not fit it, or n >= 2^31, the streamed stage runs instead
    (streamed.build_junctions_streamed_resident, with this budget).

    Each step is a metrics stage (graph_upload, graph_front_half,
    graph_sort, graph_class_analysis, graph_ids_fetch) that waits for the
    device before it ends."""
    device = torch.device(device)
    if not seqs:
        return []
    lengths = [len(s) for s in seqs]
    n = sum(lengths) + len(seqs) - 1
    budget = device_budget(device, memory_budget_bytes)
    if not check_fits(n, k, budget):
        from sibeliaz_tpu_torch.graph import streamed

        return streamed.build_junctions_streamed_resident(
            seqs, k, device, memory_budget_bytes=budget)
    sep = np.array([ord("N")], dtype=np.uint8)  # separator (never definite)
    joined = np.concatenate(
        [x for s in seqs for x in (s, sep)][:-1] if len(seqs) > 1 else [seqs[0]]
    )
    if n < k:
        return [
            JunctionChr(pos=np.zeros(0, np.uint32), ids=np.zeros(0, np.int64))
            for _ in seqs
        ]

    with _step("graph_upload", device):
        pk_host, nm_host = pack_codes_host(alphabet.encode(joined))
        codes = [torch.from_numpy(pk_host).to(device), torch.from_numpy(nm_host).to(device)]
        del pk_host, nm_host
    isj, first, packed = front_verdicts(codes, n, k, functools.partial(_step, device=device))
    with _step("graph_ids_fetch", device):
        # a class's first occurrence is itself a junction row, so ranking
        # the rows where first == position gives the dense ids of
        # assemble.assign_ids
        idx = torch.arange(n, dtype=torch.int32, device=device)
        crank = torch.cumsum(isj & (first == idx), 0, dtype=torch.int32)
        jpos = torch.nonzero(isj).squeeze(1)
        ids = crank[first[jpos].long()].long()
        signed = torch.where(((packed[jpos] >> 11) & 1) > 0, ids, -ids)
        jpos_h = jpos.cpu().numpy()
        signed_h = signed.cpu().numpy()
    metrics.set("graph_positions", n)
    metrics.set("graph_junctions", len(jpos_h))
    return split_chromosomes(jpos_h, signed_h, lengths, lead_sep=0)


def junction_analysis(codes_u8: torch.Tensor, k: int):
    """Per-position junction analysis of a separator-joined uint8 code
    tensor, on its device (sibeliaz_tpu/graph/construct.py:153): the codes
    packed there (pack_codes_device), then front_verdicts (K1, the sort
    and K2).  Returns, in genome order:
      is_junction_occ: bool — valid k-mer whose vertex is a junction
      positive:        bool — forward k-mer is canonical
      first_idx:       int32 — index of the vertex's first occurrence
                       (meaningful only where is_junction_occ)
    Any k that check_k takes; two limbs sort as build_junctions' do."""
    check_k(k)
    n = codes_u8.shape[0]
    if n == 0:
        empty = torch.zeros(0, dtype=torch.bool, device=codes_u8.device)
        return empty, empty, torch.zeros(0, dtype=torch.int32, device=codes_u8.device)
    isj, first, packed = front_verdicts(list(pack_codes_device(codes_u8)), n, k)
    return isj, ((packed >> 11) & 1) > 0, first


def junction_analysis_packed(codes_u8: torch.Tensor, k: int):
    """junction_analysis with the flags in one uint8 (bit 0 junction
    occurrence, bit 1 positive orientation) and int32 first indices
    (sibeliaz_tpu/graph/construct.py:181)."""
    isj, positive, first = junction_analysis(codes_u8, k)
    return isj.to(torch.uint8) | (positive.to(torch.uint8) << 1), first.to(torch.int32)
