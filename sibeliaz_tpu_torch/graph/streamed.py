"""The streamed graph stage: junction enumeration in rounds, for inputs whose
monolithic graph stage (construct.py) does not fit the card.

The port of sibeliaz_tpu/graph/streamed.py::build_junctions_streamed_resident
(device-resident rounds, TwoPaCo's multiple rounds on the card):

  1. the genome, joined with a leading 'N' and one after each sequence, is
     packed on the host into 2-bit codes and a validity bitmap and uploaded
     once, padded with BAD_CODE so that the last chunk's window lies inside
     it;
  2. the vertex classes are split into n_rounds rounds by a hash of the
     canonical key (kernels.round_bucket), so that a class lies whole in one
     round.  A pass over the stream fills G round buffers at once: per
     chunk, K1 front_half on the chunk's window, then K4 round_append, which
     appends the rows of rounds r0 .. r0 + G - 1 in genome order.  The host
     reads the cursors and the overflow flag once per pass;
  3. per round (the epilogue): a stable sort of its live rows by key, K2
     class_analysis with each row's insertion rank as its position (so K2
     keeps int32 positions while global ones pass 2^31), the verdicts and
     class-first ranks scattered back to insertion order, and the junction
     rows' global position, class-first position and orientation copied to
     the host;
  4. on the host: the junction rows in genome order, the class-first
     positions ranked into ids, the records split per chromosome.

A round buffer that overflows makes the stage double n_rounds and run
again.  Device memory is the packed stream (0.375 B/position), one chunk's
K1 outputs, G round buffers and one round's epilogue at a time; n_rounds and
G come from the memory budget (`plan`).  Each pass is a metrics stage
`graph_scan` and its epilogues one `graph_round_epilogue`; the counters
`graph_passes`, `graph_rounds`, `graph_rounds_per_pass` and
`graph_round_retries` say how the input was cut.

Left out of the JAX package's function, which carried them for the TPU:
the u32 split of int64 carries, flat round buffers, the cap - chunk write
headroom, the narrow/wide payload split (one int64 payload, gpos << 12 | the
12-bit word, serves every input), the epilogue's output cap, and the
segmentation of a pass into dispatches with its environment knobs.  Where
the JAX package gives way to its host-bucketed path (2^32 - chunk positions
and more, or rounds that still overflow at 64 times the initial count), the
port refuses (ROADMAP.md queue A item 4).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np
import torch

from sibeliaz_tpu_torch.core import alphabet
from sibeliaz_tpu_torch.graph import construct, kernels
from sibeliaz_tpu_torch.graph.assemble import assign_ids, split_chromosomes
from sibeliaz_tpu_torch.io.dbg import JunctionChr
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

# Device bytes per live row that one round's epilogue holds at its peak, on
# top of the round buffers: the rows' int32 words, the stable sort's keys,
# int64 order and scratch (two passes for two limbs), then K2's inputs and
# outputs and the scatters.  chip_smoke.py measures the peak with
# torch.cuda.max_memory_allocated: 44.25 B/row at k=25 and 68.25 at k=33 on
# a round of examples/large (1.5 M rows) on an NVIDIA H100 80GB HBM3 with a
# 700 W power limit (PERF.md); these keep 8% and 13% headroom over it.
EPILOGUE_BYTES_PER_ROW = 48
EPILOGUE_BYTES_PER_ROW_WIDE = 77
# K2 takes int32 positions (here insertion ranks), so a round holds fewer
# than 2^31 rows.
MAX_ROUND_ROWS = (1 << 31) - 1
# Overflow retries end at this many times the initial round count: a class
# with more rows than a round's floor never splits (streamed.py:751-758).
MAX_ROUND_GROWTH = 64
QUEUE_A4 = "ROADMAP.md queue A item 4 (the host-bucketed streamed stage)"


@dataclasses.dataclass(frozen=True)
class Plan:
    """How an input is cut: chunks of `chunk` positions, n_rounds rounds of
    at most `cap` rows, G round buffers per pass.  fixed_bytes: the packed
    stream and one chunk's scan; row_bytes: a buffer row; epilogue_bytes: a
    live row's epilogue."""

    chunk: int
    n_rounds: int
    cap: int
    G: int
    fixed_bytes: int
    row_bytes: int
    epilogue_bytes: int

    @property
    def peak_bytes(self) -> int:
        return self.fixed_bytes + self.cap * (self.G * self.row_bytes + self.epilogue_bytes)


def _padded(n: int, k: int, chunk: int) -> int:
    """Positions of the uploaded stream: every chunk's window inside it, a
    multiple of 8."""
    n_chunks = -(-(n - 2) // chunk)
    return -(-(1 + n_chunks * chunk + k + 1) // 8) * 8


def plan(n: int, k: int, chunk_size: int, round_slack: float, budget: int | None,
         n_rounds: int | None = None) -> Plan:
    """Cut n joined positions into rounds within `budget` device bytes (None:
    no limit).  A chunk is chunk_size positions, or the whole input where it
    is shorter.  A round buffer holds n * round_slack / n_rounds rows, never
    fewer than the floor min(chunk, n // 8) (which is what lets the overflow
    retry end: more rounds stop shrinking it).  n_rounds, unless given, is the
    least power of two whose round fits the budget with its epilogue; G is as
    many round buffers as the rest holds, at most n_rounds and
    kernels.MAX_ROUNDS_PER_LAUNCH.  Raises MemoryError where no round fits."""
    chunk = min(chunk_size, -(-(n - 2) // 8) * 8)
    limbs = 1 if k <= kernels.ONE_LIMB_MAX_K else 2
    row = 8 * limbs + 8
    epi = EPILOGUE_BYTES_PER_ROW if limbs == 1 else EPILOGUE_BYTES_PER_ROW_WIDE
    fixed = (_padded(n, k, chunk) * 3 // 8 + (chunk + k + 2) * (8 * limbs + 4)
             + kernels.round_scratch_bytes(chunk, kernels.MAX_ROUNDS_PER_LAUNCH))
    floor = max(1, min(chunk, n // 8))

    def cap_of(r: int) -> int:
        return max(floor, math.ceil(n * round_slack / r))

    def fits(r: int) -> bool:
        c = cap_of(r)
        return c <= MAX_ROUND_ROWS and (budget is None or fixed + c * (row + epi) <= budget)

    if n_rounds is None:
        n_rounds = 1
        while not fits(n_rounds):
            if cap_of(n_rounds) == floor:
                break
            n_rounds *= 2
    cap = cap_of(n_rounds)
    if cap > MAX_ROUND_ROWS:
        raise ValueError(f"{n_rounds} rounds of {n} positions need {cap} rows a round; K2 "
                         f"takes at most {MAX_ROUND_ROWS}: raise n_rounds")
    G = min(n_rounds, kernels.MAX_ROUNDS_PER_LAUNCH)
    if budget is not None:
        G = min(G, (budget - fixed - cap * epi) // (cap * row))
    if G < 1:
        raise MemoryError(
            f"the streamed graph stage needs {fixed + cap * (row + epi)} B of device memory "
            f"for {n} positions in {n_rounds} rounds (budget {budget} B)")
    return Plan(chunk, n_rounds, cap, G, fixed, row, epi)


def _round_junctions(buf_keys, buf_payload, g: int, live: int):
    """Round g's junction rows: (global position, class-first position,
    orientation) as host arrays, in genome order."""
    payload = buf_payload[g, :live]
    # rows of a class lie in genome order in the buffer, so the class's
    # least insertion rank is its first occurrence
    isj, first_rank = construct.class_verdicts(
        [buf[g, :live] for buf in buf_keys], (payload & 0xFFF).to(torch.int32))
    rows = torch.nonzero(isj).squeeze(1)
    row_payload = payload[rows]
    first = payload[first_rank[rows].long()] >> 12
    return ((row_payload >> 12).cpu().numpy(), first.cpu().numpy(),
            (((row_payload >> 11) & 1) > 0).cpu().numpy())


def _upload(seqs, n: int, k: int, chunk: int, device):
    """The joined genome (a leading N, one after each sequence), packed and
    padded with BAD_CODE to _padded positions, on `device`: (codes2, nmask)."""
    sep = np.array([ord("N")], dtype=np.uint8)
    codes = np.full(_padded(n, k, chunk), alphabet.BAD_CODE, dtype=np.uint8)
    codes[:n] = alphabet.encode(np.concatenate([sep] + [x for s in seqs for x in (s, sep)]))
    pk_host, nm_host = construct.pack_codes_host(codes)
    del codes
    return torch.from_numpy(pk_host).to(device), torch.from_numpy(nm_host).to(device)


def _scan_pass(codes2, nmask, n: int, k: int, p: Plan, r0: int, G: int):
    """One pass over the stream into the buffers of rounds r0 .. r0 + G - 1:
    (key buffers, payload buffer, each round's live rows, overflowed)."""
    device = codes2.device
    chunk = p.chunk
    limbs = 1 if k <= kernels.ONE_LIMB_MAX_K else 2
    win = chunk + k + 2
    buf_keys = tuple(torch.empty((G, p.cap), dtype=torch.int64, device=device)
                     for _ in range(limbs))
    buf_payload = torch.empty((G, p.cap), dtype=torch.int64, device=device)
    cursors = torch.zeros(G, dtype=torch.int64, device=device)
    overflow = torch.zeros(1, dtype=torch.int32, device=device)
    for lo in range(0, n - 2, chunk):  # lo: the window's first position, chunk start - 1
        # local position q of the chunk is window offset q + 1
        keys, packed = kernels.front_half(
            codes2[lo // 4 : (lo + win + 3) // 4], nmask[lo // 8 : (lo + win + 7) // 8], win, k)
        kernels.round_append(
            tuple(key[1 : chunk + 1] for key in keys), packed[1 : chunk + 1], lo + 1,
            r0, p.n_rounds, buf_keys, buf_payload, cursors, overflow)
        del keys, packed
    *live, overflowed = torch.cat([cursors, overflow.long()]).tolist()
    return buf_keys, buf_payload, live, bool(overflowed)


def _run_rounds(codes2, nmask, n: int, k: int, p: Plan):
    """Every round of plan p: the junction rows of each round, or None when
    a round buffer overflowed."""
    device = codes2.device
    out = []
    for r0 in range(0, p.n_rounds, p.G):
        with construct._step("graph_scan", device):
            buf_keys, buf_payload, live, overflowed = _scan_pass(
                codes2, nmask, n, k, p, r0, min(p.G, p.n_rounds - r0))
        metrics.count("graph_passes")
        if overflowed:
            return None
        with construct._step("graph_round_epilogue", device):
            for g, rows in enumerate(live):
                if rows:
                    out.append(_round_junctions(buf_keys, buf_payload, g, rows))
            del buf_keys, buf_payload
    return out


def build_junctions_streamed_resident(
    seqs: Sequence[np.ndarray],
    k: int,
    device: str | torch.device = "cuda",
    chunk_size: int = 1 << 22,
    n_rounds: int | None = None,
    round_slack: float = 1.25,
    memory_budget_bytes: int | None = None,
) -> List[JunctionChr]:
    """Junction records equal to construct.build_junctions', in rounds.

    chunk_size: positions a chunk (a multiple of 8; at most the input);
    n_rounds: the initial round count (default: the least the budget
    holds); round_slack: a round buffer's rows over the input's positions
    per round; memory_budget_bytes: device bytes the stage may use
    (default: the card's free memory; no limit on the CPU)."""
    device = torch.device(device)
    construct.check_k(k)
    if chunk_size < 8 or chunk_size % 8:
        raise ValueError(f"chunk_size must be a positive multiple of 8, got {chunk_size}")
    if not seqs:
        return []
    lengths = [len(s) for s in seqs]
    n = 1 + sum(L + 1 for L in lengths)
    if n >= (1 << 32) - chunk_size:
        raise NotImplementedError(
            f"{n} positions: the resident rounds take fewer than 2^32 - chunk_size; larger "
            f"inputs are {QUEUE_A4}")
    if n < k + 2:
        return [JunctionChr(pos=np.zeros(0, np.uint32), ids=np.zeros(0, np.int64))
                for _ in seqs]
    budget = construct.device_budget(device, memory_budget_bytes)
    p = plan(n, k, chunk_size, round_slack, budget, n_rounds)

    with construct._step("graph_upload", device):
        codes2, nmask = _upload(seqs, n, k, p.chunk, device)

    initial, retries = p.n_rounds, 0
    while (parts := _run_rounds(codes2, nmask, n, k, p)) is None:
        if p.n_rounds >= MAX_ROUND_GROWTH * initial:
            raise NotImplementedError(
                f"round buffers still overflow at {p.n_rounds} rounds ({MAX_ROUND_GROWTH} times "
                f"the initial {initial}): a class outgrows a round; such inputs are {QUEUE_A4}")
        retries += 1
        p = plan(n, k, chunk_size, round_slack, budget, 2 * p.n_rounds)
    del codes2, nmask
    metrics.set("graph_rounds", p.n_rounds)
    metrics.set("graph_rounds_per_pass", p.G)
    metrics.set("graph_round_retries", retries)
    metrics.set("graph_positions", n)

    with metrics.stage("graph_assemble"):
        if parts:
            gpos, first, positive = (np.concatenate(x) for x in zip(*parts))
        else:
            gpos, first, positive = np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, bool)
        # each round's rows are in genome order: the stable sort merges runs
        order = np.argsort(gpos, kind="stable")
        gpos, first, positive = gpos[order], first[order], positive[order]
        records = split_chromosomes(gpos, assign_ids(first, positive), lengths, lead_sep=1)
    metrics.set("graph_junctions", len(gpos))
    return records
