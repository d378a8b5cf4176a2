"""The streamed graph stage: junction enumeration in rounds, for inputs whose
monolithic graph stage (construct.py) does not fit the card.

Two routes, the JAX package's two (sibeliaz_tpu/graph/streamed.py), with
the same records as construct.build_junctions'.  Both upload the genome
once, joined with a leading 'N' and one after each sequence, packed on the
host into 2-bit codes and a validity bitmap (0.375 B/position on the
device) and padded with BAD_CODE so that the last chunk's window lies
inside it; both split the vertex classes into rounds by a hash of the
canonical key (kernels.round_bucket), so that a class lies whole in one
round; and both end on the host: the junction rows in genome order, the
class-first positions ranked into ids, the records split per chromosome
(`_assemble`).

build_junctions_streamed_resident, the device-resident rounds (TwoPaCo's
multiple rounds on the card):

  1. a pass over the stream fills G round buffers at once: per chunk, K1
     front_half on the chunk's window, then K4 round_append, which appends
     the rows of rounds r0 .. r0 + G - 1 in genome order.  The host reads
     the cursors and the overflow flag once per pass;
  2. per round (the epilogue, `_junction_rows`): a stable sort of its live
     rows by key, K2 class_analysis with each row's insertion rank as its
     position (so K2 keeps int32 positions while global ones pass 2^32),
     the verdicts and class-first ranks scattered back to insertion order
     (construct.class_verdicts), and the junction rows' global position,
     class-first position and orientation copied to the host.

A round buffer that overflows makes the stage double n_rounds and run
again.  Device memory is the packed stream, one chunk's K1 outputs, G round
buffers and one round's epilogue at a time; n_rounds and G come from the
memory budget (`plan`).  Global positions are int64 throughout, and K4's
payload (gpos << 12 | the 12-bit word) holds them below 2^51: that is the
stage's only bound on the input's length.

build_junctions_streamed, the host-bucketed rounds, for a class that
outgrows every round: a round buffer never falls below min(chunk, n // 8)
rows, and a class never splits, so a k-mer with more occurrences than that
overflows at any round count.  After MAX_ROUND_GROWTH times the initial
round count the resident rounds hand over to it, as the JAX package's do.
Pass 1 runs K1 per chunk and copies each chunk's valid rows (key limbs and
payload), sorted by round, to the host once, into one bucket per round;
pass 2 uploads each round's bucket whole, whatever its size, and runs the
same epilogue on it.

Metrics stages: `graph_upload`; per pass of the resident rounds
`graph_scan`, and pass 1 of the host-bucketed rounds `graph_bucket`; the
epilogues `graph_round_epilogue`; `graph_assemble`.  Counters:
`graph_positions`, `graph_passes`, `graph_rounds`,
`graph_rounds_per_pass` and `graph_round_retries` say how the resident
rounds cut the input, `graph_host_rounds` the host-bucketed round count
where that route ran, and `graph_junctions`.

Left out of the JAX package's functions, which carried them for the TPU:
the u32 split of int64 carries, flat round buffers, the cap - chunk write
headroom, the narrow/wide payload split (one int64 payload serves every
input), the epilogue's output cap, the segmentation of a pass into
dispatches with its environment knobs, the hand-over of 2^32 - chunk
positions and more to the host-bucketed rounds (the u32 payload's bound;
the resident rounds take them), the host route's padding of a round to a
power of two and its SZ_STREAM_STATS printing.
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
# The resident rounds' overflow retries end at this many times the initial
# round count, and hand over to the host-bucketed rounds: a class with more
# rows than a round's floor never splits (sibeliaz_tpu/graph/streamed.py:751-758).
MAX_ROUND_GROWTH = 64


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


def _chunk(n: int, chunk_size: int) -> int:
    """Positions a chunk: chunk_size, or the whole input (a multiple of 8)
    where it is shorter."""
    return min(chunk_size, -(-(n - 2) // 8) * 8)


def _padded(n: int, k: int, chunk: int) -> int:
    """Positions of the uploaded stream: every chunk's window inside it, a
    multiple of 8."""
    n_chunks = -(-(n - 2) // chunk)
    return -(-(1 + n_chunks * chunk + k + 1) // 8) * 8


def plan(n: int, k: int, chunk_size: int, round_slack: float, budget: int | None,
         n_rounds: int | None = None) -> Plan:
    """Cut n joined positions into rounds within `budget` device bytes (None:
    no limit).  A chunk is `_chunk(n, chunk_size)` positions.  A round
    buffer holds n * round_slack / n_rounds rows, never fewer than the floor
    min(chunk, n // 8) (which is what lets the overflow retry end: more
    rounds stop shrinking it).  n_rounds, unless given, is the least power of
    two whose round holds at most MAX_ROUND_ROWS and fits the budget with its
    epilogue; G is as many round buffers as the rest holds, at most n_rounds
    and kernels.MAX_ROUNDS_PER_LAUNCH.  Raises MemoryError where no round
    fits."""
    chunk = _chunk(n, chunk_size)
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


def _junction_rows(keys, payload):
    """The junction rows of one round: `keys`, a list of its rows' key limbs
    (taken, as construct.sort_keys takes it), and `payload`, gpos << 12 |
    the 12-bit word, in genome order.  Returns (global position, class-first
    position, orientation) as host arrays, in genome order."""
    # rows of a class lie in genome order, so the class's least insertion
    # rank is its first occurrence
    isj, first_rank = construct.class_verdicts(keys, (payload & 0xFFF).to(torch.int32))
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


def _chunk_rows(codes2, nmask, lo: int, chunk: int, k: int):
    """K1 on the window of the chunk whose rows are positions lo + 1 ..
    lo + chunk: the rows' key limbs and words (window offset q + 1 is the
    chunk's row q)."""
    win = chunk + k + 2
    keys, packed = kernels.front_half(
        codes2[lo // 4 : (lo + win + 3) // 4], nmask[lo // 8 : (lo + win + 7) // 8], win, k)
    return tuple(key[1 : chunk + 1] for key in keys), packed[1 : chunk + 1]


def _scan_pass(codes2, nmask, n: int, k: int, p: Plan, r0: int, G: int):
    """One pass over the stream into the buffers of rounds r0 .. r0 + G - 1:
    (key buffers, payload buffer, each round's live rows, overflowed)."""
    device = codes2.device
    limbs = 1 if k <= kernels.ONE_LIMB_MAX_K else 2
    buf_keys = tuple(torch.empty((G, p.cap), dtype=torch.int64, device=device)
                     for _ in range(limbs))
    buf_payload = torch.empty((G, p.cap), dtype=torch.int64, device=device)
    cursors = torch.zeros(G, dtype=torch.int64, device=device)
    overflow = torch.zeros(1, dtype=torch.int32, device=device)
    for lo in range(0, n - 2, p.chunk):
        keys, packed = _chunk_rows(codes2, nmask, lo, p.chunk, k)
        kernels.round_append(keys, packed, lo + 1, r0, p.n_rounds, buf_keys, buf_payload,
                             cursors, overflow)
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
                    out.append(_junction_rows([buf[g, :rows] for buf in buf_keys],
                                              buf_payload[g, :rows]))
            del buf_keys, buf_payload
    return out


def _bucket_pass(codes2, nmask, n: int, k: int, chunk: int, n_rounds: int):
    """Pass 1 of the host-bucketed rounds: per chunk, K1, then its valid rows
    sorted stably by round and copied to the host once, as the rounds' end
    rows and a [limbs + 1, rows] int64 block (the key limbs, then the
    payload gpos << 12 | word); each round's run of the block is appended to
    its bucket, so a bucket holds its rows in genome order.  The device
    sorts and copies chunk i + 1 while the host buckets chunk i.  Returns
    (buckets, rows per round)."""
    device = codes2.device
    limbs = 1 if k <= kernels.ONE_LIMB_MAX_K else 2
    buckets = [[] for _ in range(n_rounds)]
    sizes = np.zeros(n_rounds, np.int64)
    bounds = torch.arange(1, n_rounds + 1, device=device)

    def absorb(host, done):
        if done is not None:
            done.synchronize()
        ends = host[:n_rounds].numpy()
        # out of the copy's staging buffer: the buckets keep their own
        block = host[n_rounds:].numpy().reshape(limbs + 1, -1).copy()
        counts = np.diff(ends, prepend=0)
        sizes[:] += counts
        for r in np.flatnonzero(counts):
            buckets[r].append(block[:, ends[r] - counts[r] : ends[r]])

    pending = None
    for lo in range(0, n - 2, chunk):
        keys, packed = _chunk_rows(codes2, nmask, lo, chunk, k)
        rows = torch.nonzero(keys[0] != kernels.INVALID_CANON).squeeze(1)
        kept = tuple(key[rows] for key in keys)
        rnd, order = torch.sort(kernels.round_bucket(kept, n_rounds), stable=True)
        rows = rows[order]
        flat = torch.cat([torch.searchsorted(rnd, bounds), *(key[order] for key in kept),
                          ((lo + 1 + rows) << 12) | (packed[rows].long() & 0xFFF)])
        del keys, packed, kept, rnd, order, rows
        if device.type == "cuda":
            host, done = flat.to("cpu", non_blocking=True), torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
        else:
            host, done = flat, None
        if pending is not None:
            absorb(*pending)
        pending = (host, done)
    if pending is not None:
        absorb(*pending)
    return buckets, sizes


def _host_rounds(codes2, nmask, n: int, k: int, chunk: int, n_rounds: int, lengths):
    """The host-bucketed rounds on the uploaded stream: pass 1
    (_bucket_pass), then per round its bucket uploaded whole and its
    junction rows (_junction_rows); the records."""
    device = codes2.device
    with construct._step("graph_bucket", device):
        buckets, sizes = _bucket_pass(codes2, nmask, n, k, chunk, n_rounds)
    if sizes.max() > MAX_ROUND_ROWS:
        raise ValueError(
            f"a round of {sizes.max()} rows in {n_rounds} rounds: K2 takes at most "
            f"{MAX_ROUND_ROWS} rows a round; raise n_rounds")
    metrics.set("graph_host_rounds", n_rounds)
    parts = []
    with construct._step("graph_round_epilogue", device):
        for r in range(n_rounds):
            if buckets[r]:
                block = torch.from_numpy(np.concatenate(buckets[r], axis=1)).to(device)
                buckets[r] = None
                parts.append(_junction_rows(list(block[:-1]), block[-1]))
                del block
    return _assemble(parts, lengths)


def _assemble(parts, lengths) -> List[JunctionChr]:
    """The records from the rounds' junction rows ((global position,
    class-first position, orientation) each, in genome order): the rows
    merged by position, ids ranked from the class-first positions, the
    records split per chromosome."""
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


def _joined(seqs, k: int, chunk_size: int):
    """Checks k and chunk_size; returns the positions of the joined genome
    (a leading N, one after each sequence) and the sequences' lengths."""
    construct.check_k(k)
    if chunk_size < 8 or chunk_size % 8:
        raise ValueError(f"chunk_size must be a positive multiple of 8, got {chunk_size}")
    lengths = [len(s) for s in seqs]
    return 1 + sum(L + 1 for L in lengths), lengths


def build_junctions_streamed_resident(
    seqs: Sequence[np.ndarray],
    k: int,
    device: str | torch.device = "cuda",
    chunk_size: int = 1 << 22,
    n_rounds: int | None = None,
    round_slack: float = 1.25,
    memory_budget_bytes: int | None = None,
) -> List[JunctionChr]:
    """Junction records equal to construct.build_junctions', in rounds
    resident on the device; inputs of fewer than 2^51 positions.

    chunk_size: positions a chunk (a multiple of 8; at most the input);
    n_rounds: the initial round count (default: the least the budget
    holds); round_slack: a round buffer's rows over the input's positions
    per round; memory_budget_bytes: device bytes the stage may use
    (default: the card's free memory; no limit on the CPU).  Where the
    round buffers still overflow at MAX_ROUND_GROWTH times the initial
    round count, the host-bucketed rounds finish the stage on the uploaded
    stream with the last round count (build_junctions_streamed's)."""
    device = torch.device(device)
    n, lengths = _joined(seqs, k, chunk_size)
    if n < k + 2:
        return _assemble([], lengths)
    budget = construct.device_budget(device, memory_budget_bytes)
    p = plan(n, k, chunk_size, round_slack, budget, n_rounds)

    with construct._step("graph_upload", device):
        codes2, nmask = _upload(seqs, n, k, p.chunk, device)
    metrics.set("graph_positions", n)

    initial, retries = p.n_rounds, 0
    while ((parts := _run_rounds(codes2, nmask, n, k, p)) is None
           and p.n_rounds < MAX_ROUND_GROWTH * initial):
        retries += 1
        p = plan(n, k, chunk_size, round_slack, budget, 2 * p.n_rounds)
    metrics.set("graph_round_retries", retries)
    if parts is None:  # a class outgrows every round
        return _host_rounds(codes2, nmask, n, k, p.chunk, p.n_rounds, lengths)
    del codes2, nmask
    metrics.set("graph_rounds", p.n_rounds)
    metrics.set("graph_rounds_per_pass", p.G)
    return _assemble(parts, lengths)


def build_junctions_streamed(
    seqs: Sequence[np.ndarray],
    k: int,
    device: str | torch.device = "cuda",
    chunk_size: int = 1 << 22,
    n_rounds: int = 4,
) -> List[JunctionChr]:
    """Junction records equal to construct.build_junctions', in n_rounds
    host-bucketed rounds: device memory is the packed stream, one chunk's
    scan and one round's rows with their epilogue, each round sized by its
    own rows; host memory 16 B per valid position (24 with two-limb keys).
    Raises ValueError where a round holds more than MAX_ROUND_ROWS rows.

    chunk_size: positions a chunk (a multiple of 8; at most the input)."""
    device = torch.device(device)
    n, lengths = _joined(seqs, k, chunk_size)
    if not 1 <= n_rounds < 1 << 31:
        raise ValueError(f"n_rounds must lie in [1, 2^31), got {n_rounds}")
    if n < k + 2:
        return _assemble([], lengths)
    chunk = _chunk(n, chunk_size)
    with construct._step("graph_upload", device):
        codes2, nmask = _upload(seqs, n, k, chunk, device)
    metrics.set("graph_positions", n)
    return _host_rounds(codes2, nmask, n, k, chunk, n_rounds, lengths)
