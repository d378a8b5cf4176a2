"""The graph stage over several shards: the counterpart of
sibeliaz_tpu/parallel/sharded.py, with the same records as
construct.build_junctions.

The chromosomes are joined with a leading 'N' and one after each, and the
joined stream is cut into contiguous shards, one per entry of a device
list (a device may repeat: each entry is one shard).  Per shard:

  a. the shard's bytes, one byte on its left and k + 1 on its right (read
     straight from the host input, which every shard or process holds
     whole; 'N' past the global edges), packed and uploaded; K1
     front_half on those L + k + 2 positions, of which [1, L + 1) are
     kept, so that the windows, extension characters and boundary bits at
     both shard edges come out as in the monolithic stage;
  b. the valid rows (key limbs, K1's word, int64 global position), each
     given to the owner shard hash(key) mod n_shards (the JAX package's
     hash), ordered by owner with one stable sort so that each owner's
     rows stay in genome order;
  c. the per-owner counts swapped, then the rows, with exact split sizes;
  d. on each owner, the rows received in source-shard order (genome
     order, since shards are contiguous) through construct.class_verdicts
     (the stable sort, then K2 on insertion ranks), each row's class-first
     rank mapped to that row's global position;
  e. the verdicts sent back by the inverse exchange, one int64 a row
     (first global position << 1 | junction);
  f. each shard's junction rows (global position, first, orientation)
     gathered in shard order, their ids ranked and split per chromosome on
     the host (assemble.assign_ids, split_chromosomes).

What differs from the JAX package: its ppermute halos are reads of the
host input here (every process holds all of it), which also serves a
shard shorter than k + 1; its [n_dev, cap] send matrix with a capacity
factor, overflow flag and doubling retry, and its power-of-two bucket
padding, existed for XLA's static shapes and give the same records as
exact splits, which are used instead.

The steps run over a transport (one interface, two kinds): InProcess, over
a device list in one process (rows move by .to(device)), here; and
multihost.Distributed, over a torch.distributed process group, one rank a
shard.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence

import numpy as np
import torch

from sibeliaz_tpu_torch.core import alphabet
from sibeliaz_tpu_torch.graph import construct, kernels
from sibeliaz_tpu_torch.graph.assemble import assign_ids, split_chromosomes
from sibeliaz_tpu_torch.io.dbg import JunctionChr
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

# Bytes a shard keeps per row it sends: its word and global position until
# the verdicts come back (the key limbs are freed after the exchange).
KEPT_BYTES_PER_ROW = 12
# An owner's peak per row it receives: the monolithic stage's peak per
# position (the stable sort, K2 and the scatters; construct.py) plus the
# row's global position and its verdict.
OWNER_EXTRA_BYTES_PER_ROW = 16
# Insertion ranks are int32 (construct.class_verdicts).
MAX_OWNER_ROWS = (1 << 31) - 1


def need_bytes(local: Sequence[int], n_total: int, k: int) -> int:
    """Device bytes that the shards of `local` positions each, all on one
    device, need at their peak in the worst case, where every valid row of
    the n_total positions goes to owners on this device: the larger of the
    local phase (the rows kept so far and one shard's K1, row selection and
    owner sort) and the owner phase (the rows kept for the verdicts, and
    the owners' rows through class_verdicts)."""
    limbs = 1 if k <= kernels.ONE_LIMB_MAX_K else 2
    peak = (construct.PEAK_BYTES_PER_POS if limbs == 1
            else construct.PEAK_BYTES_PER_POS_WIDE)
    sent = 8 * limbs + 4 + 8  # a row on the wire: key limbs, K1's word, global position
    local_phase = sum(local) * sent + max(local) * peak
    owner_phase = (sum(local) * KEPT_BYTES_PER_ROW
                   + n_total * (peak + OWNER_EXTRA_BYTES_PER_ROW))
    return max(local_phase, owner_phase)


def check_shards_fit(bounds: Sequence[int], shards: Sequence[int], devices, k: int) -> None:
    """Refuse k > 61; raise MemoryError, with the numbers, if the shards of
    some device do not fit its budget (construct.device_budget: the card's
    free memory; no limit on the CPU).  bounds: the shards' edges in the
    joined stream; shards, devices: this process's shards and their
    devices."""
    construct.check_k(k)
    n_total = bounds[-1]
    for dev in dict.fromkeys(devices):
        local = [bounds[s + 1] - bounds[s] + k + 2
                 for s, d in zip(shards, devices) if d == dev]
        budget = construct.device_budget(dev, None)
        need = need_bytes(local, n_total, k)
        if budget is not None and need > budget:
            raise MemoryError(
                f"{len(local)} shard(s) of {max(local)} positions on {dev} need up to "
                f"{need} bytes with every row of the {n_total} positions on their "
                f"owners (the worst case), over the device's budget of {budget} bytes")


def normalize(device) -> torch.device:
    """torch.device(device), with a bare "cuda" made the current card's."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class InProcess:
    """Shards over a device list in one process: rows move by .to(device),
    a peer copy between cards and a copy on one card."""

    def __init__(self, devices):
        self.devices = [normalize(d) for d in devices]
        self.n = len(self.devices)
        self.shards = list(range(self.n))

    def swap_counts(self, counts: List[List[int]]) -> List[List[int]]:
        """counts[s][d]: the rows shard s sends to shard d.  Returns, per
        shard d, the rows it receives from each shard s."""
        return [[counts[s][d] for s in range(self.n)] for d in range(self.n)]

    def exchange(self, send_counts, recv_counts, tensors):
        """tensors[s]: shard s's fields, rows ordered by destination.
        Returns, per shard d, each field's rows from every shard,
        concatenated in source-shard order."""
        offsets = [np.concatenate([[0], np.cumsum(c)]).tolist() for c in send_counts]
        return [
            [torch.cat([tensors[s][f][offsets[s][d]:offsets[s][d + 1]].to(dev)
                        for s in range(self.n)])
             for f in range(len(tensors[d]))]
            for d, dev in enumerate(self.devices)]

    def gather(self, rows: List[torch.Tensor]) -> np.ndarray:
        """Every shard's rows on the host, in shard order."""
        return torch.cat([r.cpu() for r in rows]).numpy()


@contextlib.contextmanager
def _step(name: str, devices):
    """A metrics stage that ends when every device has finished its work."""
    with metrics.stage(name):
        yield
        for dev in dict.fromkeys(devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


def owner_of(keys, n_shards: int) -> torch.Tensor:
    """Each row's owner shard, as the JAX package's _bucket_exchange: the
    key times its mixer (two limbs: hi * MIX xor lo * MIX2), wrapping in
    int64, its sign bit cleared, modulo n_shards."""
    h = keys[0] * kernels.MIX
    if len(keys) == 2:
        h = h ^ (keys[1] * kernels.MIX2)
    return (h & 0x7FFFFFFFFFFFFFFF) % n_shards


def joined_codes(seqs: Sequence[np.ndarray]) -> np.ndarray:
    """The 2-bit codes of 'N' + seq_0 + 'N' + ... + seq_last + 'N'."""
    sep = np.array([ord("N")], dtype=np.uint8)
    return alphabet.encode(np.concatenate([sep, *(x for s in seqs for x in (s, sep))]))


def shard_bounds(n_total: int, n_shards: int) -> List[int]:
    """The edges of n_shards contiguous shards of n_total positions."""
    return [s * n_total // n_shards for s in range(n_shards + 1)]


def extended_shard(codes: np.ndarray, lo: int, hi: int, k: int) -> np.ndarray:
    """codes[lo - 1 : hi + k + 1], with BAD_CODE ('N') past either end."""
    a, b = lo - 1, hi + k + 1
    return np.concatenate([
        np.full(max(0, -a), alphabet.BAD_CODE, np.uint8),
        codes[max(a, 0):min(b, len(codes))],
        np.full(max(0, b - len(codes)), alphabet.BAD_CODE, np.uint8)])


def local_rows(codes, lo: int, hi: int, k: int, n_shards: int, device, step):
    """Steps a and b for the shard [lo, hi): the rows per owner and the
    fields [key limbs..., word, global position], rows ordered by owner."""
    with step("graph_upload"):
        ext = extended_shard(codes, lo, hi, k)
        pk_host, nm_host = construct.pack_codes_host(ext)
        codes2 = torch.from_numpy(pk_host).to(device)
        nmask = torch.from_numpy(nm_host).to(device)
    with step("graph_front_half"):
        keys, packed = kernels.front_half(codes2, nmask, len(ext), k)
        del codes2, nmask
    with step("graph_shard_rows"):
        rows = torch.nonzero(keys[0][1 : hi - lo + 1] != kernels.INVALID_CANON).squeeze(1)
        keys = [key[1:][rows] for key in keys]
        packed = packed[1:][rows]
        owner, order = torch.sort(owner_of(keys, n_shards), stable=True)
        counts = torch.bincount(owner, minlength=n_shards).tolist()
        del owner
        fields = [*(key[order] for key in keys), packed[order], (rows + lo)[order]]
    return counts, fields


def owner_verdicts(fields, limbs: int, step) -> torch.Tensor:
    """Step d: the verdict of each received row, first global position << 1
    | junction.  Takes the key limbs out of `fields` (class_verdicts frees
    them)."""
    keys = fields[:limbs]
    del fields[:limbs]
    packed, gpos = fields
    isj, first = construct.class_verdicts(keys, packed, step)
    return (gpos[first.long()] << 1) | isj.long()


def junction_rows(fields, verdict: torch.Tensor) -> torch.Tensor:
    """Step f on one shard: [m, 2] int64 rows (global position, first << 1
    | orientation) of its junctions, by position.  fields: its word and
    global position, rows in send order, as the verdicts came back."""
    packed, gpos = fields
    j = (verdict & 1) > 0
    pos, order = torch.sort(gpos[j])
    signed = ((verdict[j] >> 1) << 1) | ((packed[j] >> 11) & 1).long()
    return torch.stack([pos, signed[order]], 1)


def junctions_over(seqs: Sequence[np.ndarray], k: int, transport) -> List[JunctionChr]:
    """Steps a-f over `transport` (InProcess, or multihost.Distributed):
    the records of construct.build_junctions, the same on every process.

    Each step is a metrics stage that waits for the devices before it ends:
    graph_upload (the join and encode of the whole input, then once a
    local shard), graph_front_half, graph_shard_rows (each once a local
    shard), graph_exchange, graph_sort and graph_class_analysis (once an
    owner), graph_exchange_back, graph_gather_ids."""
    construct.check_k(k)
    if not seqs:
        return []
    lengths = [len(s) for s in seqs]
    bounds = shard_bounds(1 + sum(L + 1 for L in lengths), transport.n)
    devices = transport.devices
    check_shards_fit(bounds, transport.shards, devices, k)
    limbs = 1 if k <= kernels.ONE_LIMB_MAX_K else 2

    def step(name):
        return _step(name, devices)

    with step("graph_upload"):
        codes = joined_codes(seqs)
    sends = [local_rows(codes, bounds[s], bounds[s + 1], k, transport.n, dev, step)
             for s, dev in zip(transport.shards, devices)]
    del codes
    send_counts = [c for c, _f in sends]
    fields = [f for _c, f in sends]
    del sends
    recv_counts = transport.swap_counts(send_counts)
    for s, counts in zip(transport.shards, recv_counts):
        if sum(counts) > MAX_OWNER_ROWS:
            raise ValueError(f"shard {s} owns {sum(counts)} rows; class_verdicts' "
                             f"insertion ranks are int32 (at most {MAX_OWNER_ROWS})")
    with step("graph_exchange"):
        received = transport.exchange(send_counts, recv_counts, fields)
        for f in fields:
            del f[:limbs]  # each shard keeps its word and positions
    verdicts = [owner_verdicts(r, limbs, step) for r in received]
    del received
    with step("graph_exchange_back"):
        back = transport.exchange(recv_counts, send_counts, [[v] for v in verdicts])
        del verdicts
    with step("graph_gather_ids"):
        rows = transport.gather([junction_rows(f, b[0]) for f, b in zip(fields, back)])
        del fields, back
        gpos = rows[:, 0]
        signed = assign_ids(rows[:, 1] >> 1, (rows[:, 1] & 1) > 0)
    metrics.set("graph_positions", bounds[-1])
    metrics.set("graph_shards", transport.n)
    metrics.set("graph_junctions", len(gpos))
    return split_chromosomes(gpos, signed, lengths)


def build_junctions_sharded(seqs: Sequence[np.ndarray], k: int, devices=None
                            ) -> List[JunctionChr]:
    """construct.build_junctions over one shard per entry of `devices`, in
    this process (the counterpart of the JAX package's single-process
    mesh).  devices: a list of devices, which may repeat one ("cuda:0" four
    times, or "cpu" eight); None means every CUDA card there is, and raises
    where there is none.  k <= 61.  No streamed route: a shard that does not
    fit its device raises (check_shards_fit)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_junctions_sharded: no CUDA card; pass devices= "
                               "(e.g. ['cpu'] * 4) to run the shards on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if not devices:
        raise ValueError("build_junctions_sharded: an empty device list")
    return junctions_over(seqs, k, InProcess(devices))
