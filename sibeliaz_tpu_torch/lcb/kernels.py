"""The LCB walk's and the LCB vote's hand-written CUDA kernels and their
plain versions.

K5 `lcb_walk` (csrc/lcb_walk.cu) runs the walk of both device LCB engines
in one launch: for each walking lane, up to `limit` pushes from its
iterator (chr c, idx i, strand s) one junction on in its direction fwd,
toward its target vid tvid, until it gets there or overflows; each push is
PointPushBack/Front over the pushed vertex's occurrences, the score and
the snapshot maintenance (batched_push_device._push_score_snap).  One
thread block walks one lane, the lane's slab in shared memory, and
nothing is read back between pushes.  It computes what the
`jax.lax.while_loop` of sibeliaz_tpu/lcb/resident.py::_walk_device and
fused.py::_walk_chunk computes, with the occurrence `fori_loop` of
batched_push_device._push_impl_traced inside each push.

The wrapper routes by the device of the tensors it is given: a CPU tensor
goes to the plain PyTorch version beside it, a CUDA tensor launches the
kernel (or raises) with its device made current (torch.cuda.device),
anything else raises.  The plain version is the lockstep loop the engines
ran from the host before the kernel: each push reads (any lane active,
the largest occurrence count of an active lane's pushed vertex) from the
device, and its occurrence loop is a host loop of torch ops.  It is the
CPU path of both engines and the spec the kernel is tested against.
Lanes never read each other and a lane past its own occurrence count, or
not active, is left as it was, so the lockstep walk of L lanes equals
each lane walked alone: the kernel's one block a lane rests on that.
LAUNCHES counts kernel launches; the plain version does not count.

On the card the state is walked in place: the kernel writes the walked
rows of ln, rw, sn, best_score and has_snap into the tensors it was
given, and the call allocates only its [10, A] results.  So no two of the
state's 68 tensors may overlap (the wrapper refuses such a state before
it launches, from the tensors' data pointers and sizes), and both engines
seed the three slabs as tensors of their own (`seed_state`).  The plain
version stays out of place, so on the CPU the slabs may share tensors.

Besides the walk's results, each row reports its pushes and its
occurrence steps (the pushed vertices' occurrence counts, summed).  The
engines count `<engine>_pushes` as a call's largest row count, which is
the lockstep loop's pushes, and `<engine>_lane_occ_steps` as the sum over
its rows.

K6 `lcb_vote` (csrc/lcb_vote.cu) runs every vote call of both device LCB
engines in one launch: MostPopularVertex over the gathered lanes' instance
slabs (lcb/vote.py's vote_plain, the port of the JAX package's
resident.py::_vote_gathered), one thread block a row, and with `retry` the
fused engine's used-retry in the same launch (vote_retry_plain), so no
read of the card decides it.  It routes as K5 does; it reads the state
and writes only its [6, A] results.

K7 `lcb_step` (csrc/lcb_step.cu) runs the fused engine's outer step loop
for a set of lanes to its end in one launch: per lane, one block loops
K6's vote (with the used-retry), a K5 walk chunk, the protocol registers
and the forward->backward rewind until the lane is done or the step limit
(lcb/step.py's host loop, its plain version, on the CPU).  It writes the
carry (the state and the 13 CARRY_REGISTERS) in place, so no two of its
81 tensors may overlap, and its only allocation is its [STEP_ROWS, L]
per-lane results (LaneSteps' counts: its steps and the work they did,
counted in the block's shared memory); it reads nothing of the card.  Each block keeps its lane's live
slab and its vote's region in shared memory for the whole launch, so a
tier whose slab and vote do not fit the 227 KB a block may opt in to is
refused before the launch.  A build with STAMP_DEFINES (chip_smoke.py
--step's) also writes each lane's split of its steps (STAMP_PARTS) where
step_launch_into is given `stamps`.

K8 `lcb_seed` (csrc/lcb_seed.cu) seeds one lane set of the fused engine
in one launch: per lane, a block gathers the origin vertex's occurrence
window, filters it (the used slots, the annotation char) and compacts the
survivors, and writes K7's whole starting carry: the live, rewind and
result slabs each the seeded lane, the best scores, the snapshot flags and
the 13 registers, with `active` and the seed-overflow row computed on the
card.  Its outputs are disjoint views of one allocation (which holds the
lanes' [2, L] arguments too, uploaded from a pinned host buffer without a
wait; `SeedOutputs`, which the fused engine keeps one a shape for a run
and K8 writes again), so K7's overlap check passes them; nothing is read
back.  Its plain version is lcb/step.py's `lcb_seed_plain`, the engine's
seeding before K8 (resident._seed_lanes_device_impl, seed_state,
init_carry).  It routes by the device of the tables, as K7 does.  Each
launch adds one to LAUNCHES["lcb_seed"] and to utils/metrics' counter
`k8_launches`.

The wrappers check every tensor they pass to the card: its device, type,
shape and contiguity (and K5 and K7 the state's overlaps).  The tables'
checks run once per DeviceTables object, which the engines build once a
phase (`_table_check`, kept on the object; a replaced table tensor is
checked again); the lanes, the state and the arguments are checked every
call.  K8's tables are checked once per DeviceTables object too
(`_seed_tables`).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from sibeliaz_tpu_torch.lcb.batched_push_device import (
    INSTANCE_FIELDS,
    LANE_FIELDS,
    DeviceLanes,
    DeviceTables,
    ResidentState,
    _clip,
    _push_score_snap,
    _scatter_rows,
    _score_of,
    _state_from_leaves,
    _state_leaves,
    edge_of,
)
from sibeliaz_tpu_torch.lcb.vote import vote_columns, vote_plain, vote_retry_plain
from sibeliaz_tpu_torch.utils import cudabuild
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

LAUNCHES = {"lcb_walk": 0, "lcb_vote": 0, "lcb_step": 0, "lcb_seed": 0}

# the tables the kernel reads, in the order of its C interface
TABLE_FIELDS = ("chr_off", "chr_len", "jpos", "jid", "used_pfx", "used", "seq_off", "seq",
                "occ_off", "occ_chr", "occ_idx")
_BYTE_TABLES = ("used", "seq")
# the lane fields held as bool (one byte); the others are int64
_BOOL_FIELDS = ("ffin", "bfin", "overflow")
# the protocol registers of the fused engine's carry, after its
# ResidentState "st", in the order of K7's C interface; [L] each, bool where
# _BOOL_REGISTERS says, else int64
CARRY_REGISTERS = ("stage", "positive", "prev_len", "score", "active", "retier", "hostfb",
                   "in_walk", "wc", "wi", "ws", "wt", "wlast")
_BOOL_REGISTERS = ("positive", "active", "retier", "hostfb", "in_walk", "wlast")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class Walk(NamedTuple):
    """A walk call's result: the state, and per row (lane rows[r], or lane
    r without rows) the iterator's index after the walk, the last push's
    success (`last` as given where no push ran), whether the iterator
    stands on the target, the final lane's score, instance count, flanks
    and overflow flag, and the row's pushes and occurrence steps."""

    st: ResidentState
    i: torch.Tensor
    last: torch.Tensor
    at_target: torch.Tensor
    score: torch.Tensor
    n: torch.Tensor
    right_flank: torch.Tensor
    left_flank: torch.Tensor
    overflow: torch.Tensor
    pushes: torch.Tensor
    occ_steps: torch.Tensor


def lcb_walk_plain(tb: DeviceTables, st: ResidentState, rows: Optional[torch.Tensor], c, i, s,
                   fwd, tvid, active, last, m: int, b: int, flank: int, limit: int) -> Walk:
    """Plain PyTorch K5: up to `limit` lockstep pushes of the active rows.
    `rows` [A] names the lanes walked (a row index of L or more is a
    sentinel: it reads lane L-1, is never active and is dropped on the way
    back, JAX's `mode="drop"`); None walks every lane in order.  Each push
    reads (any row active, the largest occurrence count of an active row's
    pushed vertex) in one read of the device; an iteration with no active
    row does not run."""
    L = st.ln.chr.shape[0]
    work = st
    if rows is not None:
        take = _clip(rows, L - 1)
        work = _state_from_leaves([x.index_select(0, take) for x in _state_leaves(st)])
        active = active & (rows < L)
    nj = tb.jid.shape[0] - 1
    base = tb.chr_off[_clip(c, tb.chr_off.shape[0] - 2)]

    def vid_at(i):
        return s * tb.jid[_clip(base + i, nj)]

    active = active & (vid_at(i) != tvid)
    pushes = torch.zeros_like(i)
    occ_steps = torch.zeros_like(i)
    for _ in range(limit):
        eu, ev, ech, _, elen = edge_of(tb, c, i, s, fwd)
        av = torch.where(fwd, ev, eu).abs()
        occ_cnt = (tb.occ_off[_clip(av + 1, tb.occ_off.shape[0] - 1)]
                   - tb.occ_off[_clip(av, tb.occ_off.shape[0] - 2)])
        occ_active = torch.where(active, occ_cnt, 0)
        go, mo = torch.stack([active.any().long(), occ_active.max()]).tolist()
        if not go:
            break
        pushes = pushes + active.long()
        occ_steps = occ_steps + occ_active
        work, success, _, _, _, ovf = _push_score_snap(
            mo, fwd, tb, work, eu, ev, ech, elen, active, m, b, flank)
        i = torch.where(active, i + torch.where(fwd, s, -s), i)
        last = torch.where(active, success, last)
        active = active & (vid_at(i) != tvid) & ~ovf
    ln = work.ln
    if rows is not None:
        work = _state_from_leaves([_scatter_rows(full, rows, w) for full, w in
                                   zip(_state_leaves(st), _state_leaves(work))])
    return Walk(work, i, last, vid_at(i) == tvid, _score_of(tb, ln, flank), ln.n,
                ln.right_flank, ln.left_flank, ln.overflow, pushes, occ_steps)


def _require(t: torch.Tensor, dtype: torch.dtype, shape, name: str) -> None:
    """Raise unless t is a contiguous `dtype` tensor of `shape` (None: any
    1-D shape)."""
    fits = t.dim() == 1 if shape is None else t.shape == shape
    if t.dtype != dtype or not fits or not t.is_contiguous():
        want = "1-D" if shape is None else tuple(shape)
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {want}, "
                         f"got {t.dtype} {tuple(t.shape)}")


class _TableCheck(NamedTuple):
    """What a DeviceTables object's checks found, kept on the object: its
    tensors when checked (held, so their storage outlives the check), their
    one device, and (once checked for a launch) their pointers and lengths
    for the C calls."""

    tables: tuple
    device: torch.device
    launchable: bool = False
    ptrs: Optional[ctypes.Array] = None
    lens: tuple = ()


def _table_check(tb: DeviceTables, launch: bool) -> _TableCheck:
    """The checks of tb's TABLE_FIELDS, run once per DeviceTables object
    (again only where one of its tensors was replaced): one device (for
    routing), and with `launch` each table's type, 1-D contiguity and the
    paired lengths.  Both kernels read these tables; the engines build a
    DeviceTables once a phase."""
    tables = tuple(getattr(tb, f) for f in TABLE_FIELDS)
    got = tb.__dict__.get("_kernel_tables")
    if got is None or any(a is not b for a, b in zip(got.tables, tables)):
        devices = {t.device for t in tables}
        if len(devices) != 1:
            raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
        got = _TableCheck(tables, devices.pop())
    if launch and not got.launchable:
        for f, t in zip(TABLE_FIELDS, tables):
            _require(t, torch.uint8 if f in _BYTE_TABLES else torch.int64, None, f"tables.{f}")
            if not t.shape[0]:
                raise ValueError(f"tables.{f} is empty")
        if tb.jpos.shape != tb.jid.shape or tb.occ_chr.shape != tb.occ_idx.shape:
            raise ValueError("jpos and jid, and occ_chr and occ_idx, must be of one length each")
        got = got._replace(launchable=True, ptrs=_array([t.data_ptr() for t in tables]),
                           lens=tuple(t.shape[0] for t in tables))
    tb.__dict__["_kernel_tables"] = got
    return got


def _routed(tb: DeviceTables, tensors, specs):
    """(the one device of tb's tables and `tensors`, tb's checks): raises
    for tensors on several devices, or on a device other than the CPU and
    a CUDA card.  On a CUDA device tb's tables are checked for a launch,
    and each tensor against its spec (dtype, shape, name) and for
    contiguity, in the same pass."""
    got = _table_check(tb, False)
    dev = got.device
    if dev.type == "cuda":
        got = _table_check(tb, True)
        for t, (dtype, shape, name) in zip(tensors, specs):
            if t.device != dev:
                _several(dev, tensors)
            if t.dtype != dtype or t.shape != shape or not t.is_contiguous():
                _require(t, dtype, shape, name)
        return dev, got
    for t in tensors:
        if t.device != dev:
            _several(dev, tensors)
    if dev.type != "cpu":
        raise ValueError(f"no kernel for device type {dev.type!r}")
    return dev, got


def _several(dev: torch.device, tensors) -> None:
    devices = {dev} | {x.device for x in tensors}
    raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")


def _state_specs(L: int, IC: int, PC: int) -> list:
    """The specs of the state's 68 leaves."""
    specs = []
    for slab in ("ln", "rw", "sn"):
        for f in LANE_FIELDS:
            width = IC if f in INSTANCE_FIELDS else PC if f in ("pvid", "pdist") else None
            specs.append((torch.bool if f in _BOOL_FIELDS else torch.int64,
                          torch.Size((L,) if width is None else (L, width)), f"{slab}.{f}"))
    return specs + [(torch.int64, torch.Size((L,)), "best_score"),
                    (torch.bool, torch.Size((L,)), "has_snap")]


def _walk_specs(L: int, IC: int, PC: int, A: int, rows: bool) -> tuple:
    """K5's per-call specs: the state's 68 leaves, then c, i, s, fwd, tvid,
    active, last (and rows)."""
    specs = _state_specs(L, IC, PC)
    names = ("c", "i", "s", "fwd", "tvid", "active", "last") + (("rows",) if rows else ())
    specs += [(torch.bool if name in ("fwd", "active", "last") else torch.int64,
               torch.Size((A,)), name) for name in names]
    return tuple(specs)


def overlapping(leaves, others=()):
    """The first pair (a, b) of tensors that overlap in memory, where a is
    a state leaf and b another leaf or, numbered past the leaves, one of
    `others` (read-only inputs, which may overlap each other); None where
    none does.  From data pointers and sizes alone: it reads no tensor."""
    def span(t):
        n = t.numel() * t.element_size()
        return (t.data_ptr(), t.data_ptr() + n) if n else None

    spans = sorted((s[0], s[1], q) for q, s in enumerate(map(span, leaves)) if s)
    for (_, end, a), (start, _, b) in zip(spans, spans[1:]):
        if start < end:
            return min(a, b), max(a, b)
    for b, s in enumerate(map(span, others)):
        for lo, hi, a in spans if s else ():
            if s[0] < hi and lo < s[1]:
                return a, len(leaves) + b
    return None


def _array(values) -> ctypes.Array:
    """A host array of int64 values (device pointers, lengths) for the C
    call; the caller keeps it alive through the call."""
    return (ctypes.c_longlong * len(values))(*values)


def lcb_walk(tb: DeviceTables, st: ResidentState, rows: Optional[torch.Tensor], c, i, s, fwd,
             tvid, active, last, m: int, b: int, flank: int, limit: int) -> Walk:
    """K5.  tb: the phase's tables; st: the lane state ([L, IC] instance
    slabs, [L, PC] path tables, [L] registers); rows: None, or [A] int64
    lanes (distinct below L, sentinels at L or more); c, i, s, tvid: [A]
    int64; fwd, active, last: [A] bool; limit: the most pushes a row makes.
    Returns a Walk.  On CUDA tensors the walk writes st in place (no two of
    its tensors may overlap, nor any input overlap one of them) and the
    Walk's state is st's own tensors; on CPU tensors st is not written and
    its slabs may share tensors.  The tables are checked once per
    DeviceTables object, the state and the arguments every call."""
    leaves = _state_leaves(st)
    per_row = [c, i, s, fwd, tvid, active, last] + ([] if rows is None else [rows])
    L, IC = st.ln.chr.shape
    PC = st.ln.pvid.shape[1]
    A = L if rows is None else rows.shape[0]
    dev, tcheck = _routed(tb, leaves + per_row, _walk_specs(L, IC, PC, A, rows is not None))
    if dev.type == "cpu":
        return lcb_walk_plain(tb, st, rows, c, i, s, fwd, tvid, active, last, m, b, flank, limit)
    if limit < 0:
        raise ValueError(f"limit must be >= 0, got {limit}")
    pair = overlapping(leaves, per_row + list(tcheck.tables))
    if pair is not None:
        names = _leaf_names() + [f"argument {q}" for q in range(len(per_row))] + [
            f"tables.{f}" for f in TABLE_FIELDS]
        raise ValueError(f"lcb_walk writes the state in place: {names[pair[0]]} overlaps "
                         f"{names[pair[1]]} (give each of the state's tensors its own "
                         "storage, as seed_state does)")
    with torch.cuda.device(dev):
        res = torch.empty((len(Walk._fields) - 1, A), dtype=torch.int64, device=dev)
        if A:
            _launch_walk(tcheck, st, rows, c, i, s, fwd, tvid, active, last, tb.k, m, b, flank,
                         limit, res)
    # the kernel writes last, at_target and overflow as bytes at the start
    # of their rows: views, no copies
    bools = {"last", "at_target", "overflow"}
    return Walk(st, *(
        res[q].view(torch.uint8)[:A].view(torch.bool) if name in bools else res[q]
        for q, name in enumerate(Walk._fields[1:])))


def _leaf_names() -> list:
    return [f"{slab}.{f}" for slab in ("ln", "rw", "sn") for f in LANE_FIELDS] + [
        "best_score", "has_snap"]


def launch_into(tb: DeviceTables, st: ResidentState, rows, c, i, s, fwd, tvid, active, last,
                m: int, b: int, flank: int, limit: int, res) -> None:
    """Launches K5 on arguments lcb_walk has checked (A >= 1 rows), walking
    st in place, into `res` ([10, A] int64, the per-row results in Walk's
    order; last, at_target and overflow as bytes at the start of their
    rows).  A launch from the same state writes the same values, so a
    timing loop restores the state before each launch (chip_smoke.py's K5
    times)."""
    _launch_walk(_table_check(tb, True), st, rows, c, i, s, fwd, tvid, active, last, tb.k, m,
                 b, flank, limit, res)


def _launch_walk(tcheck: _TableCheck, st: ResidentState, rows, c, i, s, fwd, tvid, active,
                 last, k: int, m: int, b: int, flank: int, limit: int, res) -> None:
    L, IC = st.ln.chr.shape
    lens = tcheck.lens
    # the C interface's lengths: chr_off, chr_len, jpos = jid, used_pfx,
    # used, seq_off, seq, occ_off, occ_chr = occ_idx
    arrays = [_array([x.data_ptr() for x in _state_leaves(st)]), tcheck.ptrs,
              _array(lens[:3] + lens[4:10]),
              _array([0 if rows is None else rows.data_ptr()]
                     + [x.data_ptr() for x in (c, i, s, fwd, tvid, active, last)])]
    dev = c.device
    with torch.cuda.device(dev):
        status = cudabuild.load().sz_lcb_walk(
            *(ctypes.cast(a, ctypes.c_void_p) for a in arrays),
            ctypes.c_void_p(res.data_ptr()), L, res.shape[1], IC, st.ln.pvid.shape[1], k, m,
            b, flank, limit, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if status != 0:
        raise RuntimeError(f"lcb_walk launch failed: CUDA error {status}")
    LAUNCHES["lcb_walk"] += 1


# ---- K6 lcb_vote ------------------------------------------------------------

# the lane fields the vote reads, in the order of its C interface
VOTE_LANE_FIELDS = ("chr", "s", "fi", "bi", "good_seq", "insert_seq", "n", "pvid", "pn", "rv",
                    "lv")
# the tables it reads, and the lengths it takes (jid's is jpos's), in the
# order of its C interface
VOTE_TABLE_FIELDS = ("chr_off", "chr_len", "jpos", "jid", "used")
_VOTE_TABLES = tuple(TABLE_FIELDS.index(f) for f in VOTE_TABLE_FIELDS)
_VOTE_LENS = tuple(TABLE_FIELDS.index(f) for f in ("chr_off", "chr_len", "jpos", "used"))
# the vote's spill workspace, a device's: _VOTE_LOCKS lock words (zero
# between calls; csrc/lcb_vote.cu's kMaxPool), then VOTE_POOL slices, each
# of the call's sz_lcb_vote_workspace_words; grown where a call's slices
# are larger, never shrunk
_WORKSPACE = {}
_VOTE_LOCKS = 64
VOTE_POOL = 8


def _vote_specs(L: int, IC: int, PC: int, A: int) -> tuple:
    """K6's per-call specs: the lane fields it reads, then idx, valid,
    forward, try_used and (where given) spilled."""
    shapes = {"pvid": (L, PC), "n": (L,), "pn": (L,), "rv": (L,), "lv": (L,)}
    specs = [(torch.int64, torch.Size(shapes.get(f, (L, IC))), f"ln.{f}")
             for f in VOTE_LANE_FIELDS]
    specs += [(torch.int64, torch.Size((A,)), "idx")] + [
        (torch.bool, torch.Size((A,)), name) for name in ("valid", "forward", "try_used")]
    return tuple(specs) + ((torch.int64, torch.Size((A,)), "spilled"),)


def _vote_workspace(dev: torch.device, words: int) -> torch.Tensor:
    """The device's vote workspace with room for `words` int64 past its
    lock words, which are zero: kept, and made anew (zeroed) only where a
    call needs more."""
    ws = _WORKSPACE.get(dev)
    if ws is None or ws.numel() < _VOTE_LOCKS + words:
        ws = _WORKSPACE[dev] = torch.zeros(_VOTE_LOCKS + words, dtype=torch.int64, device=dev)
    return ws


def lcb_vote(CAP: int, W: int, tb: DeviceTables, ln: DeviceLanes, idx, valid, forward,
             try_used, depth: int, b: int, n_max=None, retry: bool = False, spilled=None):
    """K6.  Vote for the gathered lanes idx ([A] int64, in [0, L); rows may
    repeat and come in any order) of ln ([L, IC] instance slabs, [L, PC]
    path tables): MostPopularVertex with per-row `forward` and `try_used`
    ([A] bool), invalid rows inert (lcb/vote.py's vote_plain).  `n_max`
    cuts the instance columns to the valid rows' largest count.  With
    `retry`, the fused engine's forward-only used-retry in the same call
    (vote_retry_plain).  Returns (best_vid, best_cnt, ochr, oidx, ostr,
    overflow), each [A] int64: on CUDA tensors the rows of one [6, A]
    tensor from one launch; on CPU tensors the plain version's.  The
    tables are checked once per DeviceTables object, the lanes and the
    arguments every call.  `spilled`, an [A] int64 tensor on the card,
    receives 1 where a row's vote outgrew the kernel's shared hash table
    and took the workspace (the CPU path leaves it as it is)."""
    lanes = [getattr(ln, f) for f in VOTE_LANE_FIELDS]
    per_row = [idx, valid, forward, try_used] + ([] if spilled is None else [spilled])
    L, IC = ln.chr.shape
    PC = ln.pvid.shape[1]
    A = idx.shape[0]
    dev, tcheck = _routed(tb, lanes + per_row, _vote_specs(L, IC, PC, A))
    if dev.type == "cpu":
        plain = vote_retry_plain if retry else vote_plain
        return plain(CAP, W, tb, ln, idx, valid, forward, try_used, depth, b, n_max)
    CAPx = vote_columns(CAP, IC, n_max)
    with torch.cuda.device(dev):
        out = torch.empty((6, A), dtype=torch.int64, device=dev)
        if A:
            _launch_vote(tcheck, ln, idx, valid, forward, try_used, CAPx, W, tb.k, depth, b,
                         retry, out, spilled)
    return tuple(out)


def _launch_vote(tcheck: _TableCheck, ln: DeviceLanes, idx, valid, forward, try_used,
                 CAPx: int, W: int, k: int, depth: int, b: int, retry: bool, out,
                 spilled=None) -> None:
    """Launches K6 on checked arguments (A >= 1 rows) into `out` ([6, A]
    int64), with the device's workspace where a row can spill: min(VOTE_POOL,
    A) slices, which the spilling rows take in turn."""
    L, IC = ln.chr.shape
    PC = ln.pvid.shape[1]
    A = idx.shape[0]
    lib = cudabuild.load()
    words = lib.sz_lcb_vote_workspace_words(PC, CAPx, W)
    if words < 0:
        raise ValueError(f"lcb_vote takes no call of CAP {CAPx}, W {W}, PC {PC} (CAP and W "
                         "at most 4,096, the block's shared memory at most 227 KB)")
    dev = idx.device
    pool = min(VOTE_POOL, A)
    ws = _vote_workspace(dev, words * pool) if words else None
    ptrs = tcheck.ptrs
    arrays = [_array([getattr(ln, f).data_ptr() for f in VOTE_LANE_FIELDS]),
              _array([ptrs[q] for q in _VOTE_TABLES]),
              _array([tcheck.lens[q] for q in _VOTE_LENS]),
              _array([x.data_ptr() for x in (idx, valid, forward, try_used)])]
    status = lib.sz_lcb_vote(
        *(ctypes.cast(a, ctypes.c_void_p) for a in arrays), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(0 if ws is None else ws.data_ptr()), pool,
        ctypes.c_void_p(0 if spilled is None else spilled.data_ptr()), L, A, IC, PC, CAPx, W,
        k, depth, b, int(retry), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if status != 0:
        raise RuntimeError(f"lcb_vote launch failed: CUDA error {status}")
    LAUNCHES["lcb_vote"] += 1


def vote_blocks_per_sm(PC: int, CAP: int, W: int, device="cuda") -> int:
    """The vote blocks an SM of `device` holds at once at PC, CAP, W."""
    with torch.cuda.device(device):
        got = cudabuild.load().sz_lcb_vote_blocks_per_sm(PC, CAP, W)
    if got < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-got}")
    return got


def chain_probe(table: torch.Tensor, iters: int, step: str = "warp") -> torch.Tensor:
    """Launches one of the chain probes, `iters` steps of a pointer chase
    over `table` (int64 indices into itself) served from L2: with step
    "warp", one load a step and a __syncwarp of a walk block's warp 0, the
    least one occurrence step of K5's walk can cost (its one round of table
    loads at the candidate's end); with "block", four dependent loads and a
    barrier of 256 threads, the step of K5's first design, in which thread
    0 ran each step and the block met twice a step; with "vote", the least
    one K6 vote can cost, a vote whose windows end in their first round
    (csrc/lcb_vote.cu's lcb_vote_probe_kernel: the columns' three dependent
    loads, a slot's load and path search, the hash insert, the winner's
    reduction and the vote's seven barriers).  The caller times it
    (chip_smoke.py's chain floors).  Returns the chase's last index."""
    _require(table, torch.int64, None, "table")
    fn = {"warp": "sz_lcb_step_probe", "block": "sz_lcb_chain_probe",
          "vote": "sz_lcb_vote_probe"}[step]
    out = torch.empty(1, dtype=torch.int64, device=table.device)
    with torch.cuda.device(table.device):
        status = getattr(cudabuild.load(), fn)(
            ctypes.c_void_p(table.data_ptr()), iters, ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(table.device).cuda_stream))
    if status != 0:
        raise RuntimeError(f"chain probe launch failed: CUDA error {status}")
    return out


def blocks_per_sm(IC: int, PC: int, device="cuda") -> int:
    """The walk blocks an SM of `device` holds at once at slab widths IC
    and PC (the CUDA occupancy calculator)."""
    with torch.cuda.device(device):
        got = cudabuild.load().sz_lcb_walk_blocks_per_sm(IC, PC)
    if got < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-got}")
    return got


# ---- K7 lcb_step -------------------------------------------------------------


class LaneSteps(NamedTuple):
    """A step call's result: the carry, its state and registers advanced
    and its "steps" as given (the run's step count is that plus the lanes'
    largest `steps`), and per lane [L] int64: the steps it took, its walk
    pushes, its occurrence steps (the pushed vertices' occurrence counts,
    summed), 1 where a vote took the spill workspace (the card only); the
    work of its steps: score terms (each walk chunk's pushes times the
    lane's instance count after it), voting instances, those at the lane's
    path end (a window each), evaluated window slots (a window's alive
    slots and the one that ends it, W at most) and alive window entries,
    each vote's (a retried vote's retry, whose windows are the longer);
    and 1 where the lane stepped and its best score rose (a rewind slab
    written), and rose above 0 (a result slab written)."""

    carry: dict
    steps: torch.Tensor
    pushes: torch.Tensor
    occ_steps: torch.Tensor
    spilled: torch.Tensor
    score_terms: torch.Tensor
    voters: torch.Tensor
    windows: torch.Tensor
    slots: torch.Tensor
    entries: torch.Tensor
    rose: torch.Tensor
    rose_positive: torch.Tensor


# the rows of K7's per-lane results, LaneSteps' after the carry
STEP_ROWS = len(LaneSteps._fields) - 1


def _step_specs(L: int, IC: int, PC: int) -> list:
    """K7's per-call specs: the state's 68 leaves, then the 13 registers."""
    return _state_specs(L, IC, PC) + [
        (torch.bool if r in _BOOL_REGISTERS else torch.int64, torch.Size((L,)), r)
        for r in CARRY_REGISTERS]


def lcb_step(CAP: int, W: int, slab_max: bool, tb: DeviceTables, carry, depth: int, m: int,
             b: int, flank: int, min_run: int, steps_limit: int, walk_chunk: int,
             compact_min: int) -> LaneSteps:
    """K7.  Step every lane of `carry` (the fused engine's: "st", a
    ResidentState of L lanes, [L, IC] instance slabs and [L, PC] path
    tables; the 13 CARRY_REGISTERS, [L] each; "steps", the step count) at
    the tier (CAP, W, slab_max) and protocol (depth, m, b, flank, min_run)
    until the lane is inactive or the step count reaches steps_limit, walks
    in chunks of walk_chunk pushes.  On CUDA tensors one launch that writes
    the carry's tensors in place (no two may overlap, nor a table overlap
    one of them) and reads nothing of the card; on CPU tensors the plain
    version (lcb/step.py), out of place, with compaction down to
    compact_min lanes.  Returns LaneSteps.  The tables are checked once
    per DeviceTables object, the carry every call."""
    st = carry["st"]
    leaves = _state_leaves(st)
    regs = [carry[r] for r in CARRY_REGISTERS]
    L, IC = st.ln.chr.shape
    PC = st.ln.pvid.shape[1]
    specs = _step_specs(L, IC, PC)
    dev, tcheck = _routed(tb, leaves + regs, specs)
    if dev.type == "cpu":  # the plain version takes what the kernel takes
        from sibeliaz_tpu_torch.lcb import step

        for t, (dtype, shape, name) in zip(leaves + regs, specs):
            _require(t, dtype, shape, name)

        return step.lcb_step_plain(CAP, W, slab_max, tb, carry, depth, m, b, flank, min_run,
                                   steps_limit, walk_chunk, compact_min)
    if CAP < 1 or W < 1 or walk_chunk < 0:
        raise ValueError(f"lcb_step takes CAP >= 1, W >= 1 and walk_chunk >= 0, got {CAP}, {W}, "
                         f"{walk_chunk}")
    _step_words(cudabuild.load(), IC, PC, CAP, W)
    pair = overlapping(leaves + regs, list(tcheck.tables))
    if pair is not None:
        names = _leaf_names() + list(CARRY_REGISTERS) + [f"tables.{f}" for f in TABLE_FIELDS]
        raise ValueError(f"lcb_step writes the carry in place: {names[pair[0]]} overlaps "
                         f"{names[pair[1]]} (give each of the carry's tensors its own storage, "
                         "as seed_state and init_carry do)")
    with torch.cuda.device(dev):
        out = torch.empty((STEP_ROWS, L), dtype=torch.int64, device=dev)
        _launch_step(tcheck, carry, CAP, W, slab_max, tb.k, depth, m, b, flank, min_run,
                     steps_limit, walk_chunk, out)
    return LaneSteps(carry, *out)


def step_launch_into(tb: DeviceTables, carry, CAP: int, W: int, slab_max: bool, depth: int,
                     m: int, b: int, flank: int, min_run: int, steps_limit: int,
                     walk_chunk: int, out, stamps=None) -> None:
    """Launches K7 on a carry lcb_step has checked, stepping it in place,
    into `out` ([STEP_ROWS, L] int64, LaneSteps' per-lane rows).  A launch from the
    same carry writes the same values, so a timing loop restores the carry
    before each launch (chip_smoke.py's K7 times).  With `stamps`
    ([STAMP_PARTS, L] int64) the stamped build launches instead and writes
    each lane's split of its steps there (csrc/step_stamps.cuh; only
    chip_smoke.py --step builds it)."""
    _launch_step(_table_check(tb, True), carry, CAP, W, slab_max, tb.k, depth, m, b, flank,
                 min_run, steps_limit, walk_chunk, out, stamps)


# csrc/step_stamps.cuh's parts of a step (cycles summed per lane), then its
# counts, in the order of a stamped launch's rows
STAMP_PARTS = ("vote_cols", "vote_windows", "vote_winner", "vote_retry", "walk_load",
               "walk_tails", "walk_pushes", "walk_scores", "walk_stores", "registers",
               "rewind", "total", "votes", "voters", "window_rounds", "retries", "walks",
               "block_scores", "walk_waits", "walk_occ", "walk_issue", "inserts",
               "block_shifts", "ns_start", "ns_end", "sm")
STAMP_DEFINES = ("SZ_STEP_STAMPS",)


def _step_words(lib, IC: int, PC: int, CAP: int, W: int) -> int:
    """The vote workspace's words a slice of a K7 launch at these shapes
    (csrc/lcb_step.cu's step_workspace_words); raises ValueError for a
    shape the kernel does not take: a lane's slab and vote region past the
    227 KB of shared memory a block may opt in to, or CAP or W past
    4,096."""
    words = lib.sz_lcb_step_workspace_words(IC, PC, CAP, W)
    if words < 0:
        raise ValueError(f"lcb_step keeps a lane's slab and vote in shared memory: IC {IC}, PC "
                         f"{PC}, CAP {CAP}, W {W} take more than the 232,448 bytes a block may "
                         "opt in to (or CAP or W is past 4,096)")
    return words


def _launch_step(tcheck: _TableCheck, carry, CAP: int, W: int, slab_max: bool, k: int,
                 depth: int, m: int, b: int, flank: int, min_run: int, steps_limit: int,
                 walk_chunk: int, out, stamps=None) -> None:
    """Launches K7 with the device's vote workspace where a vote can spill
    (min(VOTE_POOL, L) slices, as K6's); with `stamps`, the stamped
    build's K7."""
    st = carry["st"]
    L, IC = st.ln.chr.shape
    PC = st.ln.pvid.shape[1]
    lib = cudabuild.load(STAMP_DEFINES if stamps is not None else ())
    if lib.sz_lcb_step_result_rows() != STEP_ROWS:
        raise RuntimeError("the K7 build does not write LaneSteps' rows")
    if stamps is not None:
        if lib.sz_lcb_step_stamp_parts() != len(STAMP_PARTS):
            raise RuntimeError("the stamped K7 build does not have STAMP_PARTS' rows")
        _require(stamps, torch.int64, torch.Size((len(STAMP_PARTS), L)), "stamps")
    words = _step_words(lib, IC, PC, CAP, W)
    dev = st.ln.chr.device
    pool = min(VOTE_POOL, L)
    ws = _vote_workspace(dev, words * pool) if words else None
    lens = tcheck.lens
    arrays = [_array([x.data_ptr() for x in _state_leaves(st)]),
              _array([carry[r].data_ptr() for r in CARRY_REGISTERS]), tcheck.ptrs,
              _array(lens[:3] + lens[4:10])]
    status = lib.sz_lcb_step(
        *(ctypes.cast(a, ctypes.c_void_p) for a in arrays), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(0 if ws is None else ws.data_ptr()), pool, L, IC, PC, CAP, W, k,
        depth, m, b, flank, min_run, int(slab_max), carry["steps"], steps_limit, walk_chunk,
        ctypes.c_void_p(0 if stamps is None else stamps.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if status != 0:
        raise RuntimeError(f"lcb_step launch failed: CUDA error {status}")
    LAUNCHES["lcb_step"] += 1


def step_blocks_per_sm(IC: int, PC: int, CAP: int, W: int, layout: int = 1, device="cuda"):
    """(the step blocks an SM of `device` holds at once, the dynamic shared
    bytes a block takes) at IC, PC, CAP, W in shared-memory layout
    `layout`: 1, the kernel's, the slab resident beside the vote's region;
    0, PR 20's, the vote's region and the walk's slab taking the same bytes
    in turn."""
    smem = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        got = cudabuild.load().sz_lcb_step_blocks_per_sm(
            IC, PC, CAP, W, layout, ctypes.cast(ctypes.pointer(smem), ctypes.c_void_p))
    if got < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-got}")
    return got, smem.value


# ---- K8 lcb_seed -------------------------------------------------------------

# the tables K8 reads, in the order of its C interface
SEED_TABLE_FIELDS = ("occ_off", "occ_chr", "occ_idx", "occ_ch", "occ_revch", "chr_off", "jid",
                     "used")
_SEED_BYTE_TABLES = ("occ_ch", "occ_revch", "used")
# K8's allocation: every region starts on this many bytes
_SEED_ALIGN = 256
# a device's pinned host buffer of the lanes' arguments (and its numpy
# view) and the event of its last upload
_SEED_HOST = {}
# a card's private memory pool for K8's outputs: freed at a run's end,
# their blocks stay out of the card's common cache, where an allocation of
# a later stage (the next pass's graph stage) could take one whole and
# count its slack past the request as allocated
_SEED_POOLS = {}


class _SeedTables(NamedTuple):
    """What a DeviceTables object's K8 checks found, kept on the object:
    its SEED_TABLE_FIELDS tensors, their one device and, on a card, their
    pointers and lengths for the C call."""

    tables: tuple
    device: torch.device
    ptrs: Optional[ctypes.Array] = None
    lens: Optional[ctypes.Array] = None


def _seed_tables(tb: DeviceTables) -> _SeedTables:
    """K8's checks of tb's SEED_TABLE_FIELDS, run once per DeviceTables
    object (again only where one of its tensors was replaced): one device
    (for routing), and on a card each table's type, 1-D contiguity and
    length, the occurrence tables of one length."""
    tables = tuple(getattr(tb, f) for f in SEED_TABLE_FIELDS)
    got = tb.__dict__.get("_seed_tables")
    if got is not None and all(a is b for a, b in zip(got.tables, tables)):
        return got
    devices = {t.device for t in tables}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    got = _SeedTables(tables, devices.pop())
    if got.device.type == "cuda":
        for f, t in zip(SEED_TABLE_FIELDS, tables):
            _require(t, torch.uint8 if f in _SEED_BYTE_TABLES else torch.int64, None, f"tables.{f}")
            if not t.shape[0]:
                raise ValueError(f"tables.{f} is empty")
        if any(getattr(tb, f).shape != tb.occ_chr.shape
               for f in ("occ_idx", "occ_ch", "occ_revch")):
            raise ValueError("occ_chr, occ_idx, occ_ch and occ_revch must be of one length")
        got = got._replace(ptrs=_array([t.data_ptr() for t in tables]),
                           lens=_array([t.shape[0] for t in tables]))
    elif got.device.type != "cpu":
        raise ValueError(f"no kernel for device type {got.device.type!r}")
    tb.__dict__["_seed_tables"] = got
    return got


class SeedPlan(NamedTuple):
    """K8's one allocation at (L, IC, PC): `nbytes` in all; the lanes'
    [2, L] int64 arguments at its start; its outputs (the carry's 81
    tensors in _step_specs' order, then the [L] bool seed-overflow row)
    grouped by type and shape into `regions` (byte offset, dtype, a
    tensor's shape, the outputs' numbers), each on _SEED_ALIGN bytes; each
    output's byte offset, in the C interface's order, in `offsets`."""

    nbytes: int
    regions: tuple
    offsets: ctypes.Array


@functools.lru_cache(maxsize=None)
def seed_plan(L: int, IC: int, PC: int) -> SeedPlan:
    """K8's allocation at (L, IC, PC), one layout a shape."""
    specs = _step_specs(L, IC, PC) + [(torch.bool, torch.Size((L,)), "ovf")]
    groups = {}
    for q, (dtype, shape, _) in enumerate(specs):
        groups.setdefault((dtype, shape), []).append(q)
    offset, regions, offsets = 16 * L, [], [0] * len(specs)
    for (dtype, shape), qs in groups.items():
        offset = -(-offset // _SEED_ALIGN) * _SEED_ALIGN
        size = shape.numel() * (1 if dtype == torch.bool else 8)
        regions.append((offset, dtype, shape, tuple(qs)))
        for k, q in enumerate(qs):
            offsets[q] = offset + k * size
        offset += size * len(qs)
    return SeedPlan(offset, tuple(regions), _array(offsets))


def _seed_pool(device: torch.device):
    """Allocations into the card's private pool for K8's outputs (made at
    its first use); on the CPU nothing."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    pool = _SEED_POOLS.get(device)
    if pool is None:
        pool = _SEED_POOLS[device] = torch.cuda.MemPool()
    return torch.cuda.use_mem_pool(pool, device)


class SeedOutputs:
    """K8's one allocation at (L, IC, PC) on `device` (seed_plan's layout)
    and its views, made once: the lanes' [2, L] int64 arguments (`args`),
    the carry (`carry`, steps 0) and the seed-overflow row (`ovf`), a view
    and an unbind a region.  lcb_seed makes one a call, or writes again
    the one it is given: the fused engine keeps one a shape for a run.  On
    a card the allocation comes from the card's private pool for K8
    (`_SEED_POOLS`)."""

    def __init__(self, L: int, IC: int, PC: int, device):
        self.shape = (L, IC, PC)
        self.plan = seed_plan(L, IC, PC)
        device = torch.device(device)
        with _seed_pool(device):
            self.buf = torch.empty(self.plan.nbytes, dtype=torch.uint8, device=device)
        self.args = self.buf[:16 * L].view(torch.int64)
        outs = [None] * len(self.plan.offsets)
        for offset, dtype, shape, qs in self.plan.regions:
            size = shape.numel() * (1 if dtype == torch.bool else 8)
            views = self.buf[offset:offset + size * len(qs)].view(dtype).view(len(qs), *shape)
            for q, x in zip(qs, views.unbind(0)):
                outs[q] = x
        n = len(outs) - len(CARRY_REGISTERS) - 1
        self.carry = dict(st=_state_from_leaves(outs[:n]),
                          **dict(zip(CARRY_REGISTERS, outs[n:-1])), steps=0)
        self.ovf = outs[-1]


def _upload_seeds(args: torch.Tensor, seeds: np.ndarray, L: int) -> None:
    """The lanes' [2, L] arguments (seeds' vids and out-chars, then zeros)
    into `args`, by one copy from the device's pinned host buffer that the
    host does not wait for.  The buffer is written again only once its
    last copy is done (the engine reads the card between two seedings, so
    it never waits here)."""
    host = _SEED_HOST.get(args.device)
    if host is None or host[0].numel() < 2 * L:
        pinned = torch.empty(2 * max(L, 256), dtype=torch.int64, pin_memory=True)
        host = _SEED_HOST[args.device] = (pinned, pinned.numpy(), torch.cuda.Event())
    pinned, arr, done = host
    if not done.query():
        done.synchronize()
    nb = len(seeds)
    lanes = arr[:2 * L].reshape(2, L)
    lanes[:, :nb] = seeds.T
    lanes[:, nb:] = 0
    args.copy_(pinned[:2 * L], non_blocking=True)
    done.record()


def lcb_seed(tb: DeviceTables, seeds, L: int, IC: int, PC: int,
             into: Optional[SeedOutputs] = None):
    """K8.  Seed L lanes at slab widths IC and PC: lane j < len(seeds) from
    seeds[j] ((signed origin vid, out-char), an [nb, 2] int64 array on the
    host), the others inert (vid 0).  Returns (carry, ovf): K7's starting
    carry, init_carry's (the live, rewind and result slabs each the seeded
    lanes, best scores 0, no snapshot, the 13 registers, steps 0) with the
    first nb lanes active unless their origin's occurrence count passes IC,
    and ovf ([L] bool) the lanes whose count passes it.  On CUDA tables one
    copy of the [2, L] arguments and one launch, the carry's tensors and
    ovf disjoint views of one allocation (SeedOutputs): a new one, or
    `into`, one of this shape on the tables' card, which is written again
    (whatever still reads its views sees the new lanes); nothing is read
    back.  On CPU tables the plain version (step.lcb_seed_plain), which
    takes no `into`.  The tables are checked once per DeviceTables
    object."""
    seeds = np.asarray(seeds, dtype=np.int64).reshape(-1, 2)
    nb = len(seeds)
    if not 0 <= nb <= L or IC < 1 or PC < 1:
        raise ValueError(f"lcb_seed takes at most L seeds and IC, PC >= 1, got {nb} seeds, L {L}, "
                         f"IC {IC}, PC {PC}")
    got = _seed_tables(tb)
    if got.device.type == "cpu":
        if into is not None:
            raise ValueError("lcb_seed's plain version writes no SeedOutputs")
        from sibeliaz_tpu_torch.lcb import step

        lanes = torch.zeros((2, L), dtype=torch.int64)
        lanes[:, :nb] = torch.from_numpy(seeds.T)
        return step.lcb_seed_plain(tb, lanes, nb, IC, PC)
    if into is not None and (into.shape != (L, IC, PC) or into.buf.device != got.device):
        raise ValueError(f"lcb_seed into outputs of shape {into.shape} on {into.buf.device}, "
                         f"not ({L}, {IC}, {PC}) on {got.device}")
    lib = cudabuild.load()
    if lib.sz_lcb_seed_smem(IC) < 0:
        raise ValueError(f"lcb_seed compacts a lane's window in shared memory: IC {IC} takes "
                         "more than the 232,448 bytes a block may opt in to")
    with torch.cuda.device(got.device):
        if into is None:
            into = SeedOutputs(L, IC, PC, got.device)
        _upload_seeds(into.args, seeds, L)
        _launch_seed(lib, got, into, nb)
    return dict(into.carry), into.ovf


def seed_launch_into(tb: DeviceTables, out: SeedOutputs, nb: int) -> None:
    """Launches K8 into `out` (on the tables' card, the lanes' arguments
    already in its `args`): chip_smoke.py's K8 times."""
    _launch_seed(cudabuild.load(), _seed_tables(tb), out, nb)


def _launch_seed(lib, got: _SeedTables, out: SeedOutputs, nb: int) -> None:
    if lib.sz_lcb_seed_outputs() != len(out.plan.offsets):
        raise RuntimeError("the K8 build does not write seed_plan's outputs")
    L, IC, PC = out.shape
    dev = out.buf.device
    status = lib.sz_lcb_seed(
        ctypes.c_void_p(out.buf.data_ptr()), ctypes.cast(out.plan.offsets, ctypes.c_void_p), nb,
        L, IC, PC, ctypes.cast(got.ptrs, ctypes.c_void_p), ctypes.cast(got.lens, ctypes.c_void_p),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if status != 0:
        raise RuntimeError(f"lcb_seed launch failed: CUDA error {status}")
    LAUNCHES["lcb_seed"] += 1
    metrics.count("k8_launches")
