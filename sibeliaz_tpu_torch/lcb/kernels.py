"""The LCB walk's hand-written CUDA kernel and its plain version.

K5 `lcb_walk` (csrc/lcb_walk.cu) runs the walk of both device LCB engines
in one launch: for each walking lane, up to `limit` pushes from its
iterator (chr c, idx i, strand s) one junction on in its direction fwd,
toward its target vid tvid, until it gets there or overflows; each push is
PointPushBack/Front over the pushed vertex's occurrences, the score and
the snapshot maintenance (resident._push_score_snap).  One thread block
walks one lane, the lane's slab in shared memory, and nothing is read back
between pushes.  It computes what the `jax.lax.while_loop` of
sibeliaz_tpu/lcb/resident.py::_walk_device and fused.py::_walk_chunk
computes, with the occurrence `fori_loop` of
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

Both versions are out of place.  The kernel's output buffers are copies
of the input state's tensors, and it writes only those: the engines seed
with ResidentState(ln=ln, rw=ln, sn=ln), so the three slabs may share
tensors, and an update in place would write the rewind and result slabs
through the live one.

Besides the walk's results, each row reports its pushes and its
occurrence steps (the pushed vertices' occurrence counts, summed).  The
engines count `<engine>_pushes` as a call's largest row count, which is
the lockstep loop's pushes, and `<engine>_lane_occ_steps` as the sum over
its rows.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from sibeliaz_tpu_torch.graph.kernels import _route
from sibeliaz_tpu_torch.lcb.batched_push_device import (
    INSTANCE_FIELDS,
    LANE_FIELDS,
    DeviceTables,
    _clip,
    edge_of,
)
from sibeliaz_tpu_torch.lcb.resident import (
    ResidentState,
    _push_score_snap,
    _scatter_rows,
    _score_of,
    _state_from_leaves,
    _state_leaves,
)
from sibeliaz_tpu_torch.utils import cudabuild

LAUNCHES = {"lcb_walk": 0}

# the tables the kernel reads, in the order of its C interface
TABLE_FIELDS = ("chr_off", "chr_len", "jpos", "jid", "used_pfx", "used", "seq_off", "seq",
                "occ_off", "occ_chr", "occ_idx")
_BYTE_TABLES = ("used", "seq")
# the lane fields held as bool (one byte); the others are int64
_BOOL_FIELDS = ("ffin", "bfin", "overflow")


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
    fits = t.dim() == 1 if shape is None else tuple(t.shape) == tuple(shape)
    if t.dtype != dtype or not fits or not t.is_contiguous():
        want = "1-D" if shape is None else tuple(shape)
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {want}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _array(values) -> ctypes.Array:
    """A host array of int64 values (device pointers, lengths) for the C
    call; the caller keeps it alive through the call."""
    return (ctypes.c_longlong * len(values))(*values)


def lcb_walk(tb: DeviceTables, st: ResidentState, rows: Optional[torch.Tensor], c, i, s, fwd,
             tvid, active, last, m: int, b: int, flank: int, limit: int) -> Walk:
    """K5.  tb: the phase's tables; st: the lane state ([L, IC] instance
    slabs, [L, PC] path tables, [L] registers; rw and sn may share tensors
    with ln); rows: None, or [A] int64 lanes (distinct below L, sentinels
    at L or more); c, i, s, tvid: [A] int64; fwd, active, last: [A] bool;
    limit: the most pushes a row makes.  Returns a Walk; the input state is
    not written."""
    leaves = _state_leaves(st)
    per_row = [c, i, s, fwd, tvid, active, last] + ([] if rows is None else [rows])
    tables = [getattr(tb, f) for f in TABLE_FIELDS]
    kind = _route(*leaves, *per_row, *tables)
    if kind == "cpu":
        return lcb_walk_plain(tb, st, rows, c, i, s, fwd, tvid, active, last, m, b, flank, limit)
    L, IC = st.ln.chr.shape
    PC = st.ln.pvid.shape[1]
    A = L if rows is None else rows.shape[0]
    for q, slab in enumerate(("ln", "rw", "sn")):
        for f, t in zip(LANE_FIELDS, leaves[q * len(LANE_FIELDS):(q + 1) * len(LANE_FIELDS)]):
            width = IC if f in INSTANCE_FIELDS else PC if f in ("pvid", "pdist") else None
            _require(t, torch.bool if f in _BOOL_FIELDS else torch.int64,
                     (L,) if width is None else (L, width), f"{slab}.{f}")
    _require(st.best_score, torch.int64, (L,), "best_score")
    _require(st.has_snap, torch.bool, (L,), "has_snap")
    for name, t in zip(("c", "i", "s", "fwd", "tvid", "active", "last"), per_row):
        _require(t, torch.bool if name in ("fwd", "active", "last") else torch.int64, (A,), name)
    if rows is not None:
        _require(rows, torch.int64, (A,), "rows")
    for f, t in zip(TABLE_FIELDS, tables):
        _require(t, torch.uint8 if f in _BYTE_TABLES else torch.int64, None, f"tables.{f}")
    if tb.jpos.shape != tb.jid.shape or tb.occ_chr.shape != tb.occ_idx.shape:
        raise ValueError("jpos and jid, and occ_chr and occ_idx, must be of one length each")
    if limit < 0:
        raise ValueError(f"limit must be >= 0, got {limit}")
    with torch.cuda.device(c.device):
        out = [x.clone() for x in leaves]
        res = torch.empty((len(Walk._fields) - 1, A), dtype=torch.int64, device=c.device)
        if A:
            launch_into(tb, st, rows, c, i, s, fwd, tvid, active, last, m, b, flank, limit,
                        out, res)
    bools = {"last", "at_target", "overflow"}
    return Walk(_state_from_leaves(out), *(
        res[q].bool() if name in bools else res[q]
        for q, name in enumerate(Walk._fields[1:])))


def launch_into(tb: DeviceTables, st: ResidentState, rows, c, i, s, fwd, tvid, active, last,
                m: int, b: int, flank: int, limit: int, out, res) -> None:
    """Launches K5 on arguments lcb_walk has checked (A >= 1 rows), into
    `out` (the state's tensors, each a copy of its input, in
    resident._state_leaves order) and `res` ([10, A] int64, the per-row
    results in Walk's order).  Given the same inputs and fresh copies, a
    launch writes the same values, so a timing loop may launch again into
    the same buffers (chip_smoke.py's K5 times)."""
    L, IC = st.ln.chr.shape
    tables = [getattr(tb, f) for f in TABLE_FIELDS]
    lens = [tb.chr_off.shape[0], tb.chr_len.shape[0], tb.jid.shape[0], tb.used_pfx.shape[0],
            tb.used.shape[0], tb.seq_off.shape[0], tb.seq.shape[0], tb.occ_off.shape[0],
            tb.occ_chr.shape[0]]
    arrays = [_array([x.data_ptr() for x in group])
              for group in (_state_leaves(st), out, tables)]
    arrays += [_array(lens), _array([0 if rows is None else rows.data_ptr()]
                                    + [x.data_ptr() for x in (c, i, s, fwd, tvid, active, last)])]
    dev = c.device
    with torch.cuda.device(dev):
        status = cudabuild.load().sz_lcb_walk(
            *(ctypes.cast(a, ctypes.c_void_p) for a in arrays),
            ctypes.c_void_p(res.data_ptr()), L, res.shape[1], IC, st.ln.pvid.shape[1], tb.k, m,
            b, flank, limit, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if status != 0:
        raise RuntimeError(f"lcb_walk launch failed: CUDA error {status}")
    LAUNCHES["lcb_walk"] += 1


def chain_probe(table: torch.Tensor, iters: int) -> torch.Tensor:
    """Launches K5's chain probe: `iters` steps of four dependent loads
    from L2 (a pointer chase over `table`, int64 indices into itself) and
    one barrier of a walk block's threads, the least one occurrence step
    of the walk can cost.  The caller times it (chip_smoke.py's chain
    floor).  Returns the chase's last index."""
    _require(table, torch.int64, None, "table")
    out = torch.empty(1, dtype=torch.int64, device=table.device)
    with torch.cuda.device(table.device):
        status = cudabuild.load().sz_lcb_chain_probe(
            ctypes.c_void_p(table.data_ptr()), iters, ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(table.device).cuda_stream))
    if status != 0:
        raise RuntimeError(f"chain probe launch failed: CUDA error {status}")
    return out
