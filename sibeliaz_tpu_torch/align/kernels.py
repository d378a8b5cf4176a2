"""The alignment stage's hand-written CUDA kernel and its plain version.

K3 `poa_dp_tb` (csrc/poa_dp_tb.cu) runs the device POA engine's banded
sequence-vs-DAG DP and its traceback for a batch of blocks: a pre-pass
that lays each rank's metadata out as one record, the DP with one thread
block per POA block and the topological ranks in a loop inside it, and the
traceback with one warp per block.  It takes and returns what
`_dp_tb_batch` of sibeliaz_tpu/align/tpu_poa.py does.

The wrapper routes by the device of the tensors it is given: a CPU tensor
goes to the plain PyTorch version beside it, a CUDA tensor launches the
kernel (or raises) with its device made current (torch.cuda.device),
anything else raises.  The plain version is the CPU
path of the device engine and the spec the kernel is tested against.
LAUNCHES counts kernel launches; the plain version does not count.

Inputs, per block b of the batch (all from device_poa.pack_round):
  seq0p     [B, L+1+W] uint8  the sequence shifted by one (row i is
                              seq0p[i] = seq[i-1]), zero-padded so every
                              window slice stays in range
  seq_len   [B] int32
  node_char [B, n_max] uint8  character of each topological rank
  pred_idx  [B, n_max, 8] int32  predecessor ranks; n_max = the virtual source
  pred_ok   [B, n_max, 8] bool
  sink_mask [B, n_max] bool
  off       [B, n_max+1] int32   first sequence row of each rank's window
Rank r computes sequence rows [off[r], off[r] + W).  Predecessors have
lower ranks than their successors (a topological order).  The ranks past
the last one with any predecessor are padding: they are not computed and
are never sinks.  Outputs: out_r, out_i [B, P] int32, the traceback's
(rank, sequence position) pairs from the sink back to the source (-1 for
a gap and past the end), tcount [B] int32, the pairs written, and
best_sc [B] int32, the score at the chosen sink.
"""

from __future__ import annotations

import ctypes

import torch

from sibeliaz_tpu_torch.utils import cudabuild

MAX_PREDS = 8
NEG = -(2**29)
MATCH, MISMATCH, GAP = 5, -4, -8  # poa_ref.py scores
# direction byte: bits 0-3 predecessor slot, bit 4 match, bit 5 insertion
DIR_MATCH = 1 << 4
DIR_INS = 1 << 5

LAUNCHES = {"poa_dp_tb": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _ranks_used(pred_ok: torch.Tensor) -> torch.Tensor:
    """[B] int64: 1 + the last rank with any predecessor (at least 1)."""
    n_max = pred_ok.shape[1]
    has = pred_ok.any(dim=2)
    ranks = torch.arange(1, n_max + 1, device=pred_ok.device)
    return torch.where(has, ranks, 0).amax(dim=1).clamp(min=1)


def _first_argmax(x: torch.Tensor, dim: int):
    """(max, index of its FIRST occurrence) along `dim`."""
    best = x.amax(dim=dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    idx = torch.arange(n, device=x.device).view(shape)
    first = torch.where(x == best, idx, n).amin(dim=dim)
    return best.squeeze(dim), first


def poa_dp_tb_plain(seq0p, seq_len, node_char, pred_idx, pred_ok, sink_mask,
                    n_max: int, W: int, P: int, off):
    """Plain PyTorch K3: `_dp_single` + `_tb_single` of tpu_poa.py, batched.

    A Python loop over ranks with [B, 8, W+1] tensor ops, the insertion
    chain as a damped running maximum (cummax(base + 8w) - 8w), and a
    traceback loop over steps with the batch as the vector axis."""
    dev = seq0p.device
    B = seq0p.shape[0]
    i32 = torch.int32
    r_used = _ranks_used(pred_ok)
    R = int(r_used.max()) if B else 0
    H = torch.full((B, n_max + 1, W), NEG, dtype=i32, device=dev)
    dirs = torch.zeros((B, n_max, W), dtype=torch.uint8, device=dev)
    wvec = torch.arange(W, dtype=i32, device=dev)
    evec = torch.arange(W + 1, dtype=i32, device=dev) - 1
    H_flat = H.view(B, -1)
    offl = off.long()
    for r in range(R):
        pidx = pred_idx[:, r].long()  # [B, 8]
        pok = pred_ok[:, r]
        off_r = off[:, r]  # [B]
        jext = off_r[:, None] + evec[None, :]  # [B, W+1] absolute rows
        off_p = off.gather(1, pidx)  # [B, 8]
        idx = jext[:, None, :] - off_p[:, :, None]  # [B, 8, W+1]
        in_win = (idx >= 0) & (idx < W) & (jext[:, None, :] >= 0)
        flat = pidx[:, :, None] * W + idx.clamp(0, W - 1).long()
        gathered = H_flat.gather(1, flat.view(B, -1)).view(B, MAX_PREDS, W + 1)
        srcvals = (GAP * jext)[:, None, :]
        is_src = (pidx == n_max)[:, :, None]
        ext = torch.where(
            pok[:, :, None] & in_win,
            torch.where(is_src, srcvals, gathered),
            NEG,
        )
        best, slot = _first_argmax(ext, 1)  # [B, W+1] over the 8 slots
        seq_win = seq0p.gather(1, (offl[:, r, None] + wvec[None, :].long()))
        char_r = node_char[:, r, None]
        subs = torch.where(seq_win == char_r, MATCH, MISMATCH).to(i32)
        diag = best[:, :-1] + subs
        horiz = best[:, 1:] + GAP
        is_match = diag >= horiz
        base = torch.maximum(diag, horiz)
        col = torch.cummax(base + 8 * wvec, dim=1).values - 8 * wvec
        is_ins = col > base
        d = torch.where(is_match, slot[:, :-1] | DIR_MATCH, slot[:, 1:])
        d = torch.where(is_ins, DIR_INS, d)
        H[:, r] = col
        dirs[:, r] = d.to(torch.uint8)

    # sink selection at row seq_len: max score, then smallest rank
    sidx = seq_len[:, None] - off[:, :n_max]
    ranks = torch.arange(n_max, device=dev)
    valid = (sink_mask & (sidx >= 0) & (sidx < W)
             & (ranks[None, :] < r_used[:, None]))
    scores = H[:, :n_max].gather(2, sidx.clamp(0, W - 1).long()[:, :, None])[:, :, 0]
    scores = torch.where(valid, scores, NEG)
    best_sc, best_r = _first_argmax(scores, 1)

    # traceback: walk dirs from (best_r, seq_len) to the virtual source
    out_r = torch.full((B, P), -1, dtype=i32, device=dev)
    out_i = torch.full((B, P), -1, dtype=i32, device=dev)
    i = seq_len.to(i32).clone()
    r = best_r.to(torch.int64)
    at_src = torch.zeros(B, dtype=torch.bool, device=dev)
    t = torch.zeros(B, dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)
    step = 0
    while True:
        if step % 32 == 0 and not bool((((i > 0) | ~at_src) & (t < P)).any()):
            break
        step += 1
        live = ((i > 0) | ~at_src) & (t < P)
        col_i = (i.long() - offl[rows, r]).clamp(0, W - 1)
        d = dirs[rows, r, col_i].to(i32)
        ins_bit = (d & DIR_INS) != 0
        match_bit = (d & DIR_MATCH) != 0
        is_ins = ~at_src & ins_bit
        is_match = ~at_src & ~ins_bit & match_bit
        is_del = ~at_src & ~ins_bit & ~match_bit
        gap_seq = at_src | is_ins
        emit_r = torch.where(gap_seq, -1, r.to(i32))
        emit_i = torch.where(gap_seq | is_match, i - 1, -1)
        tw = t.clamp(max=P - 1)
        out_r[rows, tw] = torch.where(live, emit_r, out_r[rows, tw])
        out_i[rows, tw] = torch.where(live, emit_i, out_i[rows, tw])
        i2 = torch.where(gap_seq | is_match, i - 1, i)
        p = pred_idx[rows, r, (d & 0xF).clamp(max=MAX_PREDS - 1).long()].long()
        follow = is_match | is_del
        at_src2 = at_src | (follow & (p == n_max))
        r2 = torch.where(follow & (p != n_max), p, r)
        i = torch.where(live, i2, i)
        r = torch.where(live, r2, r)
        at_src = torch.where(live, at_src2, at_src)
        t = torch.where(live, t + 1, t)
    return out_r, out_i, t.to(i32), best_sc.to(i32)


# K3's scratch beside H and dirs: one record of REC_WORDS int32 per rank,
# the ranks padded to a multiple of REC_TILE (csrc/poa_dp_tb.cu: kRec, kTile)
REC_WORDS = 20
REC_TILE = 32
MAX_THREADS = 1024
# rows of the shared-memory ring of recent H rows: a chain step needs one;
# on an H100 a second gave under 3% on graphs of three and four copies and
# further ones nothing (64 KB at the widest unchunked window, 8192)
RING_DEPTH = 2


def _round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def launch_config(W: int, cols: int | None = None) -> dict:
    """K3's launch shape for window width W: columns per thread (1, 2, 4 or
    8), threads, and the ring's depth in rows (RING_DEPTH, or 0 where the
    window runs in several chunks of cols * threads columns).  By default 4
    columns from W 257 to 4096: on an H100 that beat 1 and 2 columns at
    W 512 to 2048 and 8 at W 1024 to 4096, and 1 column won at W 256
    (chip_smoke.py --k3-replay sweeps the shapes)."""
    if cols is None:
        cols = 1 if W <= 256 else 4 if W <= 4096 else 8
    threads = min(MAX_THREADS, _round_up(-(-W // cols), 32))
    depth = RING_DEPTH if W <= cols * threads else 0
    return {"cols": cols, "threads": threads, "depth": depth}


def chain_probe(threads: int, iters: int, device="cuda") -> None:
    """Launches K3's chain probe: `iters` dependent steps of one
    shared-memory round trip and one block barrier in a block of `threads`
    threads, the least one rank of K3's serial rank loop can cost.  The
    caller times it (chip_smoke.py's chain floor)."""
    out = torch.empty(threads, dtype=torch.int32, device=device)
    with torch.cuda.device(out.device):
        status = cudabuild.load().sz_poa_chain_probe(
            threads, iters, ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(out.device).cuda_stream))
    if status != 0:
        raise RuntimeError(f"chain probe launch failed: CUDA error {status}")


def _require(t: torch.Tensor, dtype: torch.dtype, shape, name: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}"
        )


def poa_dp_tb(seq0p, seq_len, node_char, pred_idx, pred_ok, sink_mask,
              n_max: int, W: int, P: int, off, *, split_ms=None, config=None):
    """K3: banded POA DP + traceback for a batch of blocks (see the module
    docstring for the layout).  Returns (out_r, out_i, tcount, best_sc).

    `split_ms`, a list, receives the card's milliseconds of the launch's
    parts (pre-pass, DP, traceback) from CUDA events; asking for them
    synchronises the stream, so the engine does not.  `config` replaces
    launch_config(W) (the smoke run's sweep over launch shapes)."""
    devices = {x.device for x in (seq0p, seq_len, node_char, pred_idx,
                                  pred_ok, sink_mask, off)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    B = seq0p.shape[0]
    if B < 1 or W < 1 or n_max < 1 or P < 1:
        raise ValueError(f"poa_dp_tb needs B, n_max, W, P >= 1, got {B}, {n_max}, {W}, {P}")
    if seq0p.dim() != 2 or seq0p.shape[1] <= W:
        raise ValueError("seq0p must be [B, L+1+W] with L >= 0")
    _require(seq0p, torch.uint8, (B, seq0p.shape[1]), "seq0p")
    _require(seq_len, torch.int32, (B,), "seq_len")
    _require(node_char, torch.uint8, (B, n_max), "node_char")
    _require(pred_idx, torch.int32, (B, n_max, MAX_PREDS), "pred_idx")
    _require(pred_ok, torch.bool, (B, n_max, MAX_PREDS), "pred_ok")
    _require(sink_mask, torch.bool, (B, n_max), "sink_mask")
    _require(off, torch.int32, (B, n_max + 1), "off")
    if dev.type == "cpu":
        return poa_dp_tb_plain(seq0p, seq_len, node_char, pred_idx, pred_ok,
                               sink_mask, n_max, W, P, off)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device type {dev.type!r}")
    # rows of the H and dirs scratch start at a multiple of 8 columns, so
    # that a thread's columns are one aligned vector store at any W
    stride = _round_up(W, 8)
    H = torch.empty((B, n_max + 1, stride), dtype=torch.int32, device=dev)
    dirs = torch.empty((B, n_max, stride), dtype=torch.uint8, device=dev)
    out_r = torch.empty((B, P), dtype=torch.int32, device=dev)
    out_i = torch.empty((B, P), dtype=torch.int32, device=dev)
    tcount = torch.empty(B, dtype=torch.int32, device=dev)
    best_sc = torch.empty(B, dtype=torch.int32, device=dev)
    n_pad = _round_up(n_max, REC_TILE)
    meta = torch.empty((B, n_pad, REC_WORDS), dtype=torch.int32, device=dev)
    aux = torch.empty(3 * B, dtype=torch.int32, device=dev)
    cfg = launch_config(W) if config is None else config
    lib = cudabuild.load()
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    parts = (ctypes.c_float * 3)() if split_ms is not None else None
    with torch.cuda.device(dev):
        status = lib.sz_poa_dp_tb(
            ptr(seq0p), ptr(seq_len), ptr(node_char), ptr(pred_idx),
            ptr(pred_ok), ptr(sink_mask), ptr(off),
            B, n_max, W, P, seq0p.shape[1],
            ptr(H), ptr(dirs), stride, ptr(out_r), ptr(out_i), ptr(tcount), ptr(best_sc),
            ptr(meta), n_pad, ptr(aux), cfg["cols"], cfg["threads"], cfg["depth"],
            parts, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    if status != 0:
        raise RuntimeError(f"poa_dp_tb launch failed: CUDA error {status} ({cfg})")
    LAUNCHES["poa_dp_tb"] += 1
    if split_ms is not None:
        split_ms[:] = list(parts)
    return out_r, out_i, tcount, best_sc
