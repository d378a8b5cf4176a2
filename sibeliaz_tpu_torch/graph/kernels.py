"""The graph stage's three hand-written CUDA kernels and their plain versions.

K1 `front_half` (csrc/front_half.cu) turns the packed 2-bit upload into a
canonical k-mer key and a packed extension word per position, one tile of
K1_TILE_POSITIONS positions a thread block, each window taken whole from
the packed stream.  K2 `class_analysis` (csrc/class_analysis.cu) turns the
key-sorted rows into a junction verdict and a class-first position per
row, in one pass over tiles of K2_TILE_ROWS rows with a decoupled
look-back.  K4 `round_append` (csrc/round_append.cu), for the streamed
graph stage, appends one chunk's rows to the round buffers of the rounds
their classes hash to, in genome order, in one pass over tiles of
K4_TILE_ROWS rows with a decoupled look-back over (tile, round) counts.

Keys are a tuple of int64 tensors, as the JAX package's _prepare_packed
gives them: one limb for k <= 31, two base-2^62 limbs (hi, lo) for
32 <= k <= 61, ordered lexicographically.  Each kernel has an instance for
each limb count.

Each wrapper routes by the device of the tensors it is given: a CPU tensor
goes to the plain PyTorch version beside it, a CUDA tensor launches the
kernel (or raises), anything else raises.  A launch makes the tensors'
device current (torch.cuda.device) around its scratch and the C call, so
that it goes to that device's current stream whichever device the caller
made current.  The plain versions are the CPU
path and the spec the kernels are tested against.  LAUNCHES counts kernel
launches per wrapper; the plain versions do not count.
"""

from __future__ import annotations

import ctypes

import torch

from sibeliaz_tpu_torch.utils import cudabuild

# Canonical key (high limb) of a window that is not all ACGT or runs past
# the end; it sorts after every real code (4^31 - 1 < 2^62).  Its low limb,
# where there is one, is 0.
INVALID_CANON = 1 << 62
_NO_EXT = 4
ONE_LIMB_MAX_K = 31  # a limb holds 31 bases; wider k takes two
MAX_K = 61  # k = 62 would let the high limb reach INVALID_CANON

LAUNCHES = {"front_half": 0, "class_analysis": 0, "round_append": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _route(*tensors: torch.Tensor) -> str:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device type {kind!r}")
    return kind


def _require(t: torch.Tensor, dtype: torch.dtype, min_len: int, name: str):
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor")
    if t.shape[0] < min_len:
        raise ValueError(f"{name} has {t.shape[0]} entries, needs {min_len}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {status}")


# ---- K1: front half -------------------------------------------------------

# Positions per tile of the kernel (csrc/front_half.cu,
# sz_front_half_tile_positions): the tests lay their N runs out by it, and
# the card's check it.
K1_TILE_POSITIONS = 2048


def front_half_plain(codes2: torch.Tensor, nmask: torch.Tensor, n: int, k: int):
    """Plain PyTorch K1: the math of construct._prepare_packed, written with
    torch.roll (windows past the end wrap around, as there).  The codes
    fwd = sum c_i 4^(k-1-i) and rc = sum (3 - c_i) 4^i are built base by
    base as (hi, lo) limbs of base 2^62 (hi is 0 for k <= 31)."""
    idx = torch.arange(n, device=codes2.device)
    definite = ((nmask[idx >> 3].long() >> (idx & 7)) & 1) > 0
    code = (codes2[idx >> 2].long() >> ((idx & 3) * 2)) & 3
    codes = torch.where(definite, code, 0)
    fwd_hi, fwd_lo, rc_hi, rc_lo = (
        torch.zeros(n, dtype=torch.int64, device=codes2.device) for _ in range(4))
    valid = idx + k <= n
    for i in range(k):
        ci = torch.roll(codes, -i)
        valid = valid & torch.roll(definite, -i)
        j = k - 1 - i  # the pair of base i in fwd
        if j >= ONE_LIMB_MAX_K:
            fwd_hi |= ci << (2 * (j - ONE_LIMB_MAX_K))
        else:
            fwd_lo |= ci << (2 * j)
        if i >= ONE_LIMB_MAX_K:
            rc_hi |= (3 - ci) << (2 * (i - ONE_LIMB_MAX_K))
        else:
            rc_lo |= (3 - ci) << (2 * i)
    positive = (fwd_hi < rc_hi) | ((fwd_hi == rc_hi) & (fwd_lo < rc_lo))
    canon_hi = torch.where(positive, fwd_hi, rc_hi)
    canon_lo = torch.where(positive, fwd_lo, rc_lo)
    if k <= ONE_LIMB_MAX_K:
        keys = (torch.where(valid, canon_lo, INVALID_CANON),)
    else:
        keys = (torch.where(valid, canon_hi, INVALID_CANON), torch.where(valid, canon_lo, 0))

    nxt_ok = torch.roll(definite, -k) & (idx + k < n)
    prv_ok = torch.roll(definite, 1) & (idx >= 1)
    nxt_c = torch.roll(codes, -k)
    prv_c = torch.roll(codes, 1)
    nxt = torch.where(nxt_ok, nxt_c, _NO_EXT)
    prv = torch.where(prv_ok, prv_c, _NO_EXT)
    comp_nxt = torch.where(nxt_ok, 3 - nxt_c, _NO_EXT)
    comp_prv = torch.where(prv_ok, 3 - prv_c, _NO_EXT)
    right = torch.where(positive, nxt, comp_prv)
    left = torch.where(positive, prv, comp_nxt)
    false = torch.zeros(1, dtype=torch.bool, device=codes2.device)
    prev_valid = torch.cat([false, valid[:-1]])
    next_valid = torch.cat([valid[1:], false])
    boundary = valid & ~(prev_valid & next_valid)
    packed = (
        (1 << right)
        | (1 << (left + 5))
        | (boundary.long() << 10)
        | (positive.long() << 11)
    ).to(torch.int32)
    return keys, packed


def front_half(codes2: torch.Tensor, nmask: torch.Tensor, n: int, k: int):
    """K1.  codes2: uint8 2-bit codes, four per byte (pack_codes_host);
    nmask: uint8 definiteness bits, eight per byte; n positions; k <= 61.

    Returns (keys, packed int32 [n]) in genome order: keys is (key,) for
    k <= 31 and (hi, lo) for 32 <= k <= 61, each int64 [n]."""
    kind = _route(codes2, nmask)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"front_half takes 1 <= k <= {MAX_K}, got k={k}")
    _require(codes2, torch.uint8, -(-n // 4), "codes2")
    _require(nmask, torch.uint8, -(-n // 8), "nmask")
    if kind == "cpu":
        return front_half_plain(codes2, nmask, n, k)
    limbs = 1 if k <= ONE_LIMB_MAX_K else 2
    keys = tuple(torch.empty(n, dtype=torch.int64, device=codes2.device) for _ in range(limbs))
    packed = torch.empty(n, dtype=torch.int32, device=codes2.device)
    lib = cudabuild.load()
    with torch.cuda.device(codes2.device):
        _check(
            lib.sz_front_half(
                _ptr(codes2), _ptr(nmask), n, k, _ptr(keys[0]),
                _ptr(keys[1]) if limbs == 2 else None, _ptr(packed), _stream(codes2.device),
            ),
            "front_half",
        )
    LAUNCHES["front_half"] += 1
    return keys, packed


# ---- K2: class analysis ---------------------------------------------------

# Rows per tile of the kernel (csrc/class_analysis.cu, sz_class_tile_rows):
# the tests lay their class runs out by it, and the card's check it.
K2_TILE_ROWS = 2048

# packed-word bits the verdict reads: right extensions A,C,G,T; left
# extensions A,C,G,T; run boundary
_VERDICT_BITS = (0, 1, 2, 3, 5, 6, 7, 8, 10)


def class_analysis_plain(keys_s, packed_s: torch.Tensor, pos_s: torch.Tensor):
    """Plain PyTorch K2: a class starts where any key limb changes;
    per-class "contains bit b" as a scatter amax over the nine bit planes
    the verdict reads."""
    n = keys_s[0].shape[0]
    dev = keys_s[0].device
    start = torch.ones(n, dtype=torch.bool, device=dev)
    start[1:] = keys_s[0][1:] != keys_s[0][:-1]
    for key_s in keys_s[1:]:
        start[1:] |= key_s[1:] != key_s[:-1]
    cls = torch.cumsum(start, 0) - 1
    valid = keys_s[0] != INVALID_CANON
    shifts = torch.tensor(_VERDICT_BITS, dtype=torch.int32, device=dev)
    bits = ((packed_s[None, :] >> shifts[:, None]) & 1) * valid
    has = torch.zeros(len(_VERDICT_BITS), n, dtype=torch.int32, device=dev)
    has.scatter_reduce_(1, cls.expand(len(_VERDICT_BITS), n), bits, "amax")
    verdict = (
        (has[0:4].sum(0) > 1) | (has[4:8].sum(0) > 1) | (has[8] > 0)
    )
    junction_s = verdict[cls] & valid
    cls_first = torch.zeros(n, dtype=torch.int32, device=dev)
    cls_first[cls[start]] = pos_s[start]
    return junction_s, cls_first[cls]


def class_analysis(keys_s, packed_s: torch.Tensor, pos_s: torch.Tensor):
    """K2.  keys_s: a tuple of one or two int64 key limbs (hi first), equal
    keys adjacent (sorted, or any runs); packed_s, pos_s: int32 packed words
    and genome positions in the same row order.

    Returns (junction_s bool [n], first_s int32 [n]) in row order."""
    if not isinstance(keys_s, (tuple, list)) or len(keys_s) not in (1, 2):
        raise ValueError("keys_s must be a tuple of one or two key limbs")
    kind = _route(*keys_s, packed_s, pos_s)
    n = keys_s[0].shape[0]
    for key_s in keys_s:
        _require(key_s, torch.int64, n, "key_s")
    _require(packed_s, torch.int32, n, "packed_s")
    _require(pos_s, torch.int32, n, "pos_s")
    if any(t.shape[0] != n for t in (*keys_s, packed_s, pos_s)):
        raise ValueError("keys_s, packed_s and pos_s differ in length")
    if kind == "cpu":
        return class_analysis_plain(keys_s, packed_s, pos_s)
    dev = packed_s.device
    junction_s = torch.empty(n, dtype=torch.bool, device=dev)
    first_s = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return junction_s, first_s
    lib = cudabuild.load()
    with torch.cuda.device(dev):
        scratch = torch.empty(lib.sz_class_scratch_bytes(n), dtype=torch.uint8, device=dev)
        _check(
            lib.sz_class_analysis(
                _ptr(keys_s[0]), _ptr(keys_s[1]) if len(keys_s) == 2 else None,
                _ptr(packed_s), _ptr(pos_s), n,
                _ptr(junction_s), _ptr(first_s), _ptr(scratch), _stream(dev),
            ),
            "class_analysis",
        )
    LAUNCHES["class_analysis"] += 1
    return junction_s, first_s


# ---- K4: round append -----------------------------------------------------

# The Fibonacci-hash constants of the JAX package's streamed stage
# (sibeliaz_tpu/graph/streamed.py _MIX, _MIX2) as two's-complement int64:
# 0x9E3779B97F4A7C15 and 0xC2B2AE3D27D4EB4F.
MIX = -7046029254386353131
MIX2 = -4417276706812531889
# Rounds one launch appends into at most (csrc/round_append.cu,
# sz_round_max_rounds): the kernel keeps a count per warp and round in
# shared memory and a status word per tile and round.
MAX_ROUNDS_PER_LAUNCH = 64
# Rows per tile of the kernel (sz_round_tile_rows): the tests lay their
# rounds out across tiles by it.
K4_TILE_ROWS = 4096
# A payload is gpos << 12 | the 12-bit word; gpos must leave the sign bit.
_MAX_GPOS = 1 << 51


def round_scratch_bytes(m: int, G: int) -> int:
    """Device bytes of K4's scratch for a chunk of m rows and G rounds
    (sz_round_scratch_bytes): a 64-bit status word per tile and round, and
    the tile counter."""
    return (-(-m // K4_TILE_ROWS) * G + 1) * 8


def round_bucket(keys, n_rounds: int) -> torch.Tensor:
    """The round of each row's class, as streamed._round_bucket and
    _round_bucket2: the key times MIX (two limbs: hi * MIX xor lo * MIX2),
    wrapping in int64, bits 32-62 of the product, modulo n_rounds.  Any
    function of the key keeps a class in one round; the product's high bits
    keep the rounds balanced."""
    h = keys[0] * MIX
    if len(keys) == 2:
        h = h ^ (keys[1] * MIX2)
    return ((h >> 32) & 0x7FFFFFFF) % n_rounds


def _round_of(keys, r0: int, n_rounds: int, G: int) -> torch.Tensor:
    """Each row's round relative to r0, or -1 where the row is not kept (an
    invalid window, or a round outside [r0, r0 + G))."""
    g = round_bucket(keys, n_rounds) - r0
    keep = (keys[0] != INVALID_CANON) & (g >= 0) & (g < G)
    return torch.where(keep, g, -1)


def round_append_plain(keys, packed, gpos0, r0, n_rounds, buf_keys, buf_payload,
                       cursors, overflow):
    """Plain PyTorch K4: a stable sort of the kept rows by round, each
    round's rows written from its cursor on; rows past the cap are dropped
    and raise the overflow flag."""
    G, cap = buf_payload.shape
    g = _round_of(keys, r0, n_rounds, G)
    rows = torch.nonzero(g >= 0).squeeze(1)
    g_sorted, order = torch.sort(g[rows], stable=True)
    rows = rows[order]
    counts = torch.bincount(g_sorted, minlength=G)
    first_of_round = torch.cumsum(counts, 0) - counts
    dst = cursors[g_sorted] + torch.arange(len(rows), device=rows.device) - first_of_round[g_sorted]
    ok = dst < cap
    g_ok, dst, rows = g_sorted[ok], dst[ok], rows[ok]
    for buf, key in zip(buf_keys, keys):
        buf[g_ok, dst] = key[rows]
    buf_payload[g_ok, dst] = ((gpos0 + rows) << 12) | (packed[rows].long() & 0xFFF)
    overflow |= (cursors + counts > cap).any().to(overflow.dtype)
    cursors += counts


def round_append(keys, packed, gpos0: int, r0: int, n_rounds: int, buf_keys, buf_payload,
                 cursors, overflow) -> None:
    """K4.  Appends the kept rows of one chunk to G = buf_payload.shape[0]
    round buffers, in place.

    keys: one or two int64 key limbs [m] (K1's, hi first); packed: K1's
    int32 words [m]; row i lies at global position gpos0 + i.  A row is kept
    when its key is valid and its round (round_bucket of n_rounds) lies in
    [r0, r0 + G); it goes to round buffer round - r0 at that round's cursor,
    kept rows of one round in ascending row order.  buf_keys: one [G, cap]
    int64 buffer per limb; buf_payload: [G, cap] int64, gpos << 12 | bits
    0-11 of the word; cursors: int64 [G], the rows each round holds, raised
    by the rows appended; overflow: int32 [1], set to 1 when a cursor passes
    cap (rows past the cap are not written)."""
    if not isinstance(keys, (tuple, list)) or len(keys) not in (1, 2):
        raise ValueError("keys must be a tuple of one or two key limbs")
    if not isinstance(buf_keys, (tuple, list)) or len(buf_keys) != len(keys):
        raise ValueError("buf_keys must hold one buffer per key limb")
    kind = _route(*keys, packed, *buf_keys, buf_payload, cursors, overflow)
    m = packed.shape[0]
    for key in keys:
        _require(key, torch.int64, m, "key")
    _require(packed, torch.int32, m, "packed")
    if any(key.shape[0] != m for key in keys):
        raise ValueError("keys and packed differ in length")
    if buf_payload.dtype != torch.int64 or buf_payload.dim() != 2 or not buf_payload.is_contiguous():
        raise ValueError("buf_payload must be a contiguous [G, cap] int64 tensor")
    G, cap = buf_payload.shape
    for buf in buf_keys:
        if buf.dtype != torch.int64 or buf.shape != buf_payload.shape or not buf.is_contiguous():
            raise ValueError("each key buffer must be a contiguous int64 tensor shaped as buf_payload")
    _require(cursors, torch.int64, G, "cursors")
    _require(overflow, torch.int32, 1, "overflow")
    if cursors.shape[0] != G:
        raise ValueError(f"cursors has {cursors.shape[0]} entries for {G} rounds")
    if not 1 <= G <= MAX_ROUNDS_PER_LAUNCH:
        raise ValueError(f"round_append takes 1 to {MAX_ROUNDS_PER_LAUNCH} rounds, got {G}")
    if not (1 <= n_rounds < 1 << 31 and 0 <= r0 < n_rounds):
        raise ValueError(f"r0={r0} and n_rounds={n_rounds} name no round")
    if not 0 <= gpos0 <= _MAX_GPOS - m:
        raise ValueError(f"gpos0={gpos0}: positions must stay under 2^51")
    if kind == "cpu":
        return round_append_plain(keys, packed, gpos0, r0, n_rounds, buf_keys, buf_payload,
                                  cursors, overflow)
    if m == 0:
        return None
    round_append_launch(cudabuild.load(), keys, packed, gpos0, r0, n_rounds, buf_keys,
                        buf_payload, cursors, overflow)
    LAUNCHES["round_append"] += 1
    return None


def round_append_launch(lib, keys, packed, gpos0, r0, n_rounds, buf_keys, buf_payload,
                        cursors, overflow) -> None:
    """One launch of `lib`'s sz_round_append on round_append's arguments,
    checked by it, with its scratch; raises on a CUDA error.  `lib` is a
    library bound by cudabuild.bind: the port's, or (to time it against the
    port's) one built alone from another version of csrc/round_append.cu
    with the same C interface."""
    m, (G, cap) = packed.shape[0], buf_payload.shape
    dev = packed.device
    with torch.cuda.device(dev):
        scratch = torch.empty(lib.sz_round_scratch_bytes(m, G), dtype=torch.uint8, device=dev)
        _check(
            lib.sz_round_append(
                _ptr(keys[0]), _ptr(keys[1]) if len(keys) == 2 else None, _ptr(packed), m,
                gpos0, r0, n_rounds, G, cap, _ptr(buf_keys[0]),
                _ptr(buf_keys[1]) if len(keys) == 2 else None, _ptr(buf_payload),
                _ptr(cursors), _ptr(overflow), _ptr(scratch), _stream(dev),
            ),
            "round_append",
        )
