"""Peaks of the card and the bytes and operations of the graph kernels.

Peaks are the published ones of one NVIDIA H100 SXM (data sheet, full 700 W
power limit): 3.35 TB/s of HBM3; int32 operations at 64 lanes on each of
132 SMs at the 1,980 MHz boost clock.  A card set below 700 W reads lower
against them; the run reports the card's power limit beside the shares.

K1 `front_half` (csrc/front_half.cu) reads each position's 2-bit code and
validity bit once (n/4 + n/8 bytes) and writes its key limbs (8 B each)
and its int32 word once; its function needs about 30 int32 operations a
position (60 with two limbs).  K2 `class_analysis` (csrc/class_analysis.cu)
reads each sorted row's key limbs, word and position and writes its flag
and first index once: 13 + 8 B a limb, a row a position.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
ONE_LIMB_MAX_K = 31


def limbs(k: int) -> int:
    return 1 if k <= ONE_LIMB_MAX_K else 2


def k1_bytes(n: int, k: int) -> int:
    return -(-n // 4) + -(-n // 8) + (8 * limbs(k) + 4) * n


def k1_ops(n: int, k: int) -> int:
    return (30 if limbs(k) == 1 else 60) * n


def k2_bytes(n: int, k: int) -> int:
    return (13 + 8 * limbs(k)) * n


def bound_s(nbytes: float, ops: float = 0.0) -> float:
    """The least time the card could take: bytes at the HBM rate or
    operations at the int32 peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def share_pct(bound: float, measured_s: float):
    """The kernel's share of its roofline, or None where it did not run."""
    return 100.0 * bound / measured_s if measured_s > 0 else None
