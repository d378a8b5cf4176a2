"""DNA alphabet operations, vectorized over numpy uint8 ASCII arrays.

Behavioral contract mirrors the reference's TwoPaCo::DnaChar
(SibeliaZ-LCB/common/dnachar.{h,cpp}):

  * valid sequence characters: "ACGTURYKMSWBDHWNXV" (dnachar.cpp:11),
  * definite (2-bit encodable) characters: "ACGT" (dnachar.cpp:9),
  * complement maps A<->T, C<->G, everything else -> 'N' (dnachar.cpp:54-58),
  * 2-bit code A=0 C=1 G=2 T=3 (dnachar.cpp:18-33); note ASCII order of
    "ACGT" equals code order, so integer comparison of packed k-mer codes is
    lexicographic comparison of the strings,
  * canonical-strand test: kmer < reverse_complement(kmer) lexicographically
    (dnachar.cpp:98-114).

Sequences are held as uint8 ASCII (uppercase) so output stages can serialize
them byte-exactly; kernels use the 2-bit code view plus a definite-mask.
"""

from __future__ import annotations

import numpy as np

VALID_CHARS = b"ACGTURYKMSWBDHWNXV"
DEFINITE_CHARS = b"ACGT"

# Sentinel 2-bit code for non-definite characters.
BAD_CODE = 255

_CODE_TABLE = np.full(256, BAD_CODE, dtype=np.uint8)
for _i, _c in enumerate(DEFINITE_CHARS):
    _CODE_TABLE[_c] = _i

_DECODE_TABLE = np.full(256, ord("N"), dtype=np.uint8)
for _i, _c in enumerate(DEFINITE_CHARS):
    _DECODE_TABLE[_i] = _c

_COMPLEMENT_TABLE = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in [(b"A", b"T"), (b"T", b"A"), (b"C", b"G"), (b"G", b"C")]:
    _COMPLEMENT_TABLE[ord(_a)] = ord(_b)

_IS_VALID = np.zeros(256, dtype=bool)
_IS_VALID[list(VALID_CHARS)] = True

_IS_DEFINITE = np.zeros(256, dtype=bool)
_IS_DEFINITE[list(DEFINITE_CHARS)] = True

_UPPER_TABLE = np.arange(256, dtype=np.uint8)
for _c in range(ord("a"), ord("z") + 1):
    _UPPER_TABLE[_c] = _c - 32


def to_upper(seq: np.ndarray) -> np.ndarray:
    """Uppercase an ASCII uint8 array (soft-masked bases are unmasked,
    matching reference streamfastaparser.cpp:85)."""
    return _UPPER_TABLE[seq]


def is_valid(seq: np.ndarray) -> np.ndarray:
    return _IS_VALID[seq]


def is_definite(seq: np.ndarray) -> np.ndarray:
    return _IS_DEFINITE[seq]


def encode(seq: np.ndarray) -> np.ndarray:
    """ASCII -> 2-bit codes; non-ACGT become BAD_CODE."""
    return _CODE_TABLE[seq]


def decode(codes: np.ndarray) -> np.ndarray:
    """2-bit codes -> ASCII; anything not in [0,3] becomes 'N'."""
    return _DECODE_TABLE[codes]


def complement_char(seq: np.ndarray) -> np.ndarray:
    """Per-character complement (the reference's ReverseChar)."""
    return _COMPLEMENT_TABLE[seq]


def reverse_complement(seq: np.ndarray) -> np.ndarray:
    """Reverse complement of an ASCII array."""
    return _COMPLEMENT_TABLE[seq][::-1]


def seq_to_str(seq: np.ndarray) -> str:
    return seq.tobytes().decode("ascii")


def str_to_seq(s: str | bytes) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode("ascii")
    return np.frombuffer(s, dtype=np.uint8).copy()


def kmer_codes_scalar(seq: np.ndarray, k: int) -> np.ndarray:
    """Big-endian base-4 integer code of every k-mer (numpy host fallback).

    Returns int64 array of length len(seq)-k+1; windows containing a
    non-definite char get -1.  The integer order equals lexicographic order
    of the k-mer strings, which is what the canonical-strand test needs.
    """
    codes = encode(seq).astype(np.int64)
    n = len(seq) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    ok = codes[: n + k - 1] != BAD_CODE
    vals = np.where(ok, codes[: n + k - 1], 0)
    out = np.zeros(n, dtype=np.int64)
    good = np.ones(n, dtype=bool)
    for i in range(k):
        out = out * 4 + vals[i : i + n]
        good &= ok[i : i + n]
    return np.where(good, out, -1)


def rc_kmer_codes_scalar(seq: np.ndarray, k: int) -> np.ndarray:
    """Integer code of the reverse complement of every k-mer (host fallback)."""
    codes = encode(seq).astype(np.int64)
    n = len(seq) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    ok = codes[: n + k - 1] != BAD_CODE
    vals = np.where(ok, 3 - codes[: n + k - 1], 0)
    out = np.zeros(n, dtype=np.int64)
    good = np.ones(n, dtype=bool)
    # rc(kmer)[j] = complement(kmer[k-1-j]); big-endian weight of position j
    # is 4^(k-1-j), so the original position i = k-1-j carries weight 4^i.
    for i in range(k - 1, -1, -1):
        out = out * 4 + vals[i : i + n]
        good &= ok[i : i + n]
    return np.where(good, out, -1)
