"""Pipeline configuration.

One dataclass replaces the reference's two-level flag system (bash getopts in
the ``sibeliaz`` driver + TCLAP in ``sibeliaz-lcb``); parameter names and
defaults mirror the driver's (reference: SibeliaZ-LCB/sibeliaz:4-7 — k=25,
b=200, m=50, a=150; SibeliaZ-LCB/sibeliaz.cpp:134-140 — lookingDepth=8,
maxFlankingSize=b; --chunks 256 at sibeliaz:146).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    """All tunables of the pipeline, with reference-parity defaults."""

    # Core graph parameter: k-mer (vertex) size; must be odd so no k-mer can
    # equal its own reverse complement (reference: sibeliaz.cpp:13-35).
    k: int = 25
    # Maximum bubble branch size in bp (-b, reference README.md:182-194).
    max_branch_size: int = 200
    # Minimum LCB length in bp (-m; driver default 50, sibeliaz:6).
    min_block_size: int = 50
    # Maximum abundance of a junction; more frequent vertices are dropped
    # while loading the graph (-a, reference junctionstorage.h:610-616).
    abundance_threshold: int = 150
    # Maximum flanking (unaligned overhang) size; the reference hardwires it
    # to max_branch_size (sibeliaz.cpp:137).
    max_flanking_size: int | None = None
    # Path-extension lookahead depth in junctions (sibeliaz.cpp:137 -> 8).
    looking_depth: int = 8
    # Number of chunk buckets for the alignment stage (sibeliaz:146 -> 256).
    chunks: int = 256
    # Host worker threads for the native LCB engine (driver caps at 32).
    threads: int = 1
    # Skip the alignment stage, like `sibeliaz -n` (sibeliaz:43-46).
    no_align: bool = False
    # Output directory (sibeliaz:11).
    out_dir: str = "./sibeliaz_out"
    # Device-memory budget in bytes (-f GB; the reference driver's single
    # memory flag, sibeliaz:105-117).  None = per-stage defaults.  Bounds
    # the graph stage's HBM routing, the fused LCB engine's vote-dispatch
    # size, and the device POA's scratch budget.
    memory_budget_bytes: int | None = None

    def __post_init__(self) -> None:
        if self.k % 2 == 0:
            raise ValueError("k must be odd")
        if self.k < 3 or self.k > 61:
            # k <= 31: one int64 2-bit code word; 33..61: two-limb codes
            # (graph/construct.py _doubling_codes2).  The reference driver
            # passes any odd k through to TwoPaCo (sibeliaz:145).
            raise ValueError("k must be in [3, 61]")

    @property
    def flanking(self) -> int:
        return (
            self.max_branch_size
            if self.max_flanking_size is None
            else self.max_flanking_size
        )

    @property
    def min_run(self) -> int:
        """Extension-continuation window: 2*b (reference blocksfinder.h:254)."""
        return 2 * self.max_branch_size
