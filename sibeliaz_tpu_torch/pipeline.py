"""End-to-end pipeline orchestration (the reference's bash driver, as a
library; SibeliaZ-LCB/sibeliaz:138-152).

Stages: graph construction (on the run's device) -> junction table (host)
-> LCB engine -> trim/renumber -> GFF; the CLI then runs the alignment
stage (align/msa.py: POA per block -> MAF).  The LCB engines, as in the
JAX package: `native` (the C++ engine, host), `oracle` (the Python
executable specification, `lcb/oracle.py`, host), and the two device
engines, which run on the run's device: `tpu-fused` (the fused state
machine, `lcb/fused.py`, with its vote budget from `-f`) and `tpu`, also
named `resident` (the resident lanes with a host protocol a lane,
`lcb/resident.py`)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from sibeliaz_tpu_torch.config import Config
from sibeliaz_tpu_torch.graph import construct
from sibeliaz_tpu_torch.io.dbg import JunctionChr
from sibeliaz_tpu_torch.junctions.table import JunctionTable
from sibeliaz_tpu_torch.lcb.blocks import Block
from sibeliaz_tpu_torch.lcb.engine import run_native
from sibeliaz_tpu_torch.lcb.fused import run_fused, vote_budget_from_bytes
from sibeliaz_tpu_torch.lcb.oracle import LcbEngine
from sibeliaz_tpu_torch.lcb.resident import run_resident
from sibeliaz_tpu_torch.output import gff as gff_mod
from sibeliaz_tpu_torch.output import trim as trim_mod
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics


@dataclasses.dataclass
class LcbResult:
    blocks: List[Block]
    gff: str
    blocks_found: int
    coverage: float
    table: JunctionTable


def build_table(
    seqs: Sequence[np.ndarray],
    names: Sequence[str],
    cfg: Config,
    records: Optional[Sequence[JunctionChr]] = None,
    device: str = "cuda",
) -> JunctionTable:
    """The junction table of `seqs`; the graph stage runs unless `records`
    are given.  `cfg.memory_budget_bytes` bounds its device memory: over
    it, the streamed graph stage runs instead of the monolithic one."""
    if records is None:
        records = construct.build_junctions(
            list(seqs), cfg.k, device, cfg.memory_budget_bytes
        )
    return JunctionTable.build(records, list(seqs), list(names), cfg.k, cfg.abundance_threshold)


ENGINES = ("native", "oracle", "tpu", "resident", "tpu-fused")


def check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise NotImplementedError(
            f"--lcb-engine {engine}: there is no such engine; the LCB engines are "
            + ", ".join(ENGINES))


def find_blocks(
    seqs: Sequence[np.ndarray],
    names: Sequence[str],
    cfg: Config,
    records: Optional[Sequence[JunctionChr]] = None,
    engine: str = "native",
    device: str = "cuda",
) -> LcbResult:
    check_engine(engine)
    with metrics.stage("junction_table"):
        table = build_table(seqs, names, cfg, records, device)
    metrics.set("vertices", table.n_vertices)
    metrics.set("junction_records", int(sum(len(p) for p in table.jpos)))
    with metrics.stage("lcb_engine", engine=engine):
        if engine != "native":
            eng = LcbEngine(
                table,
                min_block_size=cfg.min_block_size,
                max_branch_size=cfg.max_branch_size,
                max_flanking_size=cfg.flanking,
                looking_depth=cfg.looking_depth,
            )
            if engine == "oracle":
                raw = eng.run()
            elif engine in ("tpu", "resident"):
                raw = run_resident(eng, device=device)
            else:
                vb = (vote_budget_from_bytes(cfg.memory_budget_bytes)
                      if cfg.memory_budget_bytes else None)
                raw = run_fused(eng, device=device, vote_budget=vb)
        else:
            raw = run_native(
                table,
                min_block_size=cfg.min_block_size,
                max_branch_size=cfg.max_branch_size,
                max_flanking_size=cfg.flanking,
                looking_depth=cfg.looking_depth,
                threads=cfg.threads,
            )
    chr_lengths = [len(s) for s in seqs]
    with metrics.stage("trim_and_render"):
        blocks, n_found = trim_mod.trim_blocks(raw, chr_lengths, cfg.min_block_size)
        cov = trim_mod.coverage(blocks, chr_lengths)
        text = gff_mod.render_gff(blocks, list(names), chr_lengths)
    metrics.set("blocks_found", n_found)
    metrics.set("coverage", cov)
    return LcbResult(
        blocks=blocks, gff=text, blocks_found=n_found, coverage=cov, table=table
    )
