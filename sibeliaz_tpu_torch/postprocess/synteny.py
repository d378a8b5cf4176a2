"""Coarse synteny-block construction from LCBs (maf2synteny equivalent).

The reference pipeline recommends `sibeliaz -n` followed by the external
`maf2synteny` tool to merge fine-grained LCBs into large-scale synteny
blocks (README.md:96-112; the tool is a pinned submodule, not mounted —
CMakeLists.txt:14-15).  This module re-designs that capability after the
published algorithm (Sibelia: Minkin et al., WABI 2013 — iterative
A-Bruijn/breakpoint-graph simplification):

  * genomes become signed permutations of LCB ids (block occurrences in
    sequence order; orientation = id sign),
  * simplification runs in STAGES of increasing scale, each parameterized
    by a (min_block, max_gap) pair; within a stage, blocks shorter than
    min_block are noise (removed from the permutations), then two graph
    rewrites alternate to a FIXPOINT:
      - path compression: pairs (a, b) adjacent with consistent
        orientation in *every* occurrence and separated by at most
        max_gap bp everywhere merge into one block, and
      - bulge removal: where two block anchors (u, v) are connected by
        parallel branches — some occurrences direct, others through a
        short run of blocks spanning <= max_gap bp — the minority
        branches' interior occurrences are deleted, so the detour
        collapses onto the main path and compression can proceed (this is
        the "bulge" simplification of the A-Bruijn graph; the interval of
        a removed detour is absorbed by the merged block's span),
  * surviving blocks with >= 2 occurrences and length >= the requested
    output scale become synteny blocks; one output set is produced per
    requested minimum block size, in Sibelia's output formats
    (blocks_coords.txt, genomes_permutations.txt, coverage_report.txt)
    for downstream compatibility.

Parameter provenance: maf2synteny's `-s` takes a parameter file of
"<min_block> <max_gap>" lines; its built-in fine schedule is
(30,10) (100,100) (500,1000) (1000,5000) (5000,15000), with a loose
schedule extending to (10000,50000) (50000,500000) for mammalian-scale
merging.  The exact constants could not be byte-verified here (the
submodule is unmounted and this environment has no network); they follow
the published multi-scale schedule shape and are overridable via `-s
<file>`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Sequence, Tuple

from sibeliaz_tpu_torch.postprocess.maf import parse_maf

# Each stage is (min_block, max_gap): blocks < min_block are stage noise;
# compression/bulge branches are bounded by max_gap bp.
FINE_STAGES = [
    (30, 10), (100, 100), (500, 1000), (1000, 5000), (5000, 15000)
]
LOOSE_STAGES = FINE_STAGES + [(10000, 50000), (50000, 500000)]
DEFAULT_STAGES = FINE_STAGES
# How many interior blocks a bulge branch may contain.
_MAX_BRANCH_BLOCKS = 2


def parse_stages(spec: str) -> List[Tuple[int, int]]:
    """Resolve a -s argument: 'fine' (default), 'loose', or a path to a
    parameter file with one '<min_block> <max_gap>' pair per line (blank
    lines and '#' comments ignored)."""
    if spec == "loose":
        return list(LOOSE_STAGES)
    if spec == "fine":
        return list(FINE_STAGES)
    stages: List[Tuple[int, int]] = []
    with open(spec) as f:
        for ln, line in enumerate(f, start=1):
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) != 2 or not all(
                p.lstrip("-").isdigit() for p in parts
            ):
                raise ValueError(
                    f"{spec}:{ln}: expected '<min_block> <max_gap>', "
                    f"got {line!r}"
                )
            stages.append((int(parts[0]), int(parts[1])))
    if not stages:
        raise ValueError(f"no simplification stages in {spec!r}")
    return stages


@dataclasses.dataclass
class Occ:
    block: int  # signed id
    chr: int
    start: int
    end: int

    @property
    def length(self) -> int:
        return self.end - self.start


def parse_gff_blocks(path: str) -> Tuple[List[Occ], List[str], List[int]]:
    names: List[str] = []
    sizes: List[int] = []
    index: Dict[str, int] = {}
    occs: List[Occ] = []
    with open(path) as f:
        for line in f:
            if line.startswith("##sequence-region"):
                _, name, _, size = line.split()
                index[name] = len(names)
                names.append(name)
                sizes.append(int(size))
                continue
            if line.startswith("#") or not line.strip():
                continue
            p = line.rstrip("\n").split("\t")
            name, start, end, strand, attr = p[0], int(p[3]), int(p[4]), p[6], p[8]
            bid = int(attr.split("=")[1])
            c = index[name]
            occs.append(
                Occ(
                    block=bid if strand == "+" else -bid,
                    chr=c,
                    start=start - 1,
                    end=end,
                )
            )
    return occs, names, sizes


def parse_maf_blocks(path: str) -> Tuple[List[Occ], List[str], List[int]]:
    names: List[str] = []
    sizes: List[int] = []
    index: Dict[str, int] = {}
    occs: List[Occ] = []
    for bid, block in enumerate(parse_maf(path), start=1):
        for r in block:
            if r.seq_name not in index:
                index[r.seq_name] = len(names)
                names.append(r.seq_name)
                sizes.append(r.seq_size)
            c = index[r.seq_name]
            s = r.pos_start()
            occs.append(
                Occ(
                    block=bid if r.strand == "+" else -bid,
                    chr=c,
                    start=s,
                    end=s + r.size,
                )
            )
    return occs, names, sizes


def _remove_bulges(
    perms: List[List[Occ]], max_gap: int
) -> Tuple[List[List[Occ]], bool]:
    """One bulge-removal pass over the breakpoint graph.

    A bulge = an anchor pair (u, v) joined by >= 2 distinct parallel
    branches, where a branch is the (possibly empty) run of interior
    blocks between an occurrence of u and the next occurrence of v,
    spanning <= max_gap bp.  The keeper branch is the one with the most
    occurrences (empty/direct branch preferred on ties, then the
    lexicographically smallest signature, for determinism); every other
    branch's interior occurrences are deleted from their permutations —
    the detour collapses onto the main path, and the deleted interval is
    later absorbed by the compressed block's span.  Anchors themselves
    are never deleted."""
    # branch observations: canonical (u, v) -> signature -> [interior occs]
    branches: Dict[Tuple[int, int], Dict[Tuple[int, ...], List[List[Occ]]]] = {}
    for p in perms:
        n = len(p)
        for i in range(n - 1):
            for j in range(i + 1, min(i + 2 + _MAX_BRANCH_BLOCKS, n)):
                if p[j].start - p[i].end > max_gap:
                    break
                u, v = p[i].block, p[j].block
                mids = p[i + 1 : j]
                sig = tuple(o.block for o in mids)
                # canonical orientation: a bulge read on the - strand is
                # the same bulge
                ru, rv = -v, -u
                rsig = tuple(-o.block for o in reversed(mids))
                if (ru, rv, rsig) < (u, v, sig):
                    u, v, sig = ru, rv, rsig
                branches.setdefault((u, v), {}).setdefault(sig, []).append(
                    list(mids)
                )

    doomed: set = set()
    for (u, v), sigs in sorted(branches.items()):
        if len(sigs) < 2:
            continue
        # keeper: most occurrences; prefer the direct branch, then the
        # lexicographically smallest signature
        keeper = min(
            sigs.items(),
            key=lambda kv: (-len(kv[1]), len(kv[0]) > 0, kv[0]),
        )[0]
        for sig, occ_lists in sigs.items():
            if sig == keeper:
                continue
            for mids in occ_lists:
                for o in mids:
                    doomed.add(id(o))
    if not doomed:
        return perms, False
    return [[o for o in p if id(o) not in doomed] for p in perms], True


def _compress(
    perms: List[List[Occ]], max_gap: int, next_id: int
) -> Tuple[List[List[Occ]], int, bool]:
    """One path-compression pass; returns (new perms, next_id, changed)."""
    pruned = perms

    # collect adjacency stats per ordered signed pair in + reading
    # direction; permutation ends register a sentinel successor/
    # predecessor (block 0, never a real id) so a terminal occurrence of
    # `a` blocks chaining — "adjacent in *every* occurrence" must include
    # occurrences with no neighbor at all
    succ: Dict[int, set] = {}
    pred: Dict[int, set] = {}
    gapok: Dict[Tuple[int, int], bool] = {}
    for p in pruned:
        if p:
            succ.setdefault(p[-1].block, set()).add(0)
            pred.setdefault(p[0].block, set()).add(0)
            succ.setdefault(-p[0].block, set()).add(0)
            pred.setdefault(-p[-1].block, set()).add(0)
        for x, y in zip(p, p[1:]):
            succ.setdefault(x.block, set()).add(y.block)
            pred.setdefault(y.block, set()).add(x.block)
            # mirrored adjacency on the - strand
            succ.setdefault(-y.block, set()).add(-x.block)
            pred.setdefault(-x.block, set()).add(-y.block)
            key = (x.block, y.block)
            ok = y.start - x.end <= max_gap
            gapok[key] = gapok.get(key, True) and ok
            gapok[(-y.block, -x.block)] = gapok[key]

    def mergeable(a: int, b: int) -> bool:
        return (
            succ.get(a) == {b}
            and pred.get(b) == {a}
            and gapok.get((a, b), False)
            and abs(a) != abs(b)
        )

    # (b) chain maximal unique paths
    changed = False
    out: List[list] = []  # per chromosome: (Occ, members-or-None) pairs
    for p in pruned:
        np_: List[tuple] = []
        i = 0
        while i < len(p):
            j = i
            while j + 1 < len(p) and mergeable(p[j].block, p[j + 1].block):
                j += 1
            if j > i:
                changed = True
                merged = Occ(
                    block=0,
                    chr=p[i].chr,
                    start=p[i].start,
                    end=p[j].end,
                )
                np_.append((merged, p[i : j + 1]))
            else:
                np_.append((p[i], None))
            i = j + 1
        out.append(np_)

    # assign consistent ids to merged chains: identify chains by their
    # canonical signed id tuple (or its reverse complement)
    chain_ids: Dict[Tuple[int, ...], int] = {}
    final: List[List[Occ]] = []
    for p in out:
        np_ = []
        for item, members in p:
            if members is None:
                np_.append(item)
                continue
            fwd = tuple(o.block for o in members)
            rev = tuple(-o.block for o in reversed(members))
            if fwd in chain_ids:
                bid = chain_ids[fwd]
            elif rev in chain_ids:
                bid = -chain_ids[rev]
            else:
                chain_ids[fwd] = next_id
                bid = next_id
                next_id += 1
            item.block = bid
            np_.append(item)
        final.append(np_)
    return final, next_id, changed


def build_synteny(
    occs: Sequence[Occ],
    n_chr: int,
    min_block: int,
    stages: Sequence[Tuple[int, int]] = DEFAULT_STAGES,
) -> List[Occ]:
    perms: List[List[Occ]] = [[] for _ in range(n_chr)]
    for o in occs:
        perms[o.chr].append(
            Occ(block=o.block, chr=o.chr, start=o.start, end=o.end)
        )
    for p in perms:
        p.sort(key=lambda o: o.start)
    next_id = max((abs(o.block) for o in occs), default=0) + 1
    for stage_min_block, max_gap in stages:
        if stage_min_block > min_block:
            break
        # stage noise filter: blocks below the stage scale leave the
        # permutations (their intervals are later absorbed by compression)
        perms = [[o for o in p if o.length >= stage_min_block] for p in perms]
        # alternate compression and bulge removal to a fixpoint
        while True:
            perms, next_id, ch1 = _compress(perms, max_gap, next_id)
            perms, ch2 = _remove_bulges(perms, max_gap)
            if not (ch1 or ch2):
                break
    # keep blocks with >= 2 occurrences and length >= min_block; renumber
    result = [o for p in perms for o in p if o.length >= min_block]
    mult: Dict[int, int] = {}
    for o in result:
        mult[abs(o.block)] = mult.get(abs(o.block), 0) + 1
    result = [o for o in result if mult[abs(o.block)] >= 2]
    renum: Dict[int, int] = {}
    out = []
    for o in sorted(result, key=lambda o: (abs(o.block), o.chr, o.start)):
        if abs(o.block) not in renum:
            renum[abs(o.block)] = len(renum) + 1
        nid = renum[abs(o.block)]
        out.append(
            Occ(
                block=nid if o.block > 0 else -nid,
                chr=o.chr,
                start=o.start,
                end=o.end,
            )
        )
    return out


def write_sibelia_outputs(
    blocks: Sequence[Occ],
    names: Sequence[str],
    sizes: Sequence[int],
    out_dir: str,
) -> None:
    os.makedirs(out_dir, exist_ok=True)
    sep = "-" * 80 + "\n"
    with open(os.path.join(out_dir, "blocks_coords.txt"), "w") as f:
        f.write("Seq_id\tSize\tDescription\n")
        for i, (n, s) in enumerate(zip(names, sizes), start=1):
            f.write(f"{i}\t{s}\t{n}\n")
        f.write(sep)
        by_id: Dict[int, List[Occ]] = {}
        for o in blocks:
            by_id.setdefault(abs(o.block), []).append(o)
        for bid in sorted(by_id):
            f.write(f"Block #{bid}\nSeq_id\tStrand\tStart\tEnd\tLength\n")
            for o in by_id[bid]:
                if o.block > 0:
                    start, end = o.start + 1, o.end
                else:
                    start, end = sizes[o.chr] - o.start, sizes[o.chr] - o.end + 1
                f.write(
                    f"{o.chr + 1}\t{'+' if o.block > 0 else '-'}\t{start}\t{end}\t{o.length}\n"
                )
            f.write(sep)
    with open(os.path.join(out_dir, "genomes_permutations.txt"), "w") as f:
        for c, n in enumerate(names):
            row = sorted((o for o in blocks if o.chr == c), key=lambda o: o.start)
            f.write(f">{n}\n")
            f.write(" ".join(f"{'+' if o.block > 0 else ''}{o.block}" for o in row))
            f.write(" $\n")
    with open(os.path.join(out_dir, "coverage_report.txt"), "w") as f:
        f.write("Seq_id\tSize\tCovered\tPercent\n")
        for c, (n, s) in enumerate(zip(names, sizes)):
            cov = sum(o.length for o in blocks if o.chr == c)
            f.write(f"{c + 1}\t{s}\t{cov}\t{100.0 * cov / s if s else 0:.2f}\n")


def run(
    input_path: str,
    out_dir: str,
    block_sizes: Sequence[int] = (5000,),
    stages: Sequence[Tuple[int, int]] = DEFAULT_STAGES,
) -> None:
    if input_path.endswith(".maf"):
        occs, names, sizes = parse_maf_blocks(input_path)
    else:
        occs, names, sizes = parse_gff_blocks(input_path)
    for mbs in block_sizes:
        blocks = build_synteny(occs, len(names), mbs, stages)
        write_sibelia_outputs(
            blocks, names, sizes, os.path.join(out_dir, str(mbs))
        )
