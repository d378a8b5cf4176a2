"""The port's multi-process graph stage (parallel/multihost.py) over gloo on
the CPU: every rank of 2 and of 4 processes returns the monolithic stage's
records at k=15 and k=33.  Each run has its own file store and its own
timeout, and its processes import no jax."""

import os
import subprocess
import sys

import numpy as np
import pytest

from sibeliaz_tpu_torch.graph import construct
from sibeliaz_tpu_torch.parallel import multihost

from torch_cases import related_genomes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
KS = (15, 33)
TIMEOUT_S = 120

_RANK = """
import sys
sys.modules["jax"] = None
sys.modules["sibeliaz_tpu"] = None
import numpy as np
import torch.distributed as dist
from sibeliaz_tpu_torch.parallel import multihost
from torch_cases import related_genomes

store, world, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
multihost.init_distributed(f"file://{store}", world, rank, backend="gloo")
try:
    multihost.Distributed("cuda:0")
    raise SystemExit("a gloo group took a CUDA device")
except ValueError:
    pass
seqs, _names = related_genomes(5, n_genomes=3, n_chr=2, length=1500, rearrange=True,
                               n_prob=0.002)
arrays = {}
for k in (15, 33):
    for c, rec in enumerate(multihost.build_junctions_multihost(seqs, k, device="cpu")):
        arrays[f"k{k}_pos{c}"], arrays[f"k{k}_ids{c}"] = rec.pos, rec.ids
np.savez(out, **arrays)
dist.destroy_process_group()
assert sys.modules["jax"] is None and sys.modules["sibeliaz_tpu"] is None
"""


def inputs():
    return related_genomes(5, n_genomes=3, n_chr=2, length=1500, rearrange=True,
                           n_prob=0.002)[0]


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_match_monolithic(tmp_path, world):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, TESTS]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(tmp_path / "store"), str(world), str(rank),
         str(tmp_path / f"rank{rank}.npz")],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]
    errors = []
    try:
        for rank, p in enumerate(procs):
            _out, err = p.communicate(timeout=TIMEOUT_S)
            if p.returncode != 0:
                errors.append(f"rank {rank} rc={p.returncode}\n{err[-2000:]}")
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank of {world} ran past {TIMEOUT_S} s")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert not errors, "\n".join(errors)
    seqs = inputs()
    for k in KS:
        mono = construct.build_junctions(seqs, k, "cpu")
        assert sum(len(r.pos) for r in mono) > 0
        for rank in range(world):
            got = np.load(tmp_path / f"rank{rank}.npz")
            for c, rec in enumerate(mono):
                assert np.array_equal(got[f"k{k}_pos{c}"], rec.pos), (k, rank, c)
                assert np.array_equal(got[f"k{k}_ids{c}"], rec.ids), (k, rank, c)


def test_init_distributed_is_a_no_op_for_one_process():
    import torch.distributed as dist

    multihost.init_distributed()
    multihost.init_distributed("file:///nonexistent/store", world_size=1, rank=0)
    assert not dist.is_initialized()


def test_one_process_runs_the_shard_in_process():
    """Without a process group, build_junctions_multihost is the in-process
    stage over its one device."""
    seqs = inputs()
    got = multihost.build_junctions_multihost(seqs, 15, device="cpu")
    for a, b in zip(got, construct.build_junctions(seqs, 15, "cpu")):
        assert np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids)
