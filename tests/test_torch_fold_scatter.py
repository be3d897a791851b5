"""The rank-order fold over a physical group as a fixed-order
reduce-scatter and an all-gather (``distribution.ota_collectives.
fold_over`` / ``fold_scatter``), on the CPU over ``gloo``:

* over 2, 3 and 4 ranks (one subprocess, a ``torch.multiprocessing`` spawn
  a group size), for ``torch.add`` and ``torch.maximum``, fp32 and bf16,
  with a numel that n does not divide: every rank's fold is bitwise
  ``fold_shards`` of the stack of every rank's tensor (the gather form's
  result), and it counts 2 parts of bytes a rank (1 all-to-all and 1
  all-gather, each the tensor's bytes), where the gather form counts n;
  so do small folds: 1,001 elements, and fewer elements than ranks (a
  2-vector and a 0-d scalar: some chunks empty);
* ``fold_scatter`` alone: a rank's chunk is the fold of every rank's chunk
  for it, at 1 part of bytes;
* on a physical (4, 1) mesh of the dry run's fake group, a mean step's
  folds count 2 parts each (its gradients, mask count, loss and
  metrics);
* the emulated mesh's lockstep fold is unchanged: the physical mesh's
  parity with it is ``tests/test_torch_tp_train.py``'s gloo tests.

torch runs on one thread in this file and in the ranks.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.analysis import roofline as rl
from repro_torch.configs import registry as reg
from repro_torch.distribution import ota_collectives as oc
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as tl
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (2, 3, 4)
DTYPES = ("float32", "bfloat16")
OPS = ("add", "maximum")
SHAPE = (37, 1801)          # 66,637 elements: none of 2, 3, 4 divides it
# small folds: 1,001 elements, and fewer elements than 3 or 4 ranks
SMALL = {"1001": (7, 143), "vector": (2,), "scalar": ()}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread in this file (and in the ranks)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rank_input(rank: int, dtype: str, shape=SHAPE) -> torch.Tensor:
    gen = torch.Generator().manual_seed(100 + rank)
    return torch.randn(shape, generator=gen).to(getattr(torch, dtype))


RANKS_SCRIPT = r'''
import os
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SHAPE = (37, 1801)
SMALL = {"1001": (7, 143), "vector": (2,), "scalar": ()}


def rank_input(rank, dtype, shape=SHAPE):
    gen = torch.Generator().manual_seed(100 + rank)
    return torch.randn(shape, generator=gen).to(getattr(torch, dtype))


def worker(rank, n, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    from repro_torch.distribution import ota_collectives as oc
    res = {}
    for dtype in ("float32", "bfloat16"):
        x = rank_input(rank, dtype)
        for name in ("add", "maximum"):
            op = getattr(torch, name)
            with oc.counting_collectives() as coll:
                res[f"{dtype}/{name}"] = oc.fold_over(x, None, op)
            res[f"{dtype}/{name}/bytes"] = dict(coll)
            for small, shape in SMALL.items():
                with oc.counting_collectives() as coll:
                    res[f"{dtype}/{name}/{small}"] = oc.fold_over(
                        rank_input(rank, dtype, shape), None, op)
                res[f"{dtype}/{name}/{small}/bytes"] = dict(coll)
        # fold_scatter alone: chunk j of the flat input is rank j's
        send = x.reshape(-1)[:(x.numel() // n) * n].contiguous()
        with oc.counting_collectives() as coll:
            res[f"{dtype}/scatter"] = oc.fold_scatter(send, None)
        res[f"{dtype}/scatter/bytes"] = dict(coll)
    torch.save(res, os.path.join(out_dir, f"n{n}_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    out_dir = sys.argv[1]
    for n in (2, 3, 4):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        mp.spawn(worker, args=(n, port, out_dir), nprocs=n)
    print("FOLDS_OK")
'''


@pytest.fixture(scope="module")
def folds(tmp_path_factory):
    """Every rank's results for each group size, from one subprocess."""
    tmp = tmp_path_factory.mktemp("fold_ranks")
    script = tmp / "folds.py"
    script.write_text(textwrap.dedent(RANKS_SCRIPT))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               MASTER_ADDR="127.0.0.1", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(script), str(tmp)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    assert r.returncode == 0 and "FOLDS_OK" in r.stdout, r.stderr[-4000:]
    return {n: [torch.load(tmp / f"n{n}_rank{r}.pt") for r in range(n)]
            for n in SIZES}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_fold_over_is_the_gather_fold_bitwise(folds, n, dtype, op):
    stack = torch.stack([rank_input(r, dtype) for r in range(n)])
    want = oc.fold_shards(stack, getattr(torch, op))
    part = stack[0].numel() * stack.element_size()     # one part
    for r, res in enumerate(folds[n]):
        got = res[f"{dtype}/{op}"]
        assert got.dtype == want.dtype and torch.equal(got, want), r
        assert res[f"{dtype}/{op}/bytes"] == dict(
            {k: 0 for k in oc.COLLECTIVES},
            **{"all-to-all": part, "all-gather": part})


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("small", list(SMALL))
def test_small_folds_are_the_gather_fold_bitwise(folds, n, dtype, op,
                                                 small):
    """A small fold, down to fewer elements than ranks (empty chunks),
    takes the same two collectives, with the gather form's bits and
    shape."""
    stack = torch.stack([rank_input(r, dtype, SMALL[small])
                         for r in range(n)])
    want = oc.fold_shards(stack, getattr(torch, op))
    part = stack[0].numel() * stack.element_size()
    for r, res in enumerate(folds[n]):
        got = res[f"{dtype}/{op}/{small}"]
        assert got.shape == want.shape and torch.equal(got, want), r
        assert res[f"{dtype}/{op}/{small}/bytes"] == dict(
            {k: 0 for k in oc.COLLECTIVES},
            **{"all-to-all": part, "all-gather": part})


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fold_scatter_is_each_ranks_chunk_folded(folds, n, dtype):
    flat = [rank_input(r, dtype).reshape(-1) for r in range(n)]
    chunk = flat[0].numel() // n
    for r, res in enumerate(folds[n]):
        want = oc.fold_shards(torch.stack(
            [f[r * chunk:(r + 1) * chunk] for f in flat]))
        assert torch.equal(res[f"{dtype}/scatter"], want), r
        assert res[f"{dtype}/scatter/bytes"]["all-to-all"] == (
            n * chunk * flat[0].element_size())
        assert sum(res[f"{dtype}/scatter/bytes"].values()) == (
            n * chunk * flat[0].element_size())


def test_mean_step_folds_count_two_parts():
    """A physical (4, 1) mesh of the dry run's fake group, the mean path:
    every fold over ``data`` (each gradient leaf, the mask count, the loss
    and its two metrics) counts one all-to-all and one all-gather of its
    size, where the gather form counted four parts."""
    cfg = dataclasses.replace(
        reg.reduce_config(reg.get_config("h2o-danube-1.8b")),
        dtype="float32")
    meta = torch.device("meta")
    params = T.init_params(cfg, torch.Generator(), device=meta)
    batch = {"tokens": torch.zeros((8, 64), dtype=torch.long, device=meta),
             "labels": torch.zeros((8, 64), dtype=torch.long, device=meta),
             "loss_mask": torch.zeros((8, 64), device=meta)}
    with dryrun.fake_group(4):
        mesh = mesh_lib.make_host_mesh(4, 1)
        assert mesh.physical
        step, place = tl.build_train_step(cfg, mesh, scheme="mean",
                                          device=meta)
        o = tl.sgd(1e-2)
        p, s, rows = place(params, o.init(params), batch)
        with oc.counting_collectives() as coll:
            step(p, s, rows)
    sizes = [t.numel() for t in tree_leaves(params)] + [1] * 4
    part = sum(n * 4 for n in sizes)
    assert coll == dict({k: 0 for k in rl.COLLECTIVES},
                        **{"all-to-all": part, "all-gather": part})
