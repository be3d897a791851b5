"""Tensor-parallel execution on a serving mesh: one rank's program, and
where its shards combine.

The model code (``repro_torch.models``) is written once, for one rank:
each layer takes an optional ``tp`` (a ``RankContext``) and, with one,
computes its rank's shard and combines the shards where the math needs it:

* ``tp.fold(x, axis)``: the partials of a row-parallel product (``wo``,
  ``w_down``, ``out_proj``, ``x_proj``: the contracted dim is cut), the
  vocabulary-cut embedding and the expert combine, folded in rank order
  (``ota_collectives.fold_shards``, a fixed left fold: ``((p_0 + p_1) + p_2)
  ...``); ``op=torch.maximum`` for a softmax's running max;
* ``tp.gather(x, axis)``: every rank's tensor stacked in rank order (the
  vocabulary-cut logits, q before a sequence-cut decode).

An axis is a name or a tuple of names, the flattened axis in rank order
(``("pod", "data")``: index ``p * data + d``), so a fold over the tuple on
a (pod, data, model) mesh is the fold over ``data`` of the mesh with the
two axes merged.  On a physical mesh a fold is a fixed-order
reduce-scatter and an all-gather over the axis's process group
(``ota_collectives.fold_over``: each rank folds its chunk of every rank's
tensor, in rank order, then the chunks are gathered), and a gather is
``gather_shards``; on an emulated mesh the stacks come from the
other ranks' threads (``run_ranks``).  Either way every element is folded
from the same operands in the same order, so a physical mesh gives the
emulated mesh's bits.  No all-reduce: its summation order is the
library's, not the fold's.

``run_ranks(mesh, program)`` runs ``program(ctx)`` for every rank this
process holds.  On an emulated mesh the ranks run in turn on threads, one
at a time: rank 0 runs to its first collective, then rank 1, ..., and the
last rank to arrive combines the stacks, after which rank 0 goes on.  So
one rank's kernels run at a time, as the physical rank's would, and a
rank's program is the same code on both meshes.

Training.  ``fold`` and ``gather`` carry a backward, and ``enter`` is
their conjugate, so that a rank's program differentiates as one model:

* ``fold`` (a row-parallel output): forward the fold, backward the
  identity (every rank's partial is read by the whole folded output);
* ``enter`` (a replicated tensor entering rank-partial work, such as the
  input of a column-parallel product): forward the identity, backward the
  fold of the ranks' partial gradients;
* ``gather``: backward the rank's own slice of the gradient of the stack
  (everything after a gather runs replicated).

Placed exactly on the boundary between replicated and rank-partial work,
they make every replicated leaf's gradient complete and the same bits on
every model rank, with no fold after the backward.  A backward fold is a
collective of its own, made when autograd reaches it: the ranks of an
emulated mesh run their backwards on their own threads
(``torch.autograd.set_multithreading_enabled(False)`` in ``run_ranks``),
since on autograd's one device thread a rank waiting in a fold would keep
the others' backwards from running.  A wait for a rank's turn longer than
``run_ranks``' ``timeout`` fails every rank with the rank that stopped.

A checkpointed superblock is recomputed in the backward, where its forward
collectives must not run again.  Inside ``ctx.recorded()`` every forward
collective made in a ``ctx.scope(key)`` (a superblock, a chunk) keeps its
result under ``(key, n)``, its place in the scope, and the recompute of
that scope takes it from there: the same bits, no collective.  The
backward folds are not recorded.

FSDP.  ``ctx.unshard(xs, dims, axis)`` is the gather of parameter leaves
cut over ``axis`` (``data``): forward, each leaf's slices concatenated
along its cut dim in rank order (one collective for all the leaves);
backward, the whole leaves' gradients folded over the axis in rank order
(the fold ``fold`` uses; none where the batch is not cut over the axis,
``batch_split``) and the rank's slice kept: on a physical mesh only the
reduce-scatter half of the fold, each rank's slices sent to it
(``ota_collectives.fold_scatter``).  A gather is exact, so it is
not recorded: a checkpoint's recompute gathers again, and the whole
leaves do not outlive their superblock.  Every rank's backward runs the
same graph, so the ranks reach the recompute's gathers in one order.
"""
from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.distribution.ota_collectives import fold_over, \
    fold_scatter, fold_shards, gather_shards

# a mesh axis: a name, or a tuple of names (the flattened axis)
Axis = Union[str, Tuple[str, ...]]

# the RankContext whose program runs on this thread (``run_ranks``)
_RUNNING = threading.local()


class RankContext:
    """One rank of a ``ServingMesh``: its coordinates and its collectives.
    ``index`` is its place among the ranks this process runs (0 on a
    physical mesh, the rank on an emulated one)."""

    def __init__(self, mesh, rank: int, index: int,
                 lockstep: Optional["_Lockstep"] = None):
        self.mesh, self.rank, self.index = mesh, rank, index
        self.d, self.m = mesh.coords(rank)
        self.p = mesh.axis_coords(rank)["pod"]
        self.data, self.model = mesh.data, mesh.model
        self._lockstep = lockstep
        # whether the batch's rows are cut over ``batch_axis`` (the serve
        # and train steps set both): a function of the whole batch (the
        # MoE's capacity, its pairs' slots, its aux losses) then counts
        # every rank's rows along it
        self.batch_split = False
        self.batch_axis: Axis = "data"
        # the axis the parameter leaves with an FSDP rule are cut over
        # (``distribution.sharding.fsdp_dim``), or None: the train step
        # sets it, and the models gather those leaves (``unshard``)
        self.fsdp_axis: Optional[Axis] = None
        self._log = None       # {(scope key, n, axis): result} in recorded()
        self._scope = None      # [scope key, collectives so far] in scope()

    @contextlib.contextmanager
    def recorded(self):
        """Keep the result of every collective made in a ``scope`` while
        this is open (a training step's forward and backward)."""
        self._log = {}
        try:
            yield
        finally:
            self._log = None

    @property
    def recorded_bytes(self) -> int:
        """Bytes of the results the open ``recorded()`` log holds (0 when
        none is open)."""
        return sum(t.numel() * t.element_size()
                   for t in (self._log or {}).values())

    @contextlib.contextmanager
    def scope(self, key):
        """The collectives of one checkpointed region, numbered from 0 each
        time it runs (its forward, then its recompute)."""
        outer, self._scope = self._scope, [key, 0]
        try:
            yield
        finally:
            self._scope = outer

    def size(self, axis: Axis) -> int:
        """Ranks along ``axis`` (a name, or a tuple: the flattened axis)."""
        return self.mesh.axis_size(self.mesh.canonical(axis))

    def coord(self, axis: Axis) -> int:
        """This rank's index along ``axis`` (a tuple: row-major)."""
        return self.mesh.axis_index(self.rank, self.mesh.canonical(axis))

    def _collective(self, axis: str, run: Callable[[], torch.Tensor]
                    ) -> torch.Tensor:
        """``run()``, or inside ``recorded()`` and a ``scope`` the result
        that this collective's place in the scope kept the first time."""
        if self._log is None or self._scope is None:
            return run()
        key = (self._scope[0], self._scope[1], axis)
        self._scope[1] += 1
        if key not in self._log:
            self._log[key] = run()
        return self._log[key]

    @property
    def scope_key(self):
        """The key of the innermost open ``scope`` (None outside one)."""
        return None if self._scope is None else self._scope[0]

    def _gather_now(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The gather's collective itself (never recorded)."""
        axis = self.mesh.canonical(axis)
        if self._lockstep is None:
            return gather_shards(x.contiguous(), self.mesh.groups[axis])
        return self._lockstep.exchange(self.rank, axis, x)

    @property
    def shares_folds(self) -> bool:
        """Whether a fold's result is shared with the other ranks of its
        group (an emulated mesh folds once for them), so that it must not
        be written in place."""
        return self._lockstep is not None

    def _fold_now(self, x: torch.Tensor, axis: str, op=torch.add
                  ) -> torch.Tensor:
        """The fold's collective itself (never recorded).  Physical:
        ``fold_over``'s reduce-scatter and all-gather.  Emulated: folded
        once for the ranks of a group, which share the result (the same
        bits each rank's own fold would give)."""
        axis = self.mesh.canonical(axis)
        if self._lockstep is None:
            return fold_over(x, self.mesh.groups[axis], op)
        return self._lockstep.exchange(
            self.rank, axis, x, reduce=lambda st: fold_shards(st, op))

    def gather(self, x: torch.Tensor, axis: Axis = "model") -> torch.Tensor:
        """Every rank's ``x`` along ``axis`` stacked in rank order (a new
        leading axis); its backward takes the rank's own slice."""
        axis = self.mesh.canonical(axis)
        if self.size(axis) == 1:
            return x[None]
        return _Gather.apply(x, self, axis)

    def fold(self, x: torch.Tensor, axis: Axis = "model",
             op=torch.add) -> torch.Tensor:
        """The left fold of every rank's ``x`` along ``axis``, in rank
        order; one rank: ``x`` itself.  A sum's backward is the identity;
        another ``op`` (a softmax's running max) carries no gradient."""
        axis = self.mesh.canonical(axis)
        if self.size(axis) == 1:
            return x
        if op is not torch.add:
            with torch.no_grad():
                return self._collective(axis, lambda: self._fold_now(
                    x.detach(), axis, op))
        return _Fold.apply(x, self, axis)

    def enter(self, x: torch.Tensor, axis: Axis = "model") -> torch.Tensor:
        """``x`` (the same on every rank of ``axis``) as it enters work that
        each rank does on its part: the identity, whose backward folds the
        ranks' partial gradients."""
        axis = self.mesh.canonical(axis)
        if self.size(axis) == 1:
            return x
        return _Enter.apply(x, self, axis)

    def unshard(self, xs: Sequence[torch.Tensor], dims: Sequence[int],
                axis: Axis = "data") -> tuple:
        """The whole leaves of the rank's slices ``xs``, each cut along
        ``dims[i]`` over ``axis``: every rank's slice concatenated in rank
        order, one collective for all of them (one for each dtype).  Its
        backward folds the whole leaves' gradients over ``axis`` (where the
        batch is cut over it) and keeps the rank's slices.  Not recorded:
        a recompute gathers again."""
        axis = self.mesh.canonical(axis)
        if self.size(axis) == 1 or not xs:
            return tuple(xs)
        out: List[Optional[torch.Tensor]] = [None] * len(xs)
        for dt in dict.fromkeys(x.dtype for x in xs):
            idx = [i for i, x in enumerate(xs) if x.dtype == dt]
            whole = _Unshard.apply(self, axis, tuple(dims[i] for i in idx),
                                   *(xs[i] for i in idx))
            for i, w in zip(idx, whole):
                out[i] = w
        return tuple(out)

    def __repr__(self):
        return f"RankContext(rank={self.rank}, d={self.d}, m={self.m})"


def _own(t: torch.Tensor, rc: RankContext) -> torch.Tensor:
    """A backward fold's result as this rank's own gradient: an emulated
    group's ranks share one result, and autograd may add into a gradient
    in place.  (A forward result is handed out as a ``detach``ed alias, so
    that each rank's output carries its own history.)"""
    return t if rc._lockstep is None else t.clone()


class _Fold(torch.autograd.Function):
    """The fold of a sum; backward: the folded output's gradient."""

    @staticmethod
    def forward(fctx, x, rc, axis):
        return rc._collective(axis, lambda: rc._fold_now(x, axis)).detach()

    @staticmethod
    def backward(fctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """The identity; backward: the fold of the ranks' partial gradients."""

    @staticmethod
    def forward(fctx, x, rc, axis):
        fctx.rc, fctx.axis = rc, axis
        return x

    @staticmethod
    def backward(fctx, g):
        return _own(fctx.rc._fold_now(g.contiguous(), fctx.axis),
                    fctx.rc), None, None


class _Gather(torch.autograd.Function):
    """The stack of every rank's tensor; backward: the rank's slice."""

    @staticmethod
    def forward(fctx, x, rc, axis):
        fctx.index = rc.coord(axis)
        return rc._collective(axis, lambda: rc._gather_now(x, axis)).detach()

    @staticmethod
    def backward(fctx, g):
        return g[fctx.index], None, None


class _Unshard(torch.autograd.Function):
    """Whole leaves from the ranks' slices along their cut dims (one
    gather of the slices flattened end to end); backward: the fold of the
    whole leaves' gradients (flattened end to end) over the axis where
    the batch is cut over it, then the rank's slice of each."""

    @staticmethod
    def forward(fctx, rc, axis, dims, *xs):
        fctx.rc, fctx.axis, fctx.dims = rc, axis, dims
        fctx.sizes = [x.shape[d] for x, d in zip(xs, dims)]
        stack = rc._gather_now(torch.cat([x.reshape(-1) for x in xs]), axis)
        out, off = [], 0
        for x, d in zip(xs, dims):
            n = x.numel()
            out.append(torch.cat([s[off:off + n].view(x.shape)
                                  for s in stack.unbind(0)], dim=d))
            off += n
        return tuple(out)

    @staticmethod
    def backward(fctx, *gs):
        rc, axis = fctx.rc, fctx.axis
        if rc.batch_split and not rc.shares_folds:
            return (None, None, None, *_fold_slices(rc, axis, gs, fctx.dims,
                                                    fctx.sizes))
        flat = torch.cat([g.reshape(-1) for g in gs])
        if rc.batch_split:
            flat = rc._fold_now(flat, axis)
        i = rc.coord(axis)
        out, off = [], 0
        for g, d, size in zip(gs, fctx.dims, fctx.sizes):
            whole = flat[off:off + g.numel()].view(g.shape)
            out.append(whole.narrow(d, i * size, size).clone())
            off += g.numel()
        return (None, None, None, *out)


def _fold_slices(rc: RankContext, axis: str, gs, dims, sizes) -> list:
    """A physical rank's slices of the whole leaves' gradients ``gs`` (each
    cut along ``dims[i]`` in slices of ``sizes[i]``), folded over ``axis``
    in rank order: the send buffer holds rank j's slices of every leaf,
    flattened end to end, in chunk j, and ``fold_scatter`` folds this
    rank's chunk.  The fold-then-slice's bits, at a reduce-scatter's
    bytes."""
    send = torch.cat([g.narrow(d, j * size, size).reshape(-1)
                      for j in range(rc.size(axis))
                      for g, d, size in zip(gs, dims, sizes)])
    mine = fold_scatter(send, rc.mesh.groups[axis])
    out, off = [], 0
    for g, d, size in zip(gs, dims, sizes):
        shape = list(g.shape)
        shape[d] = size
        n = math.prod(shape)
        out.append(mine[off:off + n].view(shape))
        off += n
    return out


class _Aborted(Exception):
    """Another rank's program raised: this one stops."""


class _Lockstep:
    """The collectives of an emulated mesh: n rank programs on threads, one
    running at a time, in rank order between two collectives."""

    def __init__(self, mesh, timeout: float):
        self.mesh, self.n = mesh, mesh.size
        self.timeout = timeout
        self.cv = threading.Condition()
        self.turn = 0
        self.slots: List[Any] = [None] * self.n
        self.results: List[Any] = [None] * self.n
        self.done = [False] * self.n
        self.error: Optional[BaseException] = None

    def _wait(self, rank: int) -> None:
        if not self.cv.wait_for(lambda: self.turn == rank
                                or self.error is not None, self.timeout):
            self._fail(TimeoutError(
                f"emulated mesh: rank {self.turn} did not reach its next "
                f"collective within {self.timeout:g} s (rank {rank} waited "
                "for it)"))
        if self.error is not None:
            raise _Aborted()

    def _fail(self, err: BaseException) -> None:
        if self.error is None:
            self.error = err
        self.cv.notify_all()

    def start(self, rank: int) -> None:
        with self.cv:
            self._wait(rank)

    def finish(self, rank: int) -> None:
        with self.cv:
            self.done[rank] = True
            if any(s is not None for s in self.slots):
                self._fail(RuntimeError(
                    f"emulated mesh: rank {rank} ended while other ranks "
                    "wait in a collective (the ranks' programs diverged)"))
                return
            self.turn = rank + 1
            self.cv.notify_all()

    def exchange(self, rank: int, axis: str, x: torch.Tensor,
                 reduce=None) -> torch.Tensor:
        """Every rank's ``x`` along ``axis`` stacked in rank order, or
        ``reduce`` of that stack (computed once a group; every rank calls
        an exchange with the same ``reduce``)."""
        with self.cv:
            self.slots[rank] = (axis, tuple(x.shape), x, reduce)
            if rank == self.n - 1:
                self._combine()
            else:
                self.turn = rank + 1
                self.cv.notify_all()
            self._wait(rank)
            return self.results[rank]

    def _combine(self) -> None:
        """Called by the last rank: every rank's stack, then rank 0's turn."""
        if any(self.done) or len({s[:2] for s in self.slots}) != 1:
            self._fail(RuntimeError(
                "emulated mesh: the ranks reached different collectives "
                f"({[None if s is None else s[:2] for s in self.slots]})"))
            raise _Aborted()
        axis, reduce = self.slots[0][0], self.slots[0][3]
        stacks = {}
        for r in range(self.n):
            key = self.mesh.members(r, axis)
            if key not in stacks:
                stacks[key] = torch.stack([self.slots[j][2] for j in key])
                if reduce is not None:
                    stacks[key] = reduce(stacks[key])
            self.results[r] = stacks[key]
        self.slots = [None] * self.n
        self.turn = 0
        self.cv.notify_all()


# the longest a rank of an emulated mesh waits for its turn: the other
# ranks' work between two collectives (a layer's forward or backward, a
# leaf's OTA transform) takes well under a second on the card
RANK_TIMEOUT_S = 120.0


def running_context() -> Optional[RankContext]:
    """The RankContext whose ``run_ranks`` program runs on this thread, or
    None outside one."""
    return getattr(_RUNNING, "ctx", None)


def _run_as(program: Callable[[RankContext], Any], ctx: RankContext) -> Any:
    """``program(ctx)``, with ``ctx`` this thread's ``running_context``."""
    outer, _RUNNING.ctx = running_context(), ctx
    try:
        return program(ctx)
    finally:
        _RUNNING.ctx = outer


def run_ranks(mesh, program: Callable[[RankContext], Any], *,
              timeout: float = RANK_TIMEOUT_S) -> list:
    """``program(ctx)`` for every rank this process runs, in rank order:
    the one rank of a physical mesh, or every rank of an emulated one in
    turn.  The threads of an emulated mesh take over the caller's grad and
    inference modes, CUDA device and stream, and run their backwards on
    themselves (not on autograd's device threads).  A rank that keeps the
    others waiting longer than ``timeout`` seconds for its turn fails the
    run with a ``TimeoutError`` that names it."""
    if mesh.physical:
        return [_run_as(program, RankContext(mesh, mesh.rank, 0))]
    if mesh.size == 1:
        return [_run_as(program, RankContext(mesh, 0, 0))]
    lock = _Lockstep(mesh, timeout)
    out: List[Any] = [None] * mesh.size
    inference = torch.is_inference_mode_enabled()
    grad = torch.is_grad_enabled()
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    device = torch.cuda.current_device() if cuda else None
    stream = torch.cuda.current_stream() if cuda else None

    def body(rank: int) -> None:
        try:
            lock.start(rank)
            with torch.inference_mode(inference), \
                    torch.set_grad_enabled(grad), \
                    torch.autograd.set_multithreading_enabled(False):
                if cuda:
                    with torch.cuda.device(device), torch.cuda.stream(stream):
                        out[rank] = _run_as(program, RankContext(
                            mesh, rank, rank, lock))
                else:
                    out[rank] = _run_as(program,
                                        RankContext(mesh, rank, rank, lock))
            lock.finish(rank)
        except _Aborted:
            pass
        except BaseException as err:        # noqa: BLE001 - re-raised below
            with lock.cv:
                lock._fail(err)

    threads = [threading.Thread(target=body, args=(r,),
                                name=f"repro-tp-rank{r}", daemon=True)
               for r in range(mesh.size)]
    for t in threads:
        t.start()
    for t in threads:
        while t.is_alive() and lock.error is None:
            t.join(1.0)
    if lock.error is not None:
        # the ranks stop at their next wait; one stuck elsewhere (inside
        # autograd, on the card) is left behind as a daemon thread
        deadline = time.monotonic() + min(timeout, 10.0)
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        raise lock.error
    return out
