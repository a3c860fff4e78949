"""Data parallelism of the port: one process drives one device, over
``torch.distributed``.

Counterpart of two JAX modules:

* ``cpc_audio_tpu/parallel/mesh.py``: the 1-D ``data`` mesh becomes the
  ranks of the default process group, and ``shard_batch`` becomes "a rank
  holds its rows" (:func:`rank_rows`): rank r takes rows ``[r*b,
  (r+1)*b)`` of the global batch, the rows device r of the mesh holds.
* ``cpc_audio_tpu/parallel/distributed.py``: ``initialize_distributed``
  becomes :func:`env_group` (torchrun's variables, the multi-host
  case) and :func:`spawn` (N processes on one host), and
  :func:`shard_sequences` is its own copy.

The collectives that ``shard_map`` gives the JAX step are built on
``all_reduce`` alone, so the same code runs on NCCL, and on gloo with CUDA
or CPU tensors: ``psum`` is :func:`sum_`, ``pmean`` is :func:`mean_`, and
the global negative pool's tiled ``all_gather`` (whose transpose is
``psum_scatter``) is :func:`gather_rows`.  Without a process group every
function here is the identity, so one device runs the code it ran
before.  The backend follows the device (NCCL on CUDA, gloo on the CPU);
:func:`init` takes an explicit ``backend`` for a caller that puts several
gloo ranks on one card.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, \
    TypeVar

import torch
import torch.distributed as dist

T = TypeVar("T")


def world() -> int:
    """The number of ranks; 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def resolve_world(n_gpu: int, device=None) -> int:
    """The number of ranks ``--nGPU`` asks for, by the JAX package's rule
    (cpc_audio_tpu/train.py:363-366): at most 0 means every local device,
    else ``min(n_gpu, devices)``.  On the CPU (``device="cpu"``, the tests)
    it is ``n_gpu`` itself, and -1 means 1."""
    if device is not None and torch.device(device).type == "cpu":
        return max(n_gpu, 1)
    n_avail = torch.cuda.device_count()
    return n_avail if n_gpu <= 0 else min(n_gpu, n_avail)


def shard_sequences(seq_names: Sequence[T],
                    process_index: Optional[int] = None,
                    process_count: Optional[int] = None) -> List[T]:
    """Rank ``process_index``'s strided shard of the file list (the JAX
    package's ``shard_sequences``): disjoint across ranks, covering the
    list, the identity for one process."""
    pi = rank() if process_index is None else process_index
    pc = world() if process_count is None else process_count
    if pc <= 1:
        return list(seq_names)
    return list(seq_names)[pi::pc]


def rank_rows(x):
    """This rank's rows ``[r*b, (r+1)*b)`` of a global batch of ``n*b``
    rows (numpy or torch), the rows device r of the JAX mesh gets; None
    stays None."""
    r, n = rank(), world()
    if x is None or n == 1:
        return x
    b = x.shape[0] // n
    if b * n != x.shape[0]:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                         f"over {n} ranks")
    return x[r * b:(r + 1) * b]


def backend(device) -> str:
    """NCCL on CUDA, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init(r: int, n: int, device, init_method: str,
         backend_name: Optional[str] = None) -> None:
    """Join the default process group as rank ``r`` of ``n``; the backend
    follows ``device`` unless ``backend_name`` names one."""
    device = torch.device(device)
    name = backend_name or backend(device)
    kwargs = {"device_id": device} if name == "nccl" else {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(name, init_method=init_method, rank=r,
                            world_size=n, **kwargs)


def close() -> None:
    """Leave the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def env_group(device=None) -> Iterator[torch.device]:
    """The multi-host case (``--distributed``): join the group that
    torchrun's variables describe (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; ``env://``) and yield
    this rank's device, ``cuda:LOCAL_RANK``, or the CPU where ``device``
    asks for it.  Leaves the group on exit."""
    r, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: --distributed runs one "
                               "process a GPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    init(r, n, device, "env://")
    try:
        with quiet_unless_rank0():
            yield device
    finally:
        close()


@contextlib.contextmanager
def quiet_unless_rank0():
    """Only rank 0 prints: the others' standard output goes nowhere."""
    if rank() == 0:
        yield
        return
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


def _spawned(r: int, n: int, store: str, fn: Callable, device, args):
    if device.type == "cuda":
        device = torch.device("cuda", r)
    else:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    init(r, n, device, f"file://{store}")
    try:
        with quiet_unless_rank0():
            rc = fn(device, *args)
    finally:
        close()
    if rc:
        sys.exit(rc)


def spawn(fn: Callable, n: int, device, args: tuple = ()) -> int:
    """Run ``fn(device, *args)`` in ``n`` processes started by ``spawn``
    (never fork: CUDA may be initialised here), rank r on ``cuda:r`` or,
    for a CPU ``device``, on the CPU; the group meets through a file store
    in a new temporary directory.  Returns the first non-zero exit code of
    a rank, else 0; a rank that raises raises here."""
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="cpc_ranks_")
    try:
        mp.start_processes(_spawned, args=(n, os.path.join(tmp, "store"), fn,
                                           torch.device(device), args),
                           nprocs=n, join=True, start_method="spawn")
    except mp.ProcessExitedException as e:
        return e.exit_code
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


# ---- collectives ------------------------------------------------------------

def _coalesced(tensors: Iterable[torch.Tensor], reduce: Callable) -> None:
    """Apply ``reduce`` to one flat buffer per dtype holding ``tensors``,
    and copy the result back into them in place."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        reduce(flat)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


def sum_(tensors: Iterable[torch.Tensor]) -> None:
    """``psum`` in place: every tensor becomes its sum over ranks."""
    if dist.is_initialized():
        _coalesced(tensors, dist.all_reduce)


def mean_(tensors: Iterable[torch.Tensor]) -> None:
    """``pmean`` in place: the sum over ranks over the world size."""
    if dist.is_initialized():
        n = world()

        def reduce(flat):
            dist.all_reduce(flat)
            flat.div_(n)
        _coalesced(tensors, reduce)


def broadcast_(tensors: Iterable[torch.Tensor]) -> None:
    """Every rank takes rank 0's values, in place."""
    if dist.is_initialized():
        _coalesced(tensors, lambda flat: dist.broadcast(flat, 0))


def agree_int(value: int, device, op=None) -> int:
    """One integer agreed by every rank: rank 0's (``op=None``), or the
    reduction ``op`` (e.g. ``dist.ReduceOp.MIN``) over ranks."""
    if not dist.is_initialized():
        return value
    t = torch.tensor([value], dtype=torch.int64, device=device)
    if op is None:
        dist.broadcast(t, 0)
    else:
        dist.all_reduce(t, op=op)
    return int(t.item())


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def same_length(loader, device) -> Iterable:
    """Every rank takes the same number of batches from a loader of its
    own shard (a rank that left the loop early would hang the others'
    collectives): the smallest ``len(loader)`` over ranks, iterating the
    loader again where it yields fewer than its length promised.  One
    rank takes the loader as it is."""
    if world() == 1:
        return loader
    return _take(loader, agree_int(len(loader), device, dist.ReduceOp.MIN))


def _take(loader, n: int) -> Iterator:
    taken = 0
    while taken < n:
        before = taken
        for item in loader:
            yield item
            taken += 1
            if taken == n:
                return
        if taken == before:
            raise ValueError("a rank's loader yields no batch")


class _GatherRows(torch.autograd.Function):
    """The (world*B, ...) concatenation of every rank's x in rank order,
    JAX's tiled ``all_gather``: a zero buffer holding this rank's rows,
    summed over ranks (adding zeros is exact).  The backward is its
    transpose, ``psum_scatter``: the cotangent summed over ranks, this
    rank's rows of it."""

    @staticmethod
    def forward(ctx, x):
        b = x.shape[0]
        ctx.rows = slice(rank() * b, (rank() + 1) * b)
        pool = x.new_zeros((world() * b,) + tuple(x.shape[1:]))
        pool[ctx.rows] = x
        dist.all_reduce(pool)
        return pool

    @staticmethod
    def backward(ctx, dpool):
        dpool = dpool.contiguous().clone()
        dist.all_reduce(dpool)
        return dpool[ctx.rows]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's x stacked on axis 0 in rank order, differentiable
    (:class:`_GatherRows`); x itself at world size 1."""
    if world() == 1:
        return x
    return _GatherRows.apply(x)
