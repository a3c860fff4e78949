"""Row scatter-add: the K8 kernel and its plain version.

Counterpart of ``cpc_audio_tpu/ops/pallas/scatter_add.py``
``scatter_add_rows``: ``out (n_rows, C) float32 = sum_j onehot(keys[j]) *
updates[j]``, the backward of the exact and rolled negative samplers'
row gather (``criterion/infonce.py``), which adds B*W*N update rows of C
channels into the (B*S, C) pool: 475,136 rows into 4096 at the default
config, B = 32.

:func:`scatter_add_rows` prepares what the JAX wrapper leaves to XLA
(scatter_add.py:141-154): a stable sort of the keys, giving ``order``,
and per-row start offsets by ``searchsorted``
(:func:`sort_keys`).  K8 (csrc/scatter_add.cu, :func:`scatter_add_sorted`,
counted in ``scatter_add_rows.launches``) then sums each destination
row's run in float32 in sorted order and writes the row once: no float
atomics, the same bits on every run.  It has no capacity limit and so no
counterpart of the Pallas wrapper's window and its ``lax.cond`` fallback
to the XLA scatter (scatter_add.py:19-23, 156-165): any distribution of
keys, all on one row included, is summed by K8 itself.  Keys outside
[0, n_rows) add nothing on the card; the plain version raises on them.

One difference from the Pallas kernel: it rounds each update row to bf16
before its one-hot product (scatter_add.py:76-79), while K8 adds the rows
in the dtype they come in.  For bf16 updates, which the train path feeds,
the two are the same sum; for float32 updates K8 gives the exact scatter
(``zeros.at[keys].add``) that the JAX exact sampler differentiates
through, up to the order of the sum.

CPU tensors take the plain versions: :func:`scatter_add_rows_ref`
(``index_add_`` into float32 zeros) and :func:`scatter_add_sorted_ref`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

_NAME = "scatter_add_rows"
def supported(C: int, dtype: torch.dtype) -> Optional[str]:
    """Why the kernel refuses rows of C elements of ``dtype``, or None:
    a row must be whole 16-byte chunks (C a multiple of 8 in bf16, of 4
    in float32); a warp adds 4096 bytes of a row, and a wider row is
    walked in such pieces, one warp each (csrc/scatter_add.cu)."""
    row_bytes = C * torch.empty((), dtype=dtype).element_size()
    if row_bytes % 16 != 0 or row_bytes <= 0:
        return f"C = {C}: a row must be a positive multiple of 16 bytes"
    return None


def scatter_add_rows_ref(updates: torch.Tensor, keys: torch.Tensor,
                         n_rows: int) -> torch.Tensor:
    """Plain version: float32 ``index_add_`` of ``updates`` (J, C) into
    (n_rows, C) zeros at rows ``keys`` (J,)."""
    out = torch.zeros((n_rows, updates.shape[1]), dtype=torch.float32,
                      device=updates.device)
    return out.index_add_(0, keys.long(), updates.float())


def sort_keys(keys: torch.Tensor, n_rows: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order (J,), offsets (n_rows + 1,)), both int32: ``order`` lists the
    update rows by ascending key, ties by index (a stable sort), and
    ``offsets[r]`` counts the keys below r, so row r's updates are
    ``order[offsets[r]:offsets[r + 1]]``."""
    skeys, order = torch.sort(keys.to(torch.int32), stable=True)
    bounds = torch.arange(n_rows + 1, dtype=torch.int32, device=keys.device)
    offsets = torch.searchsorted(skeys, bounds, out_int32=True)
    return order.to(torch.int32), offsets


def scatter_add_sorted_ref(updates: torch.Tensor, order: torch.Tensor,
                           offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of K8 on the sorted form: row r is the float32 sum of
    ``updates[order[offsets[r]:offsets[r + 1]]]``."""
    n_rows = offsets.shape[0] - 1
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=updates.device),
        (offsets[1:] - offsets[:-1]).long())
    out = torch.zeros((n_rows, updates.shape[1]), dtype=torch.float32,
                      device=updates.device)
    lo, hi = int(offsets[0]), int(offsets[-1])   # keys in [0, n_rows)
    return out.index_add_(0, rows, updates[order[lo:hi].long()].float())


def scatter_add_sorted(updates: torch.Tensor, order: torch.Tensor,
                       offsets: torch.Tensor) -> torch.Tensor:
    """K8 on the sorted form of :func:`sort_keys`: (n_rows, C) float32.
    CPU tensors run :func:`scatter_add_sorted_ref`; CUDA tensors launch the
    kernel and add one to ``scatter_add_rows.launches``."""
    if not _build.runs_kernel(_NAME, updates, order, offsets):
        return scatter_add_sorted_ref(updates, order, offsets)
    _build.require(updates.dim() == 2, _NAME,
                   f"updates must be (J, C), got {tuple(updates.shape)}")
    J, C = updates.shape
    n_rows = offsets.shape[0] - 1
    _build.check_inputs(_NAME, updates.dtype, updates=updates)
    for arg, t, n in (("order", order, J), ("offsets", offsets, n_rows + 1)):
        _build.require(t.dtype == torch.int32 and t.is_contiguous()
                       and tuple(t.shape) == (n,), _NAME,
                       f"{arg} must be contiguous int32 ({n},), got "
                       f"{t.dtype} {tuple(t.shape)}")
    why = supported(C, updates.dtype)
    _build.require(why is None, _NAME, why or "")
    _build.require(J < 2 ** 31 and n_rows < 2 ** 31, _NAME,
                   f"J = {J}, n_rows = {n_rows} exceed int32")
    _build.require_aligned(_NAME, updates=updates)
    out = torch.empty((n_rows, C), dtype=torch.float32, device=updates.device)
    if n_rows == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(updates.device):
        status = lib.cpc_scatter_add(
            updates.data_ptr(), order.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), n_rows, C, _build.DTYPE_CODES[updates.dtype],
            _build.stream(updates.device))
    _build.check(status, _NAME)
    scatter_add_rows.launches += 1
    return out


def scatter_add_rows(updates: torch.Tensor, keys: torch.Tensor,
                     n_rows: int) -> torch.Tensor:
    """Sum-scatter ``updates`` (J, C) into an (n_rows, C) float32 table at
    rows ``keys`` (J,).  CPU tensors run :func:`scatter_add_rows_ref`; CUDA
    tensors sort the keys (:func:`sort_keys`) and launch K8."""
    if not _build.runs_kernel(_NAME, updates, keys):
        return scatter_add_rows_ref(updates, keys, n_rows)
    _build.require(keys.dim() == 1 and keys.shape[0] == updates.shape[0],
                   _NAME, f"keys {tuple(keys.shape)} for updates "
                   f"{tuple(updates.shape)}")
    return scatter_add_sorted(updates, *sort_keys(keys, n_rows))


scatter_add_rows.launches = 0
