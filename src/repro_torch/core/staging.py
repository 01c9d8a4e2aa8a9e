"""Pinned staging ring for the batches the trainer moves to the card.

Each batch crosses the bus from one slot of a ring of pinned host buffers:
its arrays are packed into the slot back to back (each at a 256-byte
aligned offset), ONE asynchronous copy moves the used bytes into one device
buffer on the caller's current stream — the trainer's upload stream — and
the batch's tensors are views of that buffer. The copy records an event,
and the slot is refilled only after that event has completed, so a slot is
never overwritten under a copy in flight; the wait blocks the filling
thread only, never the device. Rows the caller gathers itself (the miss
rows of the resident path) are written straight into the slot
(:meth:`UploadPack.add_fill`), so they cross host memory once.

Slots start empty and grow to the largest batch they have carried: the
resident path's miss rows are a small and varying share of their
worst-case capacity, so no slot is sized for the worst case up front.

On the CPU the copy is a plain clone of the used bytes: the views must not
alias a slot that a later batch refills.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

ALIGN = 256


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _nbytes(shape, dtype: np.dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * dtype.itemsize


def pack_offsets(specs) -> Tuple[List[int], int]:
    """Byte offsets of arrays of the given ``(shape, dtype)`` packed back to
    back into one buffer, each at an ``ALIGN``-aligned offset, and the
    buffer's size."""
    offs, total = [], 0
    for shape, dtype in specs:
        offs.append(total)
        total += (_nbytes(shape, dtype) + ALIGN - 1) // ALIGN * ALIGN
    return offs, total


def typed_view(buf: torch.Tensor, off: int, shape,
               dtype: np.dtype) -> torch.Tensor:
    """The ``(shape, dtype)`` array at byte ``off`` of the uint8 ``buf``."""
    return buf[off:off + _nbytes(shape, dtype)].view(
        _torch_dtype(dtype)).view(shape)


class UploadPack:
    """The arrays of one batch, in the order they are packed: each entry is
    ``(key, index, shape, dtype, source)`` where ``index`` is the layer of a
    per-layer list (None for a single array) and ``source`` is an array to
    copy or a callable that fills the slot's view in place."""

    def __init__(self):
        self.entries: List[tuple] = []

    def add(self, key: str, value) -> None:
        """One array, or a per-layer list of arrays (the key then maps to a
        list of tensors)."""
        if isinstance(value, (list, tuple)):
            for i, a in enumerate(value):
                a = np.asarray(a)
                self.entries.append((key, i, a.shape, a.dtype, a))
        else:
            a = np.asarray(value)
            self.entries.append((key, None, a.shape, a.dtype, a))

    def add_fill(self, key: str, shape: tuple, dtype,
                 fill: Callable[[np.ndarray], None]) -> None:
        """An array that ``fill(view)`` writes into the slot itself."""
        self.entries.append((key, None, tuple(shape), np.dtype(dtype), fill))


class StagingRing:
    """``slots`` pinned host buffers (plain ones on the CPU) that batches
    cross the bus from, in turn. ``wait_s`` sums the seconds a filling
    thread waited for a slot's previous copy; ``fill_s`` the seconds spent
    in :meth:`UploadPack.add_fill` callbacks."""

    def __init__(self, slots: int, device: torch.device):
        if slots < 1:
            raise ValueError("the staging ring needs at least one slot")
        self.device = device
        self._cuda = device.type == "cuda"
        self._bufs: List[Optional[torch.Tensor]] = [None] * slots
        self._events: List[Optional[torch.cuda.Event]] = [None] * slots
        self._next = 0
        self.wait_s = 0.0
        self.fill_s = 0.0

    def __len__(self) -> int:
        return len(self._bufs)

    def _slot(self, nbytes: int) -> Tuple[int, torch.Tensor]:
        k = self._next
        self._next = (k + 1) % len(self._bufs)
        ev = self._events[k]
        if ev is not None:
            t0 = time.perf_counter()
            ev.synchronize()
            self.wait_s += time.perf_counter() - t0
            self._events[k] = None
        buf = self._bufs[k]
        if buf is None or buf.numel() < nbytes:
            self._bufs[k] = buf = None  # free the old slot before growing
            buf = torch.empty(nbytes + nbytes // 4, dtype=torch.uint8,
                              pin_memory=self._cuda)
            self._bufs[k] = buf
        return k, buf

    def upload(self, pack: UploadPack) -> Tuple[Dict[str, object],
                                                 torch.Tensor]:
        """Pack one batch into the next slot and copy it to the device.
        Returns ``(tensors, base)``: ``tensors`` maps each key to its
        tensor (or per-layer list) on the device, all views of ``base``,
        the one device buffer the copy wrote. On CUDA the copy is queued
        on the current stream; its consumer must wait for that stream and
        ``record_stream`` ``base`` on its own."""
        offs, total = pack_offsets((shape, dtype) for _, _, shape, dtype, _
                                   in pack.entries)
        total = max(total, ALIGN)
        k, host = self._slot(total)
        host_np = host.numpy()
        for (key, i, shape, dtype, src), off in zip(pack.entries, offs):
            view = host_np[off:off + _nbytes(shape, dtype)].view(
                dtype).reshape(shape)
            if callable(src):
                t0 = time.perf_counter()
                src(view)
                self.fill_s += time.perf_counter() - t0
            else:
                np.copyto(view, src, casting="no")
        if self._cuda:
            stream = torch.cuda.current_stream(self.device)
            base = torch.empty(total, dtype=torch.uint8, device=self.device)
            base.copy_(host[:total], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
            self._events[k] = ev
        else:
            base = host[:total].clone()
        out: Dict[str, object] = {}
        for (key, i, shape, dtype, _), off in zip(pack.entries, offs):
            t = typed_view(base, off, shape, dtype)
            if i is None:
                out[key] = t
            else:
                out.setdefault(key, []).append(t)
        return out, base
