"""Checkpoints with asynchronous writes (counterpart of
``repro.checkpoint.checkpointing``), in the reference's on-disk format, so
each package restores the other's checkpoints:

* one ``ckpt_%08d.npz`` per step holding every array under its key path
  (``params/layers/0/w_self``, ``opt/m/layers/0/w_self``, ``opt/step``:
  dict keys sorted, a list index as its integer, joined by ``/``, the
  names ``jax.tree_util`` gives the reference's trees), and a
  ``ckpt_%08d.json`` manifest with the step, ``extra`` (the trainer's host
  state), a CRC32 of each array and ``manifest_crc`` over the canonical
  JSON of ``step``, ``extra`` and ``array_crc``; ``latest.json`` names the
  newest step and never moves backwards;
* ``save`` snapshots to host memory before it returns and writes on a
  background thread (per-step tmp files, then ``os.replace``); ``wait()``
  drains the writes; ``keep`` checkpoints are retained;
* ``latest_step()`` and ``restore()`` verify a checkpoint end to end and
  fall back to the newest earlier one that verifies (a write torn by the
  crash a checkpoint exists to survive is detected, not resumed from), and
  raise ``FileNotFoundError`` when none does.

A snapshot of tensors on the card is copied on the caller's stream into
pinned host buffers, behind an event that the write thread waits on, so it
holds the values the caller's queued work produces and the caller does not
wait for the device. Under a mesh of ranks (``rank=r > 0``) a rank writes
only its own manifest, ``ckpt_%08d.rank<r>.json``, beside rank 0's arrays:
its host state (its slot's counts and loads) is its own, while the arrays
are replicated, so its manifest carries the CRC32 of its own copy of them,
which must equal rank 0's for the checkpoint to verify at that rank. The
reference never reads these files (their names parse as no step).
"""
from __future__ import annotations

import json
import os
import threading
import time
import zlib
from typing import Optional

import numpy as np
import torch


def _manifest_crc(meta: dict) -> int:
    """Checksum of the manifest's integrity-relevant fields over their
    canonical (sorted-keys) JSON — a half-written or edited meta file fails
    to reproduce it."""
    body = {k: meta[k] for k in ("step", "extra", "array_crc")}
    return zlib.crc32(json.dumps(body, sort_keys=True).encode()) & 0xFFFFFFFF


def _paths(tree, prefix: str = ""):
    """(key path, leaf) of every leaf of a tree of dicts and lists, in the
    reference's pytree order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def flatten_with_paths(tree) -> dict:
    """{key path: leaf}, the names the reference's ``_flatten_with_paths``
    gives the same tree."""
    return dict(_paths(tree))


def _rebuild(like, fn, prefix: str = ""):
    """A tree shaped like ``like`` whose leaf at path k is ``fn(k, leaf)``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, fn, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, fn, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return fn(prefix[:-1], like)


def _snapshot(v):
    """One leaf on the host, or (for a tensor on the card) in a pinned
    buffer whose copy is queued on the current stream. numpy cannot hold
    bfloat16: 2-byte floats other than float16 are kept as float32, and
    restore casts back to the ``like`` leaf's dtype (the reference's
    rule)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.is_floating_point() and v.element_size() == 2 \
                and v.dtype != torch.float16:
            v = v.float()
        if v.is_cuda:
            buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            buf.copy_(v, non_blocking=True)
            return buf
        return v.clone()
    a = np.asarray(v)
    if a.dtype.kind not in "fiub?" or (a.dtype.itemsize == 2
                                       and a.dtype.kind == "f"
                                       and a.dtype != np.float16):
        a = a.astype(np.float32)
    return a


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: list[threading.Thread] = []
        self._latest_lock = threading.Lock()
        self._latest_step = -1
        # one record a save: step, rank, the caller's seconds taking the
        # snapshot, the write thread's seconds waiting for the copies and
        # writing, and the bytes written
        self.saves: list[dict] = []

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}")

    def _manifest(self, step: int, rank: int) -> str:
        return self._path(step) + (f".rank{rank}.json" if rank else ".json")

    # -- save -----------------------------------------------------------------
    def save(self, step: int, params, opt_state=None,
             extra: Optional[dict] = None, blocking: bool = False,
             rank: int = 0) -> str:
        """Snapshot to host memory now, write to disk on a thread. Rank 0
        writes the arrays, its manifest and ``latest.json``; a rank r > 0
        writes only its manifest."""
        t0 = time.perf_counter()
        state = {"params": params}
        if opt_state is not None:
            state["opt"] = opt_state
        flat = flatten_with_paths(state)
        snap = {k: _snapshot(v) for k, v in flat.items()}
        event = None
        on_card = [v.device for v in flat.values()
                   if isinstance(v, torch.Tensor) and v.is_cuda]
        if on_card:
            # the copies run on the current stream of the tensors' card
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(on_card[0]))
        meta = {"step": int(step), "extra": extra or {}}
        path = self._path(step)
        record = {"step": int(step), "rank": rank,
                  "snapshot_s": time.perf_counter() - t0}

        def write():
            t1 = time.perf_counter()
            if event is not None:
                event.synchronize()
            record["copy_wait_s"] = time.perf_counter() - t1
            host = {k: v.numpy() if isinstance(v, torch.Tensor) else v
                    for k, v in snap.items()}
            # per-array CRC32 + a checksum of the manifest's canonical
            # JSON, computed on this thread
            meta["array_crc"] = {k: zlib.crc32(v.tobytes()) & 0xFFFFFFFF
                                 for k, v in host.items()}
            meta["manifest_crc"] = _manifest_crc(meta)
            written = 0
            if rank == 0:
                np.savez(path + ".tmp.npz", **host)
                os.replace(path + ".tmp.npz", path + ".npz")
                written += os.path.getsize(path + ".npz")
            manifest = self._manifest(step, rank)
            with open(manifest + ".tmp", "w") as f:
                # json.dumps takes the C encoder, json.dump Python's
                # pure one; the text is the same
                f.write(json.dumps(meta))
            os.replace(manifest + ".tmp", manifest)
            written += os.path.getsize(manifest)
            if rank == 0:
                # concurrent saves: a per-step tmp name, and a monotonic
                # guard so a slow older save never moves "latest" back
                with self._latest_lock:
                    if int(step) >= self._latest_step:
                        self._latest_step = int(step)
                        latest = os.path.join(self.dir, "latest.json")
                        tmp = f"{latest}.tmp{int(step)}"
                        with open(tmp, "w") as f:
                            json.dump({"step": int(step)}, f)
                        os.replace(tmp, latest)
                self._gc()
            record["write_s"] = time.perf_counter() - t1
            record["bytes"] = written
            self.saves.append(record)

        t = threading.Thread(target=write, daemon=True)
        t.start()
        self._pending.append(t)
        if blocking:
            t.join()
        return path

    def wait(self) -> None:
        for t in self._pending:
            t.join()
        self._pending.clear()

    def _gc(self) -> None:
        cks = sorted(f for f in os.listdir(self.dir)
                     if f.startswith("ckpt_") and f.endswith(".npz")
                     and ".tmp" not in f)
        for f in cks[:-self.keep]:
            prefix = f[:-len(".npz")]
            for g in os.listdir(self.dir):
                if g == f or (g.startswith(prefix + ".")
                              and g.endswith(".json")):
                    try:
                        os.remove(os.path.join(self.dir, g))
                    except OSError:
                        pass

    # -- integrity -------------------------------------------------------------
    def _candidate_steps(self) -> list:
        """Every step with a manifest on disk, newest first."""
        steps = []
        for f in os.listdir(self.dir):
            if f.startswith("ckpt_") and f.endswith(".json"):
                try:
                    steps.append(int(f[len("ckpt_"):-len(".json")]))
                except ValueError:
                    pass
        return sorted(steps, reverse=True)

    def _read_manifest(self, step: int, rank: int) -> Optional[dict]:
        """The manifest, if it parses and matches its own checksum."""
        try:
            with open(self._manifest(step, rank)) as f:
                meta = json.load(f)
            if meta.get("array_crc") is not None and \
                    meta.get("manifest_crc") != _manifest_crc(meta):
                return None
            return meta
        except Exception:
            return None

    def _validate(self, step: int, rank: int = 0) -> bool:
        """True iff step's checkpoint verifies end to end: the manifest
        parses and matches its own checksum, the npz opens, and every
        array's CRC32 matches it; at a rank r > 0 also the rank's own
        manifest, whose CRC32s must be rank 0's. Any torn write — a
        truncated npz, a half-written manifest, a byte flip — is False."""
        meta = self._read_manifest(step, 0)
        if meta is None:
            return False
        crcs = meta.get("array_crc")
        if rank:
            mine = self._read_manifest(step, rank)
            if mine is None or mine.get("array_crc") != crcs:
                return False
        try:
            with np.load(self._path(step) + ".npz") as data:
                if crcs is None:  # pre-CRC checkpoint: readable = valid
                    for k in data.files:
                        data[k]
                    return True
                if set(crcs) != set(data.files):
                    return False
                for k, want in crcs.items():
                    if zlib.crc32(data[k].tobytes()) & 0xFFFFFFFF != want:
                        return False
            return True
        except Exception:
            return False

    # -- restore ---------------------------------------------------------------
    def latest_step(self, rank: int = 0) -> Optional[int]:
        """Newest step whose checkpoint verifies (at ``rank``): the
        ``latest.json`` pointer when its target is intact, else the newest
        earlier valid step, else None. Drains in-flight writes first."""
        self.wait()
        latest = os.path.join(self.dir, "latest.json")
        if os.path.exists(latest):
            try:
                with open(latest) as f:
                    step = int(json.load(f)["step"])
                if self._validate(step, rank):
                    return step
            except Exception:
                pass
        for step in self._candidate_steps():
            if self._validate(step, rank):
                return step
        return None

    def restore(self, step: int, like_params, like_opt=None,
                rank: int = 0) -> dict:
        """Restore into the structure of ``like_params`` (and
        ``like_opt``): each array becomes a tensor on the ``like`` tensor's
        device in its dtype, and any other leaf (the optimizer's step) an
        int. A corrupted or truncated ``step`` falls back to the newest
        earlier valid checkpoint; raises FileNotFoundError when none
        verifies. Returns {"step", "extra" (``rank``'s), "params"[,
        "opt"]}."""
        self.wait()
        if not self._validate(step, rank):
            fallback = next((s for s in self._candidate_steps()
                             if s < step and self._validate(s, rank)), None)
            if fallback is None:
                raise FileNotFoundError(
                    f"checkpoint step {step} in {self.dir} is corrupted or "
                    f"incomplete and no earlier valid checkpoint exists")
            print(f"checkpointing: step {step} failed integrity checks; "
                  f"falling back to step {fallback}")
            step = fallback
        meta = self._read_manifest(step, rank)
        with np.load(self._path(step) + ".npz") as data:
            def leaf(prefix):
                def fn(key, like):
                    arr = data[f"{prefix}/{key}"]
                    if isinstance(like, torch.Tensor):
                        return torch.from_numpy(np.array(arr)).to(
                            device=like.device, dtype=like.dtype)
                    return int(arr)  # the optimizer's step
                return fn

            res = {"step": meta["step"], "extra": meta["extra"],
                   "params": _rebuild(like_params, leaf("params"))}
            if like_opt is not None:
                res["opt"] = _rebuild(like_opt, leaf("opt"))
        return res
