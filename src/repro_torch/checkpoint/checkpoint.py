"""Fault-tolerant checkpointing of nested trees of tensors
(``repro.checkpoint.checkpoint``), in the reference's file format.

* atomic writes (tmp file + rename): a killed writer never corrupts the
  latest checkpoint;
* step-tagged ``step_<n>.proc<k>.npz`` files holding a ``__meta__`` JSON
  record and one array a leaf, keyed by the leaf's path joined with
  ``/`` (a dict key as is, a list or tuple index as ``#i``), so a
  float32 file written by either package restores in the other;
* a retention window (``keep``) with pinned steps exempt;
* async save on a background thread, then ``wait``;
* ``restore_latest`` skips unreadable files.

Leaves are torch tensors on any device, or numpy arrays (a
``CompressionPlan.to_tree()`` in the Compressor's carry), stored as they
are.  numpy has no bfloat16: a bf16 leaf is stored as its bits (uint16)
and its path listed under ``"bfloat16"`` in the meta record, so it
restores bit for bit.  A restore gives each leaf the template leaf's
type and dtype (and a tensor the template's device).
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

_SEP = "/"
_BF16 = "bfloat16"


def _items(tree, prefix=()):
    """``(path, leaf)`` pairs in the reference's order (dict keys
    sorted, as JAX flattens them)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (f"#{i}",))
    else:
        yield _SEP.join(prefix), tree


def _to_host(leaf):
    """A numpy copy of one leaf, and whether it holds bf16 bits."""
    if not torch.is_tensor(leaf):
        return np.array(leaf), False
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy(), True
    return t.numpy().copy(), False


def _flatten(tree) -> dict:
    """``{leaf path: numpy array}`` of a tree, each array as a checkpoint
    stores it (bf16 as its uint16 bits)."""
    return {key: _to_host(leaf)[0] for key, leaf in _items(tree)}


def _unflatten(template, flat: dict, bf16: set, prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, bf16, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, flat, bf16, prefix + (f"#{i}",))
                              for i, v in enumerate(template))
    key = _SEP.join(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint is missing leaf {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(np.shape(template)):
        raise ValueError(f"shape mismatch for {key!r}: ckpt {arr.shape} vs "
                         f"template {tuple(np.shape(template))}")
    if not torch.is_tensor(template):
        return arr.astype(np.asarray(template).dtype)
    if key in bf16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=template.device, dtype=template.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 process_index: int = 0):
        self.dir = directory
        self.keep = keep
        self.proc = process_index
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._pins: set[int] = set()

    # -------------------------------------------------------------- pins
    def pin(self, step: int):
        """Protect a step from retention GC (pins live in this manager
        instance only)."""
        self._pins.add(int(step))

    def unpin(self, step: int):
        self._pins.discard(int(step))

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = True,
             metadata: Optional[dict] = None, pin: bool = False):
        """Atomic save.  The leaves are copied to the host here; with
        ``blocking=False`` the file is written on a background thread
        (after any previous in-flight write).  ``pin=True`` also protects
        the step from retention GC."""
        if pin:
            self.pin(step)
        flat, bf16 = {}, []
        for key, leaf in _items(tree):
            flat[key], is_bf16 = _to_host(leaf)
            if is_bf16:
                bf16.append(key)
        meta = {"step": step, **(metadata or {})}
        if bf16:
            meta[_BF16] = bf16
        if blocking:
            self._write(step, flat, meta)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, meta), daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict, meta: dict):
        fname = self._fname(step)
        with self._lock:
            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    np.savez(f, __meta__=json.dumps(meta), **flat)
                os.replace(tmp, fname)     # atomic on POSIX
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            self._gc()

    def _fname(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:012d}.proc{self.proc}.npz")

    def _gc(self):
        steps = [s for s in sorted(self.all_steps()) if s not in self._pins]
        for s in steps[: -self.keep]:
            try:
                os.unlink(self._fname(s))
            except OSError:
                pass

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        pat = re.compile(rf"step_(\d+)\.proc{self.proc}\.npz$")
        out = []
        for f in os.listdir(self.dir):
            m = pat.match(f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, step: int, template: Any):
        """(tree shaped like ``template``, metadata) of one step."""
        with np.load(self._fname(step), allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files if k != "__meta__"}
            meta = json.loads(str(z["__meta__"]))
        bf16 = set(meta.pop(_BF16, ()))
        return _unflatten(template, flat, bf16), meta

    def peek_meta(self, step: int) -> dict:
        """Only the metadata record of one checkpoint."""
        with np.load(self._fname(step), allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
        meta.pop(_BF16, None)
        return meta

    def latest_step_and_meta(self):
        """(step, metadata) of the newest readable checkpoint, or None."""
        for step in reversed(self.all_steps()):
            try:
                return step, self.peek_meta(step)
            except Exception as e:  # corrupt/partial file: skip it
                print(f"[checkpoint] skipping step {step}: {e}")
        return None

    def restore_latest(self, template: Any):
        """Restore the newest readable checkpoint, skipping corrupt files.
        Returns (tree, meta) or (None, None) when nothing is
        restorable."""
        for step in reversed(self.all_steps()):
            try:
                return self.restore(step, template)
            except Exception as e:      # corrupt/partial file: skip it
                print(f"[checkpoint] skipping step {step}: {e}")
        return None, None
