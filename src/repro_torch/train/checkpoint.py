"""Fault-tolerant checkpointing, in the reference's on-disk layout
(``repro/train/checkpoint.py``), so either package reads the other's:

  * every leaf saved as ``leaf_%05d.npy`` (numbered in the sorted order
    of the flat keys) inside ``step_%08d``; ``manifest.json`` holds
    ``step``, ``time``, ``leaves`` (flat key -> file, shape, dtype) and
    ``extra``; the directory is written as ``.tmp`` and committed by an
    atomic rename, so a crash mid-save never corrupts the latest
    checkpoint;
  * ``restore_latest`` scans for the newest committed step — the
    restart-after-failure path;
  * ``AsyncCheckpointer`` copies the tree to host memory on the
    caller's thread (ordered after the train step; a copy even of a CPU
    leaf, which the next step changes in place) and writes it on a worker
    thread; the train loop blocks only on the previous save, and old
    steps past ``keep`` are removed.

A tree is nested dicts (and ``Params``, read by key), lists and tuples
(by index) and NamedTuples (by field name) of tensors, numpy arrays or
Python scalars; ``None`` holds no leaf. Flat keys join the path with
``::``, as the reference's do. bfloat16 tensors are stored as their 16
bits under the dtype name ``bfloat16``.

Placed (DTensor) leaves are saved whole, in the same format: every rank
gathers each leaf, rank 0 writes, and the save returns after a barrier,
so a checkpoint is committed before any rank goes on. ``restore`` reads
onto the device of each leaf of the target tree; with ``shardings=``
(flat key -> ``dist.shardings.Sharding``), or for a target leaf that is
itself placed, each rank reads only its own block of the leaf from a
memory-mapped file and the leaf comes back placed on that mesh, which
need not be the mesh that wrote it (elastic rescale).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.dist.shardings import Sharding, from_host, is_placed, spec_of

PyTree = Any
_SEP = "::"


def _is_mapping(tree) -> bool:
    return isinstance(tree, dict) or (isinstance(tree, nn.Module)
                                      and hasattr(tree, "keys"))


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _walk(tree: PyTree, path: Tuple[str, ...] = ()):
    """(flat key, leaf) of every leaf, mappings by sorted key."""
    if tree is None:
        return
    if _is_mapping(tree):
        for key in sorted(tree.keys()):
            yield from _walk(tree[key], path + (str(key),))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _walk(getattr(tree, name), path + (name,))
    elif isinstance(tree, (list, tuple, nn.ModuleList)):
        for i, x in enumerate(tree):
            yield from _walk(x, path + (str(i),))
    else:
        yield _SEP.join(path), tree


def _rebuild(tree: PyTree, fn: Callable, path: Tuple[str, ...] = ()):
    """``tree``'s structure with each leaf replaced by fn(key, leaf);
    mappings (``Params`` too) become dicts, ``ModuleList``s lists."""
    if tree is None:
        return None
    if _is_mapping(tree):
        return {key: _rebuild(tree[key], fn, path + (str(key),))
                for key in tree.keys()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, name), fn, path + (name,))
                            for name in tree._fields))
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        out = [_rebuild(x, fn, path + (str(i),)) for i, x in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(_SEP.join(path), tree)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host array and the dtype name the manifest records
    (a placed leaf gathered whole: a collective). The array is a copy:
    a CPU leaf (or the local shard ``full_tensor`` returns at world 1)
    is changed in place by the next train step while a writer thread
    may still be saving it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if is_placed(t):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.to("cpu", copy=True).numpy()
        if leaf.dtype == torch.bfloat16:
            return arr.view(np.uint16), "bfloat16"
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _host_flat(tree: PyTree) -> Dict[str, Tuple[np.ndarray, str]]:
    return {key: _host(leaf) for key, leaf in _walk(tree)}


def _write(ckpt_dir: str, step: int, flat: Dict[str, Tuple[np.ndarray, str]],
           extra: Optional[Dict]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "time": time.time(), "leaves": {},
                "extra": extra or {}}
    for i, (key, (arr, dtype)) in enumerate(sorted(flat.items())):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def _placed_tree(tree: PyTree) -> bool:
    return any(is_placed(leaf) for _, leaf in _walk(tree))


def _writer() -> bool:
    """Whether this process writes a placed tree: rank 0 of the group."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, tree: PyTree,
         extra: Optional[Dict] = None) -> str:
    """Synchronous atomic save. Returns the committed directory. A tree
    with placed leaves is called on every rank: rank 0 writes, and every
    rank returns after a barrier."""
    flat = _host_flat(tree)
    if not _placed_tree(tree):
        return _write(ckpt_dir, step, flat, extra)
    import torch.distributed as dist
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _writer():
        _write(ckpt_dir, step, flat, extra)
    dist.barrier()
    return final


class AsyncCheckpointer:
    """Double-buffered async saves; ``wait()`` before exit/next save."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save(self, step: int, tree: PyTree, extra=None):
        self.wait()
        # the copy to the host on the caller thread (ordered after the
        # train step; placed leaves gathered on every rank), file IO on
        # the worker of rank 0
        flat = _host_flat(tree)
        if _placed_tree(tree) and not _writer():
            return

        def work():
            self.last_path = _write(self.ckpt_dir, step, flat, extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(_committed_steps(self.ckpt_dir))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)


def _committed_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            out.append(int(d[5:]))
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _committed_steps(ckpt_dir)
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A CPU tensor of a saved array (16-bit words for bfloat16)."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def _load(path: str, meta: Dict, target, sharding=None):
    """One saved leaf as the target leaf's kind: a tensor on its device
    (placed under ``sharding``, or as the target is, with only this
    rank's block read), a Python scalar, or a numpy array."""
    file = os.path.join(path, meta["file"])
    if isinstance(target, torch.Tensor):
        if sharding is None and is_placed(target):
            sharding = Sharding(target.device_mesh, spec_of(target))
        if sharding is not None:
            return from_host(np.load(file, mmap_mode="r"), sharding,
                             lambda block: _tensor(block, meta["dtype"]))
        return _tensor(np.load(file), meta["dtype"]).to(target.device)
    arr = np.load(file)
    if isinstance(target, (bool, int, float)):
        return type(target)(arr)
    return arr


def restore(path: str, target_tree: PyTree,
            shardings: Optional[Dict] = None) -> PyTree:
    """The checkpoint at ``path`` in the structure of ``target_tree``
    (mappings as dicts); raises KeyError for a leaf it lacks.
    ``shardings``: flat key -> ``Sharding`` for leaves to place on a
    mesh (e.g. ``dist.shardings.params_shardings(mesh, params)`` for a
    ``Params`` target)."""
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    shardings = shardings or {}

    def load(key, target):
        if key not in leaves:
            raise KeyError(f"checkpoint missing leaf {key}")
        return _load(path, leaves[key], target, shardings.get(key))

    return _rebuild(target_tree, load)


def restore_latest(ckpt_dir: str, target_tree: PyTree,
                   shardings: Optional[Dict] = None) -> Optional[PyTree]:
    s = latest_step(ckpt_dir)
    if s is None:
        return None
    return restore(os.path.join(ckpt_dir, f"step_{s:08d}"), target_tree,
                   shardings)


@torch.no_grad()
def load_into(target: PyTree, tree: PyTree) -> PyTree:
    """Copy ``tree`` (``restore``'s result for ``target``) into the
    tensors of ``target`` in place, so modules and optimizer lists keep
    their tensors; returns ``target``'s structure with its other leaves
    (Python scalars) taken from ``tree``."""
    if target is None:
        return None
    if _is_mapping(target):
        for key in target.keys():
            new = load_into(target[key], tree[key])
            if isinstance(target, dict):
                target[key] = new
        return target
    if _is_namedtuple(target):
        return type(target)(*(load_into(getattr(target, name),
                                        getattr(tree, name))
                              for name in target._fields))
    if isinstance(target, (list, tuple, nn.ModuleList)):
        out = [load_into(t, s) for t, s in zip(target, tree)]
        return type(target)(out) if isinstance(target, tuple) else (
            target if isinstance(target, nn.ModuleList) else out)
    if isinstance(target, torch.Tensor):
        if target.dtype == tree.dtype and target.shape == tree.shape:
            target.copy_(tree)
        else:
            target.data = tree.to(target.device)
        return target
    return tree
