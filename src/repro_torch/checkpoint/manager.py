"""Fault-tolerant checkpointing: atomic and asynchronous, in the reference's
format.

Layout (filesystem only — no external deps), the reference's:

    <dir>/step_000123/
        arrays_h<k>.npz     the leaves, ``a0, a1, ...`` in the reference's
                            leaf order (dict keys sorted); host k's file
        tree.json           {"paths", "shapes", "dtypes", "step"}
        done                commit marker (written last — a dir without it
                            is an aborted save and is ignored/GC'd)
    <dir>/latest            text file holding the newest committed step

A path is the reference's key string (``['params']/['blocks']/['layer0']/
['mixer']/['wq']``). The port's per-group lists (``blocks``; an
encoder-decoder's ``encoder`` and ``decoder``) are stacked into the
reference's ``(G, ...)`` leaves on save and split again on restore, so each
package loads the other's checkpoints. A bf16 leaf is written as the
2-byte void the reference's ``ml_dtypes`` array becomes in an npz (descr
``<V2``) and read back through ``tree.json``'s ``"bfloat16"``.

Async: ``save()`` copies the tree to host memory synchronously — the
train loop is blocked only for the copy, not the I/O — then a daemon thread
writes it. ``restore()`` reads the newest committed step onto the devices of
the tree it is handed, or, given ``shardings=`` (a tree of
``dist.sharding.NamedSharding``), onto each sharding's mesh: the elastic
restore onto a mesh.

Across several ranks (DTensor leaves, ``dist.placement``) ``save`` gathers
each leaf (``full_tensor``, on every rank) and rank 0 alone writes the same
npz bytes and ``tree.json`` as one process; a blocking save ends on a
barrier. ``restore`` reads the whole leaf on every rank and keeps its
block, placed as the leaf it replaces (a DTensor of ``like_tree``) or by
its sharding. So a checkpoint written on 4 ranks restores on 1, and back,
bit for bit: the reference's resume on a different topology.

Port of the reference module whole.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._tree import fill, leaf_sets, path_str


def _is_dtensor(t) -> bool:
    if type(t) is torch.Tensor:
        return False
    from repro_torch.dist.placement import is_dtensor
    return is_dtensor(t)


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or the one
    process."""
    return not dist.is_initialized() or dist.get_rank() == 0


class CheckpointError(RuntimeError):
    """A committed checkpoint could not be loaded (truncated archive,
    missing/mismatched leaves, unreadable metadata). The ``done`` marker
    promises the *save* completed; this error means the bytes on disk no
    longer honor that promise — pick an older step or re-save."""


_BF16 = "bfloat16"


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (never an alias: the trainer updates its state
    in place while a save is being written); bf16 as its 16-bit patterns. A
    DTensor is gathered whole first (a collective: every rank calls it)."""
    if _is_dtensor(t):
        t = t.detach().full_tensor()
    t = t.detach().to("cpu", copy=True)
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _snapshot(tree) -> list:
    """``(path string, host array, dtype name)`` for each leaf of ``tree``,
    per-group lists stacked."""
    out = []
    for path, leaf in leaf_sets(tree):
        parts = leaf if isinstance(leaf, list) else [leaf]
        host = [_host(t) for t in parts]
        arr = np.stack(host) if isinstance(leaf, list) else host[0]
        out.append((path_str(path), arr, _BF16 if parts[0].dtype == torch.bfloat16
                    else str(arr.dtype)))
    return out


def _write_npz(path: str, items: list) -> None:
    """``np.savez``'s archive, with bf16 leaves under the descr ``<V2``."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, (_, arr, dtype) in enumerate(items):
            with zf.open(f"a{i}.npy", "w", force_zip64=True) as f:
                if dtype == _BF16:
                    arr = np.ascontiguousarray(arr)
                    np.lib.format.write_array_header_1_0(
                        f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
                    f.write(arr.tobytes())
                else:
                    np.lib.format.write_array(f, np.asarray(arr), allow_pickle=False)


def _tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == _BF16:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _placed_as(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (the whole leaf) where ``like`` lives: its device, or its block
    on ``like``'s mesh."""
    if _is_dtensor(like):
        from repro_torch.dist.placement import distribute_as
        return distribute_as(t, like)
    return t.to(like.device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, host_index: int = 0):
        self.dir = directory
        self.keep = keep
        self.host_index = host_index
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ---------------- save ----------------
    def save(self, step: int, tree, blocking: bool = False):
        """Snapshot now, write in the background (or now, ``blocking``)."""
        self.wait()  # one in-flight save at a time
        placed = any(_is_dtensor(t) for _, leaf in leaf_sets(tree)
                     for t in (leaf if isinstance(leaf, list) else [leaf]))
        items = _snapshot(tree)
        if _writer():
            if blocking:
                self._write(step, items)
            else:
                self._thread = threading.Thread(target=self._write, args=(step, items),
                                                daemon=True)
                self._thread.start()
        if blocking and placed:
            dist.barrier()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, items: list):
        sdir = os.path.join(self.dir, f"step_{step:09d}")
        tmp = sdir + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        _write_npz(os.path.join(tmp, f"arrays_h{self.host_index}.npz"), items)
        meta = {
            "paths": [p for p, _, _ in items],
            "shapes": [list(a.shape) for _, a, _ in items],
            "dtypes": [d for _, _, d in items],
            "step": step,
        }
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "done"), "w") as f:
            f.write("ok")
        if os.path.exists(sdir):
            shutil.rmtree(sdir)
        os.rename(tmp, sdir)
        with open(os.path.join(self.dir, "latest.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.dir, "latest.tmp"), os.path.join(self.dir, "latest"))
        self._gc()

    def _gc(self):
        steps = self.committed_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)
        # drop aborted saves
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    # ---------------- restore ----------------
    def committed_steps(self) -> list[int]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and os.path.exists(os.path.join(self.dir, name, "done")):
                out.append(int(name.split("_")[1]))
        return out

    def latest_step(self) -> int | None:
        p = os.path.join(self.dir, "latest")
        if os.path.exists(p):
            with open(p) as f:
                s = int(f.read().strip())
            if os.path.exists(os.path.join(self.dir, f"step_{s:09d}", "done")):
                return s
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, like_tree, step: int | None = None, shardings=None):
        """Load into the structure of ``like_tree`` (the newest committed
        step unless ``step`` is given): each leaf in the dtype it was saved
        in, on the device of the leaf it replaces — or, with ``shardings``
        (a tree of ``NamedSharding`` mirroring ``like_tree``), on the device
        of its sharding's mesh. Returns ``(tree, step)``."""
        placed = None
        if shardings is not None:
            placed = dict(leaf_sets(shardings))
            if any(s.device.type == "meta" for v in placed.values()
                   for s in (v if isinstance(v, list) else [v])):
                raise ValueError("restore(shardings=) onto a logical (meta) mesh: a "
                                 "production mesh prices shards, it holds none")
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        sdir = os.path.join(self.dir, f"step_{step:09d}")
        npz = os.path.join(sdir, f"arrays_h{self.host_index}.npz")
        try:
            with np.load(npz) as data, open(os.path.join(sdir, "tree.json")) as f:
                meta = json.load(f)
                by_path = {p: (data[f"a{i}"], meta["dtypes"][i])
                           for i, p in enumerate(meta["paths"])}
        except Exception as e:  # zipfile/json/KeyError: damaged bytes
            raise CheckpointError(
                f"checkpoint step {step} at {sdir} is corrupt or truncated "
                f"({type(e).__name__}: {e})") from e
        values = {}
        for path, like in leaf_sets(like_tree):
            name = path_str(path)
            got = by_path.get(name)
            if got is None:
                raise CheckpointError(
                    f"checkpoint step {step} is missing leaf {name!r} — "
                    "the saved tree does not match like_tree")
            arr, dtype = got
            parts = like if isinstance(like, list) else [like]
            want = ((len(parts),) if isinstance(like, list) else ()) + tuple(parts[0].shape)
            if tuple(arr.shape) != want:
                raise CheckpointError(
                    f"checkpoint step {step} leaf {name!r} has shape "
                    f"{tuple(arr.shape)}, expected {want}")
            likes = like if isinstance(like, list) else [like]
            arrs = list(arr) if isinstance(like, list) else [arr]
            if placed is None:
                got = [_placed_as(_tensor(a, dtype, "cpu"), t) for a, t in zip(arrs, likes)]
            else:
                shs = placed[path] if isinstance(like, list) else [placed[path]]
                got = [s.distribute(_tensor(a, dtype, "cpu")) for a, s in zip(arrs, shs)]
            values[path] = got if isinstance(like, list) else got[0]
        return fill(like_tree, values), step
