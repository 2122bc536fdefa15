"""Checkpointing with async writes and a content-hash manifest.

Port of `repro.train.checkpoint`, in the reference's format:

Layout:  <dir>/step_<N>/
             manifest.json    # leaf paths, files, shapes, dtypes, hashes
             leaf_<i>.npy     # one file per leaf (host-gathered)
         <dir>/LATEST         # atomic pointer (written last -> crash-safe)

A tree is nested dicts (and lists) of tensors; a leaf's path is its keys
joined by "/", and leaves are numbered in the order `jax.tree_util`
flattens the same tree (dict keys sorted), so a flat tree of numpy arrays
the reference saved restores here.  The manifest's `sha` is the first 16
hex digits of the SHA-256 of the leaf's bytes.  numpy has no bfloat16: a
bf16 leaf is stored as its uint16 bits under `"dtype": "bfloat16"`.

`save_checkpoint` copies every leaf to the host before it returns, also
from CPU tensors (whose `.cpu()` is the tensor itself), so the writer
thread never reads a tensor the caller may go on to change.  Reading a
directory (`latest_step`, `restore_checkpoint`) first waits for this
process's writer of it: the reference reads while an async save may be
replacing the step it reads (a retry right after a checkpoint), and finds
leaf files gone or an older LATEST.  Restore never needs the saving
device: leaves load as host arrays and are copied onto the target device.
The manifest hash check catches partial or corrupt writes.

On a mesh (`parallel.sharding`), a DTensor leaf is saved whole
(`full_tensor()`, a collective every rank joins), in the same format and
hashes, and rank 0 of the process group alone writes and collects old
steps; a waited save returns on every rank once the step is on disk.
Restore places each leaf by its sharding (given, or the `like` leaf's
own): every rank loads the whole leaf and keeps its own slice (elastic
re-shard: a checkpoint saved on one mesh restores onto any other).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.sharding import NamedSharding, full_tensor, is_dtensor, shard

_WRITERS: dict = {}  # directory -> the last writer thread
_WRITERS_MU = threading.Lock()


def flatten(tree, prefix: str = "") -> list:
    """[(path, leaf)] in the reference's leaf order: dict keys sorted,
    list items in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flatten(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _unflatten(like, leaves: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return leaves[prefix[:-1]]


def _ranks() -> tuple:
    """(this process's rank, the world size) of the default process
    group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _to_host(leaf) -> tuple:
    """(numpy array of the leaf's bytes, dtype name): a copy; a DTensor
    whole."""
    if isinstance(leaf, torch.Tensor):
        t = full_tensor(leaf.detach()).to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def save_checkpoint(directory: str, step: int, tree, wait: bool = True
                    ) -> threading.Thread:
    """Host-gather `tree` and write step_<step>.  Async unless wait=True;
    a save first waits for the directory's previous writer.  Under a
    process group of more than one rank every rank must call it (DTensor
    leaves gather whole); rank 0 writes, and with wait=True every rank
    returns after the write."""
    host = [(name, *_to_host(leaf)) for name, leaf in flatten(tree)]
    rank, world = _ranks()
    if rank != 0:  # rank 0 writes
        host = []
    error: list = []

    def write():
        try:
            step_dir = os.path.join(directory, f"step_{step}")
            tmp = tempfile.mkdtemp(dir=_ensure(directory),
                                   prefix=".tmp_ckpt_")
            manifest = {"step": step, "leaves": []}
            for i, (name, arr, dtype) in enumerate(host):
                fn = f"leaf_{i}.npy"
                np.save(os.path.join(tmp, fn), arr)
                manifest["leaves"].append({
                    "path": name, "file": fn, "shape": list(arr.shape),
                    "dtype": dtype, "sha": _sha(arr)})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(step_dir):
                shutil.rmtree(step_dir)
            os.replace(tmp, step_dir)
            with open(os.path.join(directory, ".LATEST.tmp"), "w") as f:
                f.write(str(step))
            os.replace(os.path.join(directory, ".LATEST.tmp"),
                       os.path.join(directory, "LATEST"))
        except BaseException as e:  # raised again by a waiting caller
            error.append(e)
            raise

    with _WRITERS_MU:
        _drain(directory)
        t = threading.Thread(target=write if rank == 0 else (lambda: None),
                             daemon=True)
        t.start()
        _WRITERS[os.path.abspath(directory)] = t
    if wait:
        t.join()
        if error:
            raise error[0]
        if world > 1:
            dist.barrier()
    return t


def _drain(directory: str) -> None:
    """Wait for this process's last writer of `directory`."""
    prev: Optional[threading.Thread] = _WRITERS.get(
        os.path.abspath(directory))
    if prev is not None:
        prev.join()


def _ensure(d: str) -> str:
    os.makedirs(d, exist_ok=True)
    return d


def latest_step(directory: str) -> Optional[int]:
    _drain(directory)
    try:
        with open(os.path.join(directory, "LATEST")) as f:
            return int(f.read().strip())
    except (FileNotFoundError, ValueError):
        return None


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(directory: str, like, step: Optional[int] = None,
                       device=None, shardings=None, verify: bool = True):
    """Restore into the structure of `like` (a tree of tensors): each leaf
    in its `like` leaf's dtype, placed by its `NamedSharding` in
    `shardings` (a tree of the same structure, for the TARGET mesh) or,
    without one, as its `like` leaf is: a DTensor's placement, else on
    `device` (each `like` leaf's own device when None).  -> (tree, step).
    Raises FileNotFoundError without a checkpoint, KeyError for a leaf
    the checkpoint lacks, IOError for a leaf whose bytes do not match
    their hash and ValueError for a shape mismatch."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    else:
        _drain(directory)
    step_dir = os.path.join(directory, f"step_{step}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)

    by_path = {m["path"]: m for m in manifest["leaves"]}
    placed = dict(flatten(shardings)) if shardings is not None else {}
    leaves = {}
    for name, leaf in flatten(like):
        if name not in by_path:
            raise KeyError(f"checkpoint missing leaf {name}")
        m = by_path[name]
        arr = np.load(os.path.join(step_dir, m["file"]))
        if verify and _sha(arr) != m["sha"]:
            raise IOError(f"checksum mismatch for {name}")
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        sharding = placed.get(name) or _sharding_of(leaf)
        t = _from_host(arr, m["dtype"]).to(dtype=leaf.dtype)
        leaves[name] = shard(t, sharding) if sharding is not None else t.to(
            leaf.device if device is None else device)
    return _unflatten(like, leaves), step


def _sharding_of(leaf) -> Optional[NamedSharding]:
    """A DTensor's layout; None for any other leaf."""
    return (NamedSharding(leaf.device_mesh, tuple(leaf.placements))
            if is_dtensor(leaf) else None)


def keep_last(directory: str, n: int = 3):
    """Garbage-collect all but the newest n checkpoints (tolerates racing
    the async writer: the directory may not exist yet).  Rank 0 alone
    collects under a process group."""
    if _ranks()[0] != 0 or not os.path.isdir(directory):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_"))
    for s in steps[:-n]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)
