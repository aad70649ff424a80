"""Sharded checkpointing with async commit — the port of
``repro/checkpoint/manager.py``, with its on-disk layout:

    <dir>/step_<N>/
        manifest.json        leaf keys, shapes, dtypes, step
        shard_<i>.npz        leaf arrays (grouped ~512 MB per shard)
        COMMITTED            written last; the directory is renamed into
                             place whole, and one without it is ignored

A tree is a module (its parameters, keyed by name), an
``optim.AdamWState`` (``step``, ``m.<name>``, ``v.<name>``), a dict, a
tuple or list of those, or a tensor. numpy has no bfloat16: a bf16 leaf
is stored as its ``uint16`` bits with ``"bfloat16"`` in the manifest,
and restored bit for bit. The writer runs on a background thread, so
the train loop never waits on the disk; :meth:`CheckpointManager.wait`
raises the writer's error.

:meth:`CheckpointManager.restore` writes the stored values into the
tensors of the tree it is given, in place, on their devices (the JAX
manager returns a new tree): at granite-3-2b's size a second copy of the
parameters and moments would not fit beside the first.

A DTensor leaf (the sharded steps) is gathered whole with
``full_tensor()`` on save, as the JAX manager's ``np.asarray`` of a
sharded array, and restored into each rank's shard of the template. In
a ``torch.distributed`` group every rank gathers (a collective), rank 0
alone writes, synchronously, and the ranks meet at a barrier before
``save`` returns, so any rank that lists the steps sees the same
ones."""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

__all__ = ["CheckpointManager", "flatten"]

SHARD_BYTES = 512 << 20


def flatten(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(key, tensor) of every leaf of ``tree``, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, nn.Module):
        return [(prefix + k, p) for k, p in tree.named_parameters()]
    if hasattr(tree, "_fields"):                    # a NamedTuple
        tree = tree._asdict()
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in flatten(v, f"{prefix}{k}.")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten(v, f"{prefix}{i}.")]
    raise TypeError(f"checkpoint leaf {prefix!r} is a {type(tree)}")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that owns its memory: the optimizer updates the
    leaves in place while the writer thread still reads the copy (``.cpu()``
    of a CPU tensor would be the live storage)."""
    t = t.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(
            np.uint16)
    return t.to("cpu", copy=True).numpy()


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False) -> None:
        """Copy every leaf to the host now, write them on the writer
        thread (or here when ``blocking``)."""
        self.wait()
        host = [(k, _to_host(v), str(v.dtype).replace("torch.", ""))
                for k, v in flatten(tree)]
        if dist.is_initialized():
            if dist.get_rank() == 0:
                self._write(step, host)
            dist.barrier()
            return

        def write():
            try:
                self._write(step, host)
            except BaseException as e:    # surfaced on next wait()
                self._error = e

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def _write(self, step: int, host):
        path = os.path.join(self.dir, f"step_{step:09d}")
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        shard: Dict[str, np.ndarray] = {}
        shard_bytes, shard_id = 0, 0

        def flush():
            nonlocal shard, shard_bytes, shard_id
            if shard:
                np.savez(os.path.join(tmp, f"shard_{shard_id}.npz"), **shard)
                shard, shard_bytes = {}, 0
                shard_id += 1

        for i, (key, arr, dtype) in enumerate(host):
            name = f"leaf_{i}"
            manifest["leaves"].append(
                {"key": key, "name": name, "shard": shard_id,
                 "shape": list(arr.shape), "dtype": dtype})
            shard[name] = arr
            shard_bytes += arr.nbytes
            if shard_bytes >= SHARD_BYTES:
                flush()
        flush()
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        self._gc()

    def _gc(self):
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # -- restore -------------------------------------------------------------
    def list_steps(self) -> List[int]:
        out = []
        for d in sorted(os.listdir(self.dir)):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "COMMITTED")):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, step: int, template):
        """Write step ``step`` into the leaves of ``template`` (in place,
        each on its own device, bit for bit) and return ``template``. The
        keys, shapes and dtypes must be the stored ones."""
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = flatten(template)
        if [k for k, _ in leaves] != [m["key"] for m in manifest["leaves"]]:
            raise ValueError("checkpoint/template mismatch: the leaf keys "
                             "differ")
        shards: Dict[int, Any] = {}
        for (key, t), meta in zip(leaves, manifest["leaves"]):
            sid = meta["shard"]
            if sid not in shards:
                shards[sid] = np.load(os.path.join(path,
                                                   f"shard_{sid}.npz"))
            src = _from_host(shards[sid][meta["name"]], meta["dtype"])
            if src.shape != t.shape or src.dtype != t.dtype:
                raise ValueError(f"checkpoint leaf {key}: stored "
                                 f"{tuple(src.shape)} {src.dtype}, the "
                                 f"template holds {tuple(t.shape)} "
                                 f"{t.dtype}")
            if isinstance(t, DTensor):
                t.to_local().copy_(distribute_tensor(
                    src.to(t.device), t.device_mesh, t.placements,
                    src_data_rank=None).to_local())
            else:
                t.copy_(src)
        return template
