"""Checkpointing in the reference's on-disk format (port of
``repro/checkpoint/ckpt.py``): atomic, async, with retention.

One directory a step, ``step_%08d/``, holding one ``.npy`` a leaf,
``leaf_%05d.npy`` in the sorted order of the leaves' keys (the tree's
dict keys joined by "/"), and ``manifest.json`` with the step, each
leaf's file, dtype and shape, and ``extra``. A save writes
``.tmp_step_%08d/``, fsyncs the manifest and renames: a killed job never
leaves a half-written step. The files are byte for byte the reference's
for the same tree.

bf16 leaves: the reference's ``np.save`` of an ``ml_dtypes.bfloat16``
array writes the descr '<V2' and the raw bits, and its manifest says
"bfloat16". The port writes the same bytes from the tensor's bits (no
``ml_dtypes``) and restores by the manifest's dtype. The reference's own
``restore_checkpoint`` cannot read such a leaf: ``np.load`` gives void
back, which ``jnp.asarray`` refuses (ROADMAP.md C)."""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import Sharded
from repro_torch.models import bits_bf16, to_numpy


def _flatten(tree, prefix=()) -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out["/".join(prefix + (str(k),))] = v
    return out


def _host(leaf) -> np.ndarray:
    """A leaf as numpy: a tensor copied to the host (bf16 as 'V2' bits)
    into memory of its own, so later in-place updates of the tensor do
    not reach it, on the CPU too; an array as it is."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        host = torch.empty(t.shape, dtype=t.dtype)
        host.copy_(t)
        return to_numpy(host)
    return np.asarray(leaf)


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16" or \
        (a.dtype.kind == "V" and a.dtype.itemsize == 2)


def _save_leaf(path: Path, a: np.ndarray) -> str:
    """``np.save``'s bytes; a bf16 leaf with the reference's '<V2' header.
    Returns the manifest's dtype name."""
    if not a.flags.c_contiguous:     # (ascontiguousarray makes 0-d 1-d)
        a = np.ascontiguousarray(a)
    if not _is_bf16(a):
        np.save(path, a)
        return str(a.dtype)
    header = np.lib.format.header_data_from_array_1_0(a)
    header["descr"] = "<V2"
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        f.write(a.tobytes())
    return "bfloat16"


def save_checkpoint(ckpt_dir: Path, step: int, tree: Any,
                    extra: Optional[Dict] = None) -> Path:
    """Write ``tree`` (nested dicts of numpy arrays or tensors, in the
    reference's layout: ``models.to_reference``) as step ``step``. The
    ``.npy`` files are C order, as the reference's of its arrays."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    names = {}
    for i, (key, leaf) in enumerate(sorted(_flatten(tree).items())):
        arr = _host(leaf)
        dtype = _save_leaf(tmp / f"leaf_{i:05d}.npy", arr)
        names[key] = {"file": f"leaf_{i:05d}.npy", "dtype": dtype,
                      "shape": list(arr.shape)}
    manifest = {"step": step, "leaves": names, "extra": extra or {}}
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def latest_step(ckpt_dir: Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: Path, step: int, like: Any = None,
                       shardings: Any = None, device=None) -> Dict:
    """Step ``step``'s tree, nested by its "/" keys, every leaf a tensor
    on ``device`` (bf16 where the manifest says "bfloat16"). ``like``
    (a tree), when given, must have the same keys, and where its leaf
    is a shape (a tuple), the manifest's must equal it; otherwise
    ``ValueError``, before any leaf is read. ``shardings`` (a tree of
    ``distributed.sharding.NamedSharding``), when given, places each
    leaf it names straight onto its mesh, as a ``Sharded`` leaf: the
    leaves are global, so a mesh of any shape takes them."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    if like is not None:
        want = _flatten(like)
        if set(want) != set(manifest["leaves"]):
            raise ValueError(f"restore_checkpoint: {d} holds "
                             f"{sorted(manifest['leaves'])}, not the keys "
                             f"of the tree asked for")
        for key, shape in want.items():
            if isinstance(shape, tuple) and \
                    list(shape) != manifest["leaves"][key]["shape"]:
                raise ValueError(f"restore_checkpoint: {d} holds {key} "
                                 f"as {manifest['leaves'][key]['shape']}, "
                                 f"not {list(shape)}")
    sh_flat = _flatten(shardings) if shardings is not None else {}
    flat = {}
    for key, meta in manifest["leaves"].items():
        arr = np.load(d / meta["file"])
        t = bits_bf16(arr) if meta["dtype"] == "bfloat16" \
            else torch.from_numpy(arr)
        if key in sh_flat:
            flat[key] = Sharded.place(t, sh_flat[key])
        else:
            flat[key] = t.to(device) if device is not None else t
    return _nest(flat)


class CheckpointManager:
    """Async checkpointing with retention: ``save_async`` copies the
    tree's tensors to the host, then writes the tree on a thread while
    training goes on; the last ``keep`` steps stay. A numpy leaf is
    written as it is: the caller hands over arrays it does not change
    until the save is done (``train.loop.state_tree``'s are new)."""

    def __init__(self, ckpt_dir: Path, keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any, extra=None):
        self.wait()
        host = {k: _host(v) for k, v in _flatten(tree).items()}

        def work():
            try:
                save_checkpoint(self.dir, step, _nest(host), extra)
                self._gc()
            except BaseException as e:   # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the running save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self):
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)


def _nest(flat: Dict[str, Any]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        node = tree
        *up, last = key.split("/")
        for k in up:
            node = node.setdefault(k, {})
        node[last] = v
    return tree
