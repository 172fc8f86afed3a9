"""Checkpointing: atomic, keep-K, resumable (port of
``repro.checkpoint.manager``).

* Every checkpoint is a directory ``step_<N>/`` holding ``arrays.npz``
  (leaf ``i`` under the name ``a<i>``) and ``manifest.json`` (the leaves'
  tree paths, shapes and dtypes, and the caller's ``extra`` dict).  The
  format is the reference's, and so are the path strings (``['key']`` for
  a dict key, ``[i]`` for a list or tuple index, joined by ``/``), so
  either package reads the other's snapshots.  A quantised moment
  (``optim.adamw.QTensor``) is two leaves, ``q`` and ``scale``, under
  ``[<flat index 0>]`` and ``[<flat index 1>]`` as the reference's pytree
  flattening names them; its original shape comes from the template on
  restore, as in the reference.  A bf16 leaf is written as the reference
  writes one: its 2-byte words as a ``V2`` array, ``bfloat16`` in the
  manifest.
* Writes go to ``step_<N>.tmp/`` and are renamed atomically: a crash
  mid-write never corrupts the latest checkpoint, and the next save
  collects the orphaned ``.tmp``.
* ``async_save``: the device->host copy happens on the caller's thread,
  and the writer thread only serialises host arrays (it never touches
  CUDA).
* ``restore(state_like, device=...)`` rebuilds the structure of
  ``state_like`` (nested dicts, lists and tuples); ``device`` places
  every leaf as a tensor on that device.  A restore sharded over a mesh
  belongs to the multi-device slice.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.env import resolve_device
from repro_torch.optim.adamw import QTensor

# the path suffixes of a QTensor's two leaves (jax's FlattenedIndexKey)
QTENSOR_KEYS = ("[<flat index 0>]", "[<flat index 1>]")


def _flatten_with_paths(tree) -> Tuple[List[str], List]:
    """Leaves of ``tree`` in the reference's order (dict keys sorted,
    sequences in order, ``None`` holds no leaf) with their path strings."""
    paths: List[str] = []
    leaves: List = []

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + [f"[{key!r}]"])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [f"[{i}]"])
        elif isinstance(node, QTensor):
            walk(node.q, path + [QTENSOR_KEYS[0]])
            walk(node.scale, path + [QTENSOR_KEYS[1]])
        elif node is not None:
            paths.append("/".join(path))
            leaves.append(node)

    walk(tree, [])
    return paths, leaves


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves)
                for key in sorted(like)}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves) for v in like]
        return out if isinstance(like, list) else tuple(out)
    if like is None:
        return None
    if isinstance(like, QTensor):
        return QTensor(q=next(leaves), scale=next(leaves), shape=like.shape)
    return next(leaves)


def _to_host(x) -> np.ndarray:
    """A host copy of one leaf, safe to write after the caller moves on;
    a bf16 tensor as its 2-byte words (``V2``)."""
    if torch.is_tensor(x):
        t = x.detach()
        t = t.cpu() if t.device.type != "cpu" else t.clone()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.array(x)


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == np.dtype("V2") else str(a.dtype)


def _to_tensor(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ io
    def save(self, step: int, state: Any,
             extra: Optional[Dict] = None) -> str:
        if self._thread is not None:
            self._thread.join()  # one in-flight save at a time
        paths, leaves = _flatten_with_paths(state)
        host_leaves = [_to_host(x) for x in leaves]  # device -> host

        def _write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{f"a{i}": a for i, a in enumerate(host_leaves)})
            manifest = {
                "step": step,
                "paths": paths,
                "shapes": [list(a.shape) for a in host_leaves],
                "dtypes": [_dtype_name(a) for a in host_leaves],
                "extra": extra or {},
                "time": time.time(),
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)   # atomic publish
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
        return os.path.join(self.dir, f"step_{step}")

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
        # a writer that died between the tmp write and the rename leaves
        # step_<N>.tmp behind; the current save's tmp is renamed by now
        # (one save in flight at a time), so every remaining .tmp is
        # garbage
        for name in os.listdir(self.dir):
            if re.fullmatch(r"step_\d+\.tmp", name):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load(self, step: Optional[int]):
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as data:
            leaves = [data[f"a{i}"] for i in range(len(manifest["paths"]))]
        return manifest, leaves

    def restore_items(self, step: Optional[int] = None
                      ) -> Tuple[Dict[str, np.ndarray], Dict]:
        """Restore a checkpoint whose state was a FLAT ``{key: array}``
        dict, without a template: keys come from the manifest's paths.
        This is the service's restore (slot states vary in shape and
        occupancy tick to tick, so no fixed template exists)."""
        manifest, leaves = self._load(step)
        items: Dict[str, np.ndarray] = {}
        for path, leaf in zip(manifest["paths"], leaves):
            m = re.fullmatch(r"\['(.*)'\]", path)
            items[m.group(1) if m else path] = leaf
        return items, manifest["extra"]

    def restore(self, state_like: Any, step: Optional[int] = None,
                device: str | torch.device | None = None
                ) -> Tuple[Any, Dict]:
        """Restore into the structure of ``state_like``.  With ``device``
        every leaf becomes a tensor there; without it each leaf takes its
        template's kind (a tensor on the template tensor's device, else a
        numpy array)."""
        manifest, leaves = self._load(step)
        _, ref_leaves = _flatten_with_paths(state_like)
        if len(leaves) != len(ref_leaves):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, state "
                             f"{len(ref_leaves)}")
        dev = None if device is None else resolve_device(device)
        placed = []
        for a, ref, dt in zip(leaves, ref_leaves, manifest["dtypes"]):
            if dev is not None:
                placed.append(_to_tensor(a, dt).to(dev))
            elif torch.is_tensor(ref):
                placed.append(_to_tensor(a, dt).to(ref.device))
            else:
                placed.append(a)
        return _unflatten(state_like, iter(placed)), manifest["extra"]
