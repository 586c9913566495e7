"""Checkpointing: npz + manifest, atomic commit, async save, GC.

A port of the JAX package's ``checkpoint/checkpoint.py``, with its restart
semantics:
  * SAVE: leaves are written to ``step_N.tmp/`` and the directory is then
    renamed, so a crash mid-save never corrupts the latest checkpoint;
  * manifest.json records the step and the groups; ``latest_step`` scans
    committed directories only;
  * async mode copies every leaf from the device to the host synchronously
    (the caller may update the tensors right after `save` returns) and
    does the file I/O on a background thread, joined before the next save
    or by `wait`;
  * ``keep_last`` garbage-collects old steps.

A state is ``{group name: tree}``, each tree a nested dict of tensors (or
numpy arrays), stored one ``<group>.npz`` a checkpoint by its leaves'
``/``-joined paths.  A bfloat16 leaf is stored as its uint16 words (numpy
has no bfloat16).  `restore` rebuilds each leaf on its template leaf's
device and in its dtype.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_SEP = "/"


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    else:
        yield _SEP.join(prefix), tree


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_host(leaf) for key, leaf in _paths(tree)}


def _from_host(arr: np.ndarray, template):
    if isinstance(template, torch.Tensor):
        if template.dtype == torch.bfloat16 and arr.dtype == np.uint16:   # stored words
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr)).to(template.dtype)
        return t.reshape(template.shape).to(template.device)
    return np.asarray(arr).astype(np.asarray(template).dtype).reshape(np.shape(template))


def _unflatten(template, flat: Dict[str, np.ndarray], prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, prefix + (str(k),)) for k, v in template.items()}
    return _from_host(flat[_SEP.join(prefix)], template)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save ---
    def save(self, step: int, state: Dict[str, Any]):
        flat = {name: _flatten(tree) for name, tree in state.items()}
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(target=self._write, args=(step, flat), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat)

    def _write(self, step: int, flat: Dict[str, Dict[str, np.ndarray]]):
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for name, leaves in flat.items():
            np.savez(os.path.join(tmp, f"{name}.npz"), **leaves)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "groups": sorted(flat)}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ---------------------------------------------------------- restore ---
    def steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, templates: Dict[str, Any]) -> Tuple[int, Dict]:
        base = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(base, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["step"] != step:
            raise ValueError(f"{base}: manifest step {manifest['step']} != {step}")
        out = {}
        for name, template in templates.items():
            with np.load(os.path.join(base, f"{name}.npz")) as z:
                flat = {k: z[k] for k in z.files}
            out[name] = _unflatten(template, flat)
        return step, out
