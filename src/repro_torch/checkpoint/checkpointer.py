"""Step-granular checkpoints of tensor trees
(``repro.checkpoint.checkpointer``, rewritten for PyTorch).

The on-disk format is the reference's, so either package reads what the
other writes:

* one ``step_{step:010d}/`` directory per checkpoint holding
  ``arrays.npz``, ``meta.json`` and a ``COMMITTED`` marker, written into a
  temporary directory and renamed into place, so a torn write is never
  read;
* leaves keyed by their tree path with the reference's sanitising regex
  (``params/stage0/u0/mixer/wq`` -> ``params_stage0_u0_mixer_wq``); stage
  parameters are the stacked ``[repeats, ...]`` tensors, as the reference
  stacks them, and AdamW's state sits under ``opt/m/...``, ``opt/v/...``
  and ``opt/step``;
* asynchronous saves: the device-to-host copy happens on the caller's
  thread, serialization on a background thread.  A save first waits for
  the previous one to reach the disk, so at most one snapshot is held in
  host memory (a full-width model's state is tens of GB);
* ``restore(template)`` validates every leaf's shape against the template
  and returns tensors of the template's dtypes, devices and
  ``requires_grad``.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tree import leaves_with_path

_SANITIZE = re.compile(r"[^A-Za-z0-9_.:-]")


def _flatten(tree) -> Dict[str, np.ndarray]:
    """``{sanitised path: host array}`` of every leaf."""
    return {_SANITIZE.sub("_", path): leaf.detach().cpu().numpy()
            if torch.is_tensor(leaf) else np.asarray(leaf)
            for path, leaf in leaves_with_path(tree)}


def _unflatten(template, arrays, prefix: str = ""):
    """``template``'s tree with each leaf read from ``arrays`` (a mapping
    of sanitised paths, e.g. an open ``.npz``), one leaf at a time."""
    if isinstance(template, dict):
        return {k: _unflatten(v, arrays, f"{prefix}/{k}" if prefix else k)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten(v, arrays, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(template))
    key = _SANITIZE.sub("_", prefix)
    if key not in arrays:
        raise KeyError(f"checkpoint missing leaf {key}")
    arr = arrays[key]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                         f"template {tuple(template.shape)}")
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(
        device=template.device, dtype=template.dtype)
    return t.requires_grad_(template.requires_grad)


class Checkpointer:
    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if async_save:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # ----------------------------------------------------------------- save
    def save(self, step: int, state: Any, meta: Optional[Dict] = None) -> None:
        """Snapshot ``state`` for ``step``: device-to-host copy on the
        caller's thread, serialization in the background if enabled."""
        self.wait()                    # one snapshot in host memory at most
        arrays = _flatten(state)
        payload = (step, arrays, dict(meta or {}))
        if self.async_save:
            self._queue.put(payload)
        else:
            self._write(*payload)

    def wait(self) -> None:
        """Block until queued async saves hit disk."""
        if self.async_save:
            self._queue.join()
        if self._error is not None:
            raise RuntimeError("async checkpoint writer failed") \
                from self._error

    def _drain(self) -> None:
        while True:
            payload = self._queue.get()
            try:
                self._write(*payload)
            except BaseException as e:  # pragma: no cover
                self._error = e
            finally:
                self._queue.task_done()

    def _write(self, step: int, arrays: Dict[str, np.ndarray],
               meta: Dict) -> None:
        final = self.dir / f"step_{step:010d}"
        tmp = Path(tempfile.mkdtemp(dir=self.dir, prefix=".tmp_"))
        np.savez(tmp / "arrays.npz", **arrays)
        meta = dict(meta, step=step, n_leaves=len(arrays))
        (tmp / "meta.json").write_text(json.dumps(meta, allow_nan=False))
        (tmp / "COMMITTED").write_text("ok")     # marker: write completed
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        for step in self.all_steps()[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{step:010d}", ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        steps = []
        for d in self.dir.glob("step_*"):
            if (d / "COMMITTED").exists():      # ignore torn writes
                steps.append(int(d.name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any,
                step: Optional[int] = None) -> Tuple[int, Any, Dict]:
        """Returns (step, state, meta); raises if no committed checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = self.dir / f"step_{step:010d}"
        with np.load(d / "arrays.npz") as z:
            state = _unflatten(template, z)
        meta = json.loads((d / "meta.json").read_text())
        return step, state, meta
