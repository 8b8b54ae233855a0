"""Atomic, asynchronous step checkpoints — a torch-side reader and writer of
the reference's on-disk layout (``repro.checkpoint.checkpointer``).

Layout of one committed step::

    <dir>/step_XXXXXXXX/manifest.json    {"step", "time", "treedef",
                                          "arrays": {key: {"file", "shape",
                                                           "dtype"}}}
    <dir>/step_XXXXXXXX/<file>.npy        one array per key

Keys are the tree paths joined with ``//`` (dict keys sorted, as JAX
flattens them). File names come from Python's per-process salted
``hash(key)``, so a reader always resolves files through the manifest,
never by recomputing names. Writes go to ``step_XXXXXXXX.tmp/`` and are
renamed after the manifest is fsync'd, so a crash never leaves a partial
step that looks committed. Saving copies the arrays to the host at call
time and serialises them on a worker thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

_FLAT_SEP = "//"


def _flatten(tree, prefix=()) -> dict:
    """Nested dicts/lists/tuples of arrays → ``{"a//b": leaf}`` in JAX's
    flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (str(i),)))
        return out
    return {_FLAT_SEP.join(prefix): tree}


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that later in-place updates cannot reach:
    ``.cpu()`` copies a device tensor, and a host tensor or array is
    cloned, since the writer thread serialises it after ``save`` returns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return (t.cpu() if t.device.type != "cpu" else t.clone()).numpy()
    return np.array(leaf, copy=True)


class Checkpointer:
    """Step checkpoints in one directory, with retention.

    ``keep`` newest steps survive garbage collection, plus every multiple of
    ``keep_every`` when it is set.
    """

    def __init__(self, directory, *, keep: int = 3, keep_every: int = 0):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.keep_every = keep_every
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: dict, *, blocking: bool = False) -> None:
        """Snapshot ``tree`` to host memory now, serialise on a thread."""
        self.wait()  # one in-flight save at a time
        host = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
        treedef = "PyTreeDef({" + ", ".join(f"{k!r}: *" for k in host) + "})"

        def work():
            try:
                self._write(step, host, treedef)
                self._gc()
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write(self, step, host, treedef_str):
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        manifest = {"step": step, "time": time.time(), "arrays": {},
                    "treedef": treedef_str}
        for key, arr in host.items():
            fn = f"{abs(hash(key)) % 10**12:012d}.npy"
            np.save(tmp / fn, arr)
            manifest["arrays"][key] = {
                "file": fn, "shape": list(arr.shape), "dtype": str(arr.dtype)}
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic commit

    def wait(self) -> None:
        """Join the in-flight save; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # -- restore --------------------------------------------------------------

    def latest_step(self) -> int | None:
        """Newest committed step (a manifest present, not ``.tmp``)."""
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
            if not p.name.endswith(".tmp")
            and (p / "manifest.json").exists())
        return steps[-1] if steps else None

    def restore(self, step: int, keys) -> dict[str, np.ndarray]:
        """``{key: array}`` for each requested key of a committed step;
        raises ``KeyError`` naming a key the step does not hold."""
        path = self.dir / f"step_{step:08d}"
        manifest = json.loads((path / "manifest.json").read_text())
        out = {}
        for key in keys:
            meta = manifest["arrays"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing array {key!r}")
            out[key] = np.load(path / meta["file"])
        return out

    # -- retention ------------------------------------------------------------

    def _gc(self):
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
            if not p.name.endswith(".tmp"))
        doomed = steps[:-self.keep] if self.keep else []
        for s in doomed:
            if self.keep_every and s % self.keep_every == 0:
                continue
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
