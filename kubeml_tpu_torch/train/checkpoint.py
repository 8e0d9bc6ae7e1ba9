"""Model checkpoints in the JAX package's format (twin of
kubeml_tpu/train/checkpoint.py), so each package loads the other's:

    $KUBEML_TPU_HOME/models/<job_id>/
        weights.npz     flat leaves keyed by '/'-joined flax tree paths
                        ("params/Dense_0/kernel", ...)
        manifest.json   model, function, dataset, epoch, history, ...

A job converts its state dict into the flax layout through its model's
``params_to_flax`` (a Dense kernel is [in, out] there, a Linear weight
[out, in] here), so this module only flattens and unflattens nested
dicts of arrays: it knows no model.

Publishing is crash-safe: at every instant either the current directory
or ``<job_id>.old`` holds a complete checkpoint, and readers fall back to
``.old``. ``AsyncCheckpointer`` snapshots the weights on the device and
writes them from a background thread.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from kubeml_tpu_torch.api.const import kubeml_home
from kubeml_tpu_torch.api.errors import JobNotFoundError

logger = logging.getLogger("kubeml_tpu_torch.checkpoint")

Tree = Dict[str, Any]   # nested dicts of numpy arrays (or tensors)


def _models_root() -> str:
    return os.path.join(kubeml_home(), "models")


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """'/'-joined key paths in sorted key order (jax's flatten order)."""
    flat = {}
    for key in sorted(tree):
        leaf = tree[key]
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(leaf, dict):
            flat.update(_flatten(leaf, path))
        elif isinstance(leaf, torch.Tensor):
            flat[path] = leaf.detach().cpu().numpy()
        else:
            flat[path] = np.asarray(leaf)
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> Tree:
    out: Tree = {}
    for key, arr in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return out


def save_checkpoint(job_id: str, variables: Tree, manifest: dict,
                    root: Optional[str] = None) -> str:
    """Write ``variables`` (the flax variable tree, e.g. {"params": ...})
    and the manifest under the job's directory, publishing atomically."""
    root = root or _models_root()
    d = os.path.join(root, job_id)
    tmp = d + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "weights.npz"), **_flatten(variables))
    manifest = dict(manifest, job_id=job_id, saved_at=time.time())
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    # the .old copy is dropped only once the new directory is published:
    # a crash between the two renames leaves .old as the good copy
    old = d + ".old"
    if os.path.isdir(d):
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.rename(d, old)
    os.rename(tmp, d)
    shutil.rmtree(old, ignore_errors=True)
    return d


def _resolve_dir(job_id: str, root: Optional[str]) -> str:
    """The directory holding the job's newest complete checkpoint: the
    current one, else the ``.old`` fallback a crash mid-publish left."""
    d = os.path.join(root or _models_root(), job_id)
    if os.path.isfile(os.path.join(d, "manifest.json")):
        return d
    old = d + ".old"
    if os.path.isfile(os.path.join(old, "manifest.json")):
        return old
    return d  # missing everywhere: callers raise JobNotFound


def load_checkpoint(job_id: str, root: Optional[str] = None
                    ) -> Tuple[Tree, dict]:
    """(variables tree of numpy arrays, manifest). Raises JobNotFoundError
    when the job has no checkpoint; a read that races a concurrent
    publish is retried once."""
    base = os.path.join(root or _models_root(), job_id)
    if not os.path.isdir(base) and not os.path.isdir(base + ".old"):
        raise JobNotFoundError(job_id)
    for attempt in (0, 1):
        d = _resolve_dir(job_id, root)
        if not os.path.isfile(os.path.join(d, "manifest.json")):
            if attempt:
                raise JobNotFoundError(job_id)
            time.sleep(0.05)
            continue
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            with np.load(os.path.join(d, "weights.npz")) as z:
                variables = _unflatten({k: z[k] for k in z.files})
            return variables, manifest
        except (OSError, ValueError) as e:
            if attempt:
                raise
            logger.warning("checkpoint read for %s raced a publish (%s); "
                           "retrying", job_id, e)
            time.sleep(0.05)


def checkpoint_saved_at(job_id: str, root: Optional[str] = None
                        ) -> Optional[float]:
    """The manifest's ``saved_at`` stamp, or None when the job has no
    readable checkpoint: the cheap freshness probe of the PS's inference
    cache and of the crash watchdog. save_checkpoint stamps every manifest
    with a newer time.time(), so the probe does not depend on the file
    system's mtime granularity. A read that races a publish is retried
    once."""
    base = os.path.join(root or _models_root(), job_id)
    for attempt in (0, 1):
        try:
            with open(os.path.join(_resolve_dir(job_id, root),
                                   "manifest.json")) as f:
                return json.load(f).get("saved_at")
        except (OSError, ValueError):
            if attempt or (not os.path.isdir(base)
                           and not os.path.isdir(base + ".old")):
                return None
            time.sleep(0.05)
    return None


def mark_checkpoint_completed(job_id: str, root: Optional[str] = None
                              ) -> None:
    """Stamp the published manifest ``completed=True``, weights untouched:
    a crash-recovery resume of a job whose last periodic save already
    holds its final state then finishes at once instead of retraining.
    ``saved_at`` is kept."""
    path = os.path.join(_resolve_dir(job_id, root), "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["completed"] = True
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, path)


class AsyncCheckpointer:
    """Background checkpoint writer: training never blocks on a save.

    ``save(job_id, state, manifest, to_tree)`` clones ``state`` (a flat
    dict of tensors) on its device and returns; one daemon thread copies
    the snapshot to the host, turns it into the checkpoint's tree with
    ``to_tree`` and publishes it. Pending saves are latest-wins per job
    (a coalesced save is counted in ``dropped_saves``). ``wait()`` drains
    the queue and raises the first error no later save of that job
    superseded; ``close()`` drains and stops the thread. One checkpointer
    per job."""

    def __init__(self, root: Optional[str] = None):
        self.root = root
        self._cond = threading.Condition()
        self._pending: Dict[str, tuple] = {}
        self._in_flight_job: Optional[str] = None
        self._errors: Dict[str, BaseException] = {}
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.dropped_saves = 0

    def save(self, job_id: str, state: Dict[str, torch.Tensor],
             manifest: dict,
             to_tree: Callable[[Dict[str, torch.Tensor]], Tree]) -> None:
        snap = {k: t.detach().clone() for k, t in state.items()}
        with self._cond:
            if self._closed:
                raise RuntimeError("AsyncCheckpointer is closed")
            if job_id in self._pending:
                self.dropped_saves += 1
                logger.info("checkpoint save for %s coalesced into a newer "
                            "snapshot (writer behind; %d dropped so far)",
                            job_id, self.dropped_saves)
            self._pending[job_id] = (snap, manifest, to_tree)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="kubeml-ckpt", daemon=True)
                self._thread.start()
            self._cond.notify_all()

    def wait(self) -> None:
        with self._cond:
            self._cond.wait_for(
                lambda: not self._pending and self._in_flight_job is None)
            if self._errors:
                job_id, err = next(iter(self._errors.items()))
                for other_job, other in self._errors.items():
                    if other_job != job_id:
                        logger.error("checkpoint save for job %s also "
                                     "failed: %s", other_job, other)
                self._errors.clear()
                raise err

    def close(self) -> None:
        """Drain outstanding writes and stop the worker; idempotent. A
        still-latched failure is logged, not raised (call wait() first
        when it must raise)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        with self._cond:
            for job_id, err in self._errors.items():
                logger.error("checkpoint save for job %s failed (discarded "
                             "at close): %s", job_id, err)
            self._errors.clear()

    def _run(self) -> None:
        while True:
            with self._cond:
                self._cond.wait_for(
                    lambda: bool(self._pending) or self._closed)
                if not self._pending:  # closed and drained
                    return
                job_id, item = next(iter(self._pending.items()))
                del self._pending[job_id]
                self._in_flight_job = job_id
            try:
                snap, manifest, to_tree = item
                save_checkpoint(job_id, to_tree(snap), manifest,
                                root=self.root)
                with self._cond:  # a durable newer save supersedes an error
                    self._errors.pop(job_id, None)
            except Exception as e:  # surfaced by wait()
                with self._cond:
                    self._errors.setdefault(job_id, e)
            finally:
                # drop the model-sized snapshot before idling
                item = snap = None
                with self._cond:
                    self._in_flight_job = None
                    self._cond.notify_all()
