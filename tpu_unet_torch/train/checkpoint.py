"""Checkpoint and resume (counterpart of ``tpu_unet/train/checkpoint.py``).

A checkpoint is the whole training state under one directory per tag
(best / latest / goal-*): ``state.pt`` holds the model's and the
optimizer's state_dicts (parameters, SGD momentum buffers, learning rate)
through ``torch.save``, and ``host_state.json`` the host-side scalars
(epoch, plateau scheduler, best loss), as the JAX package's sidecar.

`save_async` keeps the JAX package's latest-wins slot per tag. One
difference: JAX arrays are immutable, so JAX queues a reference; torch
parameters and buffers are updated in place by the next optimizer step, so
`save_async` copies the state to host memory before it returns, and the
slot holds that copy.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Tuple

import torch

_STATE = "state.pt"
_HOST = "host_state.json"


def _host_copy(state: Any) -> Any:
    """A copy of a nest of dicts, lists and tuples of tensors, with every
    tensor detached and copied to host memory."""
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, dict):
        return {k: _host_copy(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_host_copy(v) for v in state)
    return state


class Checkpointer:
    """Filesystem checkpoints: one directory per tag.

    Writes go through one worker thread, so writes of one tag stay in
    order; `wait()` drains them before a restore or an exit."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        self._lock = threading.Lock()
        # tag -> newest not-yet-started (host state copy, host scalars);
        # a new save_async replaces it, so a superseded copy is dropped
        self._next: Dict[str, Tuple[Any, Dict[str, Any]]] = {}
        self._inflight: Dict[str, Any] = {}  # tag -> drain Future

    def _path(self, tag: str) -> str:
        return os.path.join(self.directory, tag)

    def save(self, tag: str, state: Any, host_state: Dict[str, Any]) -> str:
        """Write `state` (tensors anywhere) and `host_state` under `tag`,
        replacing an older checkpoint of that tag only once the new one is
        complete."""
        path = self._path(tag)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, _STATE))
        with open(os.path.join(tmp, _HOST), "w") as f:
            json.dump(host_state, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        return path

    def save_async(self, tag: str, state: Any, host_state: Dict[str, Any]) -> None:
        """Queue a save without waiting for the write: `state` is copied to
        host memory now (later in-place updates do not reach it), then put
        in the tag's one slot, replacing a pending copy not yet started."""
        item = (_host_copy(state), dict(host_state))
        with self._lock:
            self._next[tag] = item
            f = self._inflight.get(tag)
            if f is None or f.done():
                self._inflight[tag] = self._executor.submit(self._drain, tag)

    def _drain(self, tag: str) -> None:
        while True:
            with self._lock:
                item = self._next.pop(tag, None)
            if item is None:
                return
            self.save(tag, *item)

    def wait(self) -> None:
        """Drain queued async saves (re-raises the first failure)."""
        err = None
        while True:
            with self._lock:
                futures = list(self._inflight.values())
            for f in futures:
                try:
                    f.result()
                except Exception as e:  # noqa: BLE001 — re-raised below
                    if err is None:
                        err = e
            with self._lock:
                # a save_async racing a finishing _drain can leave its slot
                # filled with no live worker: restart drains until empty
                stranded = [t for t in self._next
                            if (self._inflight.get(t) is None
                                or self._inflight[t].done())]
                for t in stranded:
                    self._inflight[t] = self._executor.submit(self._drain, t)
                done = (not self._next
                        and all(f.done() for f in self._inflight.values()))
                if done:
                    self._inflight = {}
            if done:
                if err is not None:
                    raise err
                return

    def restore(self, tag: str) -> Tuple[Any, Dict[str, Any]]:
        """(state with tensors on the host, host_state) of `tag`, after
        draining pending saves."""
        self.wait()
        path = self._path(tag)
        state = torch.load(os.path.join(path, _STATE), map_location="cpu",
                           weights_only=True)
        with open(os.path.join(path, _HOST)) as f:
            host_state = json.load(f)
        return state, host_state

    def exists(self, tag: str) -> bool:
        return os.path.isdir(self._path(tag))
