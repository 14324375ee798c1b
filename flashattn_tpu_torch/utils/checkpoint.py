"""Checkpoint and resume of a model and its optimizer state (counterpart of
flashattn_tpu/utils/checkpoint.py, which writes orbax checkpoints).

The format is the port's own: one ``torch.save`` file,
``<path>/checkpoint.pt``, holding the model's ``state_dict``, the
optimizer state (its NamedTuples saved as plain tuples of tensors, ints and
dicts, so that ``torch.load(weights_only=True)`` reads it back) and the
step.  It is written to a temporary file in ``path`` and renamed, so a
reader never sees half a checkpoint.  It is not orbax: a checkpoint of the
JAX package does not load here, nor one of the port there (use
``convert.load_jax_params`` to carry JAX weights across).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Optional, Tuple

import torch
from torch import nn

_FILE = "checkpoint.pt"


def _to_host(tree: Any) -> Any:
    """``tree`` with every tensor copied to the host and every tuple (a
    NamedTuple too) made a plain tuple."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_host(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_to_host(v) for v in tree)
    return tree


def _like(template: Any, saved: Any, where: str = "opt_state") -> Any:
    """``saved`` in the structure of ``template``: NamedTuples rebuilt, each
    tensor on its template's device and in its dtype."""
    if isinstance(template, torch.Tensor):
        return saved.to(device=template.device, dtype=template.dtype)
    if isinstance(template, dict):
        if set(template) != set(saved):
            raise KeyError(f"{where}: checkpoint keys differ from the "
                           f"template's")
        return {k: _like(template[k], saved[k], f"{where}.{k}")
                for k in template}
    if isinstance(template, (tuple, list)):
        if len(template) != len(saved):
            raise ValueError(f"{where}: {len(saved)} entries, the template "
                             f"has {len(template)}")
        vals = [_like(t, s, f"{where}[{i}]")
                for i, (t, s) in enumerate(zip(template, saved))]
        if hasattr(template, "_fields"):
            return type(template)(*vals)
        return vals if isinstance(template, list) else tuple(vals)
    return saved


def _payload(model: nn.Module, opt_state: Any, step: int) -> dict:
    return {"model": _to_host(model.state_dict()),
            "opt_state": _to_host(opt_state), "step": int(step)}


def _write(path: str, payload: dict) -> None:
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".{_FILE}.{os.getpid()}.{threading.get_ident()}")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _FILE))


def save_checkpoint(path: str, model: nn.Module, opt_state: Any = None,
                    step: int = 0) -> None:
    """Write model (+ optional optimizer state) and ``step`` to ``path`` (a
    directory, created if needed)."""
    _write(path, _payload(model, opt_state, step))


class AsyncCheckpointManager:
    """Checkpoint writes off the training thread: ``save`` copies the
    tensors to the host (the only part that waits for the device) and
    writes the file in a background thread.  Call ``wait`` (or the next
    ``save``, which waits for the previous write) before reading the files
    back; ``close`` waits and ends the manager."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, path: str, model: nn.Module, opt_state: Any = None,
             step: int = 0) -> None:
        self.wait()
        payload = _payload(model, opt_state, step)

        def write():
            try:
                _write(path, payload)
            except Exception as e:       # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()


def restore_checkpoint(path: str, model_template: nn.Module,
                       opt_state_template: Any = None
                       ) -> Tuple[nn.Module, Any, int]:
    """Restore (model, opt_state, step) from ``path``.

    The templates give the structure, devices and dtypes (a freshly built
    model and ``opt.init(model)``): the model's parameters are loaded in
    place, the optimizer state is rebuilt in the template's structure with
    each tensor on its template's device."""
    payload = torch.load(os.path.join(os.path.abspath(path), _FILE),
                         map_location="cpu", weights_only=True)
    model_template.load_state_dict(payload["model"])
    opt_state = payload["opt_state"]
    if opt_state_template is not None:
        opt_state = _like(opt_state_template, opt_state)
    return model_template, opt_state, payload["step"]
