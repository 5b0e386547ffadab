"""Checkpoint and resume.

The port of ``xgnn_tpu/checkpoint.py``'s ``CheckpointManager`` with its face
(``save(step, state, extra)``, ``latest_step``, ``restore``, ``close``,
``max_to_keep=3``), written with ``torch.save`` in place of Orbax.  A
state is a ``(model, opt)`` pair: the file holds the model's state dict,
Adam's ``mu``, ``nu`` and ``count``, and ``extra`` (the engine's epoch).
Each file is written to a temporary name and renamed into place, so a
crash mid-write leaves the previous checkpoints whole.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def steps(self) -> list:
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.directory))
                      if m)

    def save(self, step: int, state, extra: Optional[dict] = None):
        model, opt = state
        payload = {
            "model": {k: v.detach().cpu() for k, v in
                      model.state_dict().items()},
            "mu": [t.detach().cpu() for t in opt.mu],
            "nu": [t.detach().cpu() for t in opt.nu],
            "count": opt.count.detach().cpu(),
            "epoch": int((extra or {}).get("epoch", -1)),
        }
        tmp = self._path(step) + f".{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state, step: Optional[int] = None):
        """Load into the ``(model, opt)`` pair in place; returns ``(state,
        extra)``, or ``(None, None)`` when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        payload = torch.load(self._path(step), map_location="cpu",
                             weights_only=True)
        model, opt = state
        model.load_state_dict(payload["model"])
        with torch.no_grad():
            for dst, src in zip(opt.mu + opt.nu + [opt.count],
                                payload["mu"] + payload["nu"]
                                + [payload["count"]]):
                dst.copy_(src)
        return state, {"epoch": int(payload["epoch"])}

    def close(self):
        """Nothing is held open between calls."""
