"""Milestone checkpoints of a TrainState.

Port of ``cindm_tpu/train/checkpoint.py``. The JAX package saves its full
state with orbax; the card has no orbax, so a milestone here is one
``torch.save`` file, ``<directory>/model-{milestone}.pt`` (the reference's
``.pt`` naming), holding the parameters, the EMA parameters, the optimizer
state (Adam moments and counts, the accumulation buffer) and the step.

``load`` falls back to the newest ``persisted_m*.npz`` snapshot in the
directory when no milestone file exists, as the JAX package does; such a
snapshot carries no optimizer state, so the learning-rate schedule's count is
seeded from the restored step and a resume past step 600,000 trains at the
decayed rate. The Adam moments stay fresh.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from ..utils.persist import _PERSIST_RE, find_persisted, load_npz
from .trainer import TrainState

_MILESTONE_RE = re.compile(r"^model-(\d+)\.pt$")


def seed_schedule_count(state: TrainState) -> TrainState:
    """Align the learning-rate schedule's count with the restored step."""
    state.opt_state.schedule_count = state.step
    return state


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, milestone: int) -> str:
        return os.path.join(self.directory, f"model-{milestone}.pt")

    def save(self, milestone: int, state: TrainState) -> None:
        blob = {
            "params": state.model.state_dict(),
            "ema_params": state.ema.state_dict(),
            "opt_state": state.opt_state.state_dict(),
            "step": state.step,
        }
        tmp = self._path(milestone) + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, self._path(milestone))

    def load(self, milestone: Optional[int] = None, template: Optional[TrainState] = None):
        """Restore the given milestone (latest if None) into ``template``, a
        TrainState of the same model and config, and return it; without a
        template, return the saved dict. Falls back to a ``persisted_m*.npz``
        snapshot (which needs a template) when the milestone file is absent."""
        have = self.all_milestones()
        step = milestone if milestone is not None else (have[-1] if have else None)
        if step is None or step not in have:
            npz = find_persisted(self.directory, milestone)
            if npz is not None and template is not None:
                return seed_schedule_count(load_npz(npz, template))
            want = "latest" if milestone is None else f"milestone {milestone}"
            hint = (f"; a persisted snapshot exists ({npz}) but restoring it "
                    f"requires template=" if npz is not None else "")
            raise FileNotFoundError(f"no checkpoint for {want} in {self.directory}{hint}")
        blob = torch.load(self._path(step), map_location="cpu")
        if template is None:
            return blob
        template.model.load_state_dict(blob["params"])
        template.ema.load_state_dict(blob["ema_params"])
        template.opt_state.load_state_dict(blob["opt_state"])
        template.step = int(blob["step"])
        return template

    def all_milestones(self) -> list[int]:
        found = (_MILESTONE_RE.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_milestone(self) -> Optional[int]:
        have = self.all_milestones()
        if have:
            return have[-1]
        npz = find_persisted(self.directory)
        return int(_PERSIST_RE.search(npz).group(1)) if npz is not None else None
