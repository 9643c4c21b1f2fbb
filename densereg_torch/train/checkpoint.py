"""Checkpoints of the training state on ``torch.save``.

One file a step, ``<directory>/ckpt_<step>.pt``, holding the whole state:
the net's parameters and buffers (the renorm moving statistics), the
optimizer's moments and count, the step, the renorm schedule clock, the
EMA weights and the states of the trainer's random generators. A save
writes a temporary file and renames it, so a checkpoint on disk is always
whole; ``max_to_keep`` bounds how many stay.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional

import torch

from densereg_torch.config import NetConfig
from densereg_torch.models import DenseRegNet
from densereg_torch.train.state import TrainState

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{int(step)}.pt")

    def steps(self) -> List[int]:
        """The steps on disk, ascending."""
        if not os.path.isdir(self.directory):
            return []
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, step: Optional[int] = None,
             generators: Optional[Dict[str, torch.Generator]] = None) -> str:
        """Write the state at ``step`` (default ``state.step``) and drop the
        oldest checkpoints beyond ``max_to_keep``. Returns the path."""
        step = state.step if step is None else int(step)
        payload = {
            "net": {k: v.detach().cpu() for k, v in
                    state.net.state_dict().items()},
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
            "renorm_t": state.renorm_t.detach().cpu().clone(),
            "ema": (None if state.ema is None else
                    {k: v.detach().cpu() for k, v in state.ema.items()}),
            "generators": {k: g.get_state()
                           for k, g in (generators or {}).items()},
        }
        os.makedirs(self.directory, exist_ok=True)
        path = self.path(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        if self.max_to_keep is not None:
            for old in self.steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        return path

    def load(self, step: Optional[int] = None) -> dict:
        """The payload of checkpoint ``step`` (``None`` or ``-1``: the
        latest), on the CPU."""
        if step is None or step == -1:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, state: TrainState, step: Optional[int] = None,
                generators: Optional[Dict[str, torch.Generator]] = None
                ) -> TrainState:
        """Load checkpoint ``step`` (latest by default) into ``state`` and
        ``generators`` in place; returns ``state``. A checkpoint without EMA
        weights restores into an EMA state by starting the EMA again from
        the restored parameters."""
        payload = self.load(step)
        state.net.load_state_dict(payload["net"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        state.renorm_t = payload["renorm_t"].to(torch.float32)
        if state.ema is not None:
            dev = next(state.net.parameters()).device
            saved = payload["ema"]
            if saved is None:
                saved = {k: p.detach() for k, p in
                         state.net.named_parameters()}
            state.ema = {k: v.to(dev).clone() for k, v in saved.items()}
        for name, gen in (generators or {}).items():
            if name in payload["generators"]:
                gen.set_state(payload["generators"][name])
        return state


def restore_net(train_dir: str, net_cfg: NetConfig, step: Optional[int] = -1,
                use_ema: bool = False, use_best: bool = False) -> DenseRegNet:
    """The float, unfolded net of a checkpoint of ``train.loop.train``, in
    eval mode on the CPU: ``train_dir`` is the run's directory, ``step`` a
    saved step (-1 or None: the latest), ``use_ema`` the EMA weights (a run
    trained with ``TrainConfig.ema_decay``), ``use_best`` the
    best-validation checkpoint (``train_dir/ckpt_best``,
    ``TrainConfig.keep_best``)."""
    mgr = CheckpointManager(os.path.join(
        train_dir, "ckpt_best" if use_best else "ckpt"))
    payload = mgr.load(step)
    state = payload["net"]
    if use_ema:
        if payload["ema"] is None:
            raise ValueError("checkpoint has no EMA weights; train with "
                             "TrainConfig.ema_decay to use use_ema")
        state = {**state, **payload["ema"]}
    net = DenseRegNet(dataclasses.replace(net_cfg, fold_bn=False,
                                          quantize=False))
    net.load_state_dict(state)
    return net.eval()
