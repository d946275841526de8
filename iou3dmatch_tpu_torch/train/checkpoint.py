"""Checkpoints in the reference's ``torch.save`` layout.

Counterpart of ``iou3dmatch_tpu/train/checkpoint.py``. The reference writes
``{epoch, loss, model_state_dict, optimizer_state_dict[,
ema_model_state_dict]}`` (pretrain.py:371-406, train.py:569-608), and stage
2 loads a stage-1 file into both the student and the EMA teacher
(train.py:204-228). The port writes that layout, and two more keys, the
state's step count and its jitter generator's state, so that a resumed run
is the uninterrupted one bit for bit; the reference's tools and the JAX
package's torch import (``checkpoint.py:109-127``) read the keys they know.
"""
import os

import torch

from .state import TrainState


def save(path: str, state: TrainState, epoch: int, loss: float = 0.0) -> None:
    """Writes ``state`` to ``path`` through ``path.tmp`` and a rename, so
    that a run killed while writing leaves the last file whole."""
    payload = {"epoch": int(epoch), "loss": float(loss),
               "model_state_dict": state.model.state_dict(),
               "optimizer_state_dict": state.optimizer.state_dict(),
               "step": state.step, "generator_state": state.generator.get_state()}
    if state.ema_model is not None:
        payload["ema_model_state_dict"] = state.ema_model.state_dict()
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _read(path: str) -> dict:
    # onto the CPU: load_state_dict copies each tensor to its parameter's
    # device, and Adam keeps its step counts on the CPU, where reading them
    # does not wait for the card
    return torch.load(path, map_location="cpu", weights_only=True)


def load(path: str, state: TrainState):
    """Loads a checkpoint into ``state`` in place, each tensor onto the
    device of the one it replaces, and returns (epoch, loss): the model;
    the teacher, where ``state`` has one, from the file's EMA weights or
    else from its model (a stage-1 file, train.py:569-585); Adam's state,
    the step count and the generator where the file has them. A file
    without an optimizer state (the JAX package's ``cli/export_torch.py``
    writes none) leaves Adam as it is."""
    payload = _read(path)
    state.model.load_state_dict(payload["model_state_dict"])
    if state.ema_model is not None:
        state.ema_model.load_state_dict(
            payload.get("ema_model_state_dict", payload["model_state_dict"]))
    if "optimizer_state_dict" in payload:
        state.optimizer.load_state_dict(payload["optimizer_state_dict"])
    state.step = int(payload.get("step", 0))
    if "generator_state" in payload:
        state.generator.set_state(payload["generator_state"])
    return int(payload["epoch"]), float(payload["loss"])


def load_pretrain_into_ssl(path: str, state: TrainState) -> None:
    """Loads a stage-1 checkpoint's model into both the student and the
    teacher of the SSL ``state`` (train.py:204-228), each into its own
    tensors, and restarts Adam and the step count, as the reference's
    non-``--resume`` path does (JAX ``checkpoint.py:130-160``)."""
    if state.ema_model is None:
        raise ValueError("the SSL state needs a teacher: create_train_state(..., with_ema=True)")
    payload = _read(path)
    state.model.load_state_dict(payload["model_state_dict"])
    state.ema_model.load_state_dict(payload["model_state_dict"])
    state.optimizer.state.clear()
    state.step = 0
