"""Checkpoint save and resume with torch.save (counterpart of
mvdfusion_tpu/core/checkpoint.py): a step-indexed file per save under
`ckpt_dir` (`step_{n:08d}`) and a `latest` pointer file naming the newest.
The pointer is written after the file is complete, so a cut save leaves the
previous checkpoint current."""

from __future__ import annotations

import os
from typing import Optional

import torch


def save_checkpoint(ckpt_dir: str, step: int, payload: dict) -> str:
    """Save `payload` (tensors, numbers and dicts of them) at
    ckpt_dir/step_{step:08d} and point `latest` at it. Returns the path."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    path = os.path.join(ckpt_dir, name)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    with open(os.path.join(ckpt_dir, "latest.tmp"), "w") as fp:
        fp.write(name)
    os.replace(os.path.join(ckpt_dir, "latest.tmp"), os.path.join(ckpt_dir, "latest"))
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The path `latest` names, or None where there is none."""
    marker = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(marker):
        return None
    with open(marker) as fp:
        name = fp.read().strip()
    path = os.path.join(ckpt_dir, name)
    return path if os.path.exists(path) else None


def restore_checkpoint(path: str, device="cpu") -> dict:
    """The payload saved at `path`, its tensors on `device` (on the CPU,
    mapped from the file rather than read into memory)."""
    return torch.load(path, map_location=device, weights_only=True, mmap=torch.device(device).type == "cpu")
