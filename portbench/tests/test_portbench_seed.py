"""The seed -> weights and inputs map of MVD-Fusion's tiny configuration,
pinned: digests of weights.make_state and of the architecture's make_pass
at one seed, taken before the architecture moved into
portbench/archs/mvdfusion.py. A change of draw order, sub-seed or chunking
moves them."""

from __future__ import annotations

import hashlib

import pytest
import torch

from conftest import tiny_config

from portbench import cells, weights

SEED = 2**31 + 12345
DIGESTS = {
    "state": "023907f4d0f806db25b0e15acca5ae37324b0b76954df3c98dd943b90a00e47c",
    "pass": "49aa2097997c692901bd2a430e8ea9bddfad6cad1b60906368be6fc352b7c82e",
    "warmup": "78fb4bd0521489a7ff6fec4d854ce0390d1920606c26d6cd8376403a9ffd36f3",
    "ring": "736a3018b014e2696833d3b633c80394b87f8069c1381bd03b115c7d5792b008",
}


def digest(tensors: dict) -> str:
    """sha256 over each tensor's name, shape, dtype and bytes, in order."""
    h = hashlib.sha256()
    for k, t in tensors.items():
        t = t.detach().cpu().contiguous()
        h.update(f"{k} {tuple(t.shape)} {t.dtype}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _draw(what: str) -> dict:
    cfg = tiny_config("mvdfusion-view8" if what == "ring" else "mvdfusion-gso15")
    arch, m, inf = cells.arch_of(cfg), cfg["model"], cfg["inference"]
    if what == "state":
        return weights.make_state(arch, m, SEED, "cpu")
    if what == "warmup":
        return arch.make_pass(m, inf, 2, SEED, 0, "cpu", weights.WARMUP)
    return arch.make_pass(m, inf, 2, SEED, 3 if what == "pass" else 1, "cpu")


@pytest.mark.parametrize("what", sorted(DIGESTS))
def test_seed_map_is_pinned(what):
    assert digest(_draw(what)) == DIGESTS[what]
