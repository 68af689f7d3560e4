"""The harness, driven past its look for a card on the tiny configuration,
with the timed path broken underneath: `correct` comes out false for each
fault an inference cell can have. (The exchange between chips has no
counterpart here: every cell runs on one card.)"""

from __future__ import annotations

import time

import pytest
import torch

from portbench import cells, run


def _unchanged_state(monkeypatch):
    import mvdfusion_tpu_torch.pipeline.sampler as sampler

    monkeypatch.setattr(sampler, "ddim_step", lambda ddim, x, eps, index, z: (x, x))


def _half_batch(monkeypatch):
    """The second half of each scene's views predicted as the mean of the first half's."""
    from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion

    orig = ViewFusion.apply_model_cfg_scenes

    def half(self, *args, **kw):
        out = orig(self, *args, **kw)  # (N, B, h, w, C)
        B = out.shape[1]
        mean = out[:, : B // 2].mean(dim=1, keepdim=True)
        return torch.cat([out[:, : B // 2], mean.expand(-1, B - B // 2, -1, -1, -1)], dim=1)

    monkeypatch.setattr(ViewFusion, "apply_model_cfg_scenes", half)


def _altered_answer(monkeypatch):
    """One view's image shifted where the decoder produces it."""
    from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion

    orig = ViewFusion.decode_latents

    def altered(self, z):
        img = orig(self, z)
        return torch.cat([torch.clamp(img[:1] + 0.05, 0.0, 1.0), img[1:]])

    monkeypatch.setattr(ViewFusion, "decode_latents", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _altered_answer])
@pytest.mark.parametrize("cell", ["tiny-eval", "tiny-serve"])
def test_fault_is_not_correct(tiny_root, monkeypatch, fault, cell):
    fault(monkeypatch)
    c = cells.load(cell, root=tiny_root)
    res = run.run(c, 5, 0.2, False, "cpu", t0=time.perf_counter())
    line = run.result_line(c, res, False, "cpu")
    assert line["correct"] is False
    assert any(v["value"] > v["limit"] for v in line["check"].values())
