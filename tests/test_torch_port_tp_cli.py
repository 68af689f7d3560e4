"""The train CLI's --tp and chip_smoke.py's tp phase on the CPU at the tiny
config:

(a) cli.train --tp 2 for 2 steps (two ranks by parallel.spawn), then a
    resume at tp = 1 for a third: the tp = 2 checkpoint holds whole
    tensors and restores at tp = 1 bit for bit, and the third step ends
    where 3 unbroken tp = 1 steps end, within the gap the gradients
    explain through AdamW's first step.
(b) A CPU rehearsal of chip_smoke.py's tp phase (the request at tp = 2, a
    train step at tp = 2 and at sp = 2, each against rank 0 alone), and its
    dp_step serving several steps on one model: in bf16 (init_train_state
    casts the parameters to their compute dtypes) each step starts from
    the same weights and masters, so repeated steps are bit-equal.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mvdfusion_tpu_torch.core.checkpoint import restore_checkpoint
from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_
from mvdfusion_tpu_torch.pipeline import trainer

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_parallel import _train_config, _write_gso  # noqa: E402
from torch_port_tp_common import REPO, _few_threads, adam_gap  # noqa: E402


# ------------------------------------------------------------------- (d)
def test_train_cli_tp2_checkpoint_resumes_at_tp1(tmp_path):
    gso = tmp_path / "gso"
    _write_gso(gso, 3)
    train = [sys.executable, "-m", "mvdfusion_tpu_torch.cli.train", "--tiny", "--device", "cpu", "--seed", "3"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="4")
    a, b = tmp_path / "a", tmp_path / "b"
    cfg_a, cfg_b = _train_config(tmp_path, gso, a), _train_config(tmp_path, gso, b)
    run = lambda *args: subprocess.run([*train, *args], cwd=REPO, check=True, timeout=600, capture_output=True,
                                       text=True, env=env).stdout
    out = run("-c", cfg_b, "--tp", "2", "--max-steps", "2")
    assert "mesh dp 1 x sp 1 x tp 2" in out, out
    run("-c", cfg_b, "--max-steps", "1")  # resumes at tp = 1
    run("-c", cfg_a, "--max-steps", "3")  # unbroken at tp = 1
    ck = restore_checkpoint(b / "ckpt" / "step_00000002")
    # the tp = 2 checkpoint holds whole tensors, and restores at tp = 1 bit for bit
    model = randomize_(ViewFusion(ViewFusionConfig().tiny(), device="cpu"), seed=11)
    tc = trainer.TrainConfig(finetune_unet=True, grad_accum_step=2)
    state = trainer.init_train_state(model, tc)
    trainer.restore_state(model, state, ck)
    back = trainer.state_payload(state, 0)
    for n, t in ck["params"].items():
        assert torch.equal(back["params"][n], t.to(back["params"][n].dtype)), n
    ra, rb = restore_checkpoint(a / "ckpt" / "step_00000003"), restore_checkpoint(b / "ckpt" / "step_00000003")
    assert ra["step"] == rb["step"] == 3 and ra["opt_state"]["count"] == rb["opt_state"]["count"] == 1
    mu_a, mu_b = ra["opt_state"]["mu"], rb["opt_state"]["mu"]
    top = max(float(t.abs().max()) for t in mu_a.values())
    lr = trainer.TrainConfig().lr
    for n, m in mu_a.items():
        assert float((mu_b[n] - m).abs().max()) <= 1e-5 * top, n
        g = lambda mu: mu / (1 - trainer._B1)  # AdamW's first moment after one update
        assert adam_gap(rb["params"][n], ra["params"][n], g(mu_b[n]), g(m), lr) <= 1, n


# ------------------------------------------------------------------- (e)
def test_chip_smoke_tp_rehearsal_on_cpu():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke  # by name: parallel.spawn pickles its rank function by reference

    res = chip_smoke.run_tp("cpu", device="cpu", tiny=True)
    assert res["backend"] == "gloo" and res["world"] == 2 and all(res["ranks_agree"])
    assert res["tp"]["copies_are_masters"] and res["sp"]["copies_are_masters"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chip_smoke_dp_step_repeats_on_one_model(dtype):
    import dataclasses

    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke
    from mvdfusion_tpu_torch.core.config import build_model_config, load_yaml

    mcfg = dataclasses.replace(build_model_config(load_yaml(str(chip_smoke.TRAIN_CONFIG))).tiny(), dtype=dtype)
    dev = torch.device("cpu")
    model = ViewFusion(mcfg, device=dev)
    first = chip_smoke.dp_step(dev, model, range(1), reduce=False)
    again = chip_smoke.dp_step(dev, model, range(1), reduce=False)
    assert first["loss"] == again["loss"] and first["prints"] == again["prints"]
