"""The port's view parallelism with tensor parallelism (parallel/mesh.py's
sp and tp axes, nn/viewfusion.py's split target views) on the CPU at the
tiny config in fp32, ranks as OS processes over gloo
(tests/torch_port_tp_worker.py): one train_step at (dp=1, sp=2, tp=2) on 4
ranks against one rank without a mesh, on 2 scenes of 3 targets (the sp
ranks take 2 and 1 views): the loss to rtol 2e-5 (the JAX witness's
tolerance, tests/test_parallel_and_train.py::test_sp_view_parallel_train_step),
the gradient the optimizer reads to 1e-5 x max|g|, the ranks' coordinates
as the JAX mesh lays them out. The slow tier adds (dp=2, sp=2, tp=2) on 8
ranks, one scene a dp rank.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_port_tp_common import _few_threads, _one_rank, close, inputs, run_workers  # noqa: E402

from mvdfusion_tpu_torch.pipeline import trainer  # noqa: E402


def _sp_run(inputs, tmp_path_factory, dp, sp, tp):
    return run_workers(inputs, tmp_path_factory.mktemp(f"sp{dp}{sp}{tp}") / "out", dp, sp, tp)


def _held_to_one_rank(ranks, ref):
    top = max(float(g.abs().max()) for g in ref["grads"].values())
    for res in ranks:
        close(res["loss"], ref["loss"], 2e-5, "loss")
        assert res["grads"].keys() == ref["grads"].keys()
        for n, g in ref["grads"].items():
            err = float((res["grads"][n] - g).abs().max())
            assert err <= 1e-5 * top, (n, err, top)


def test_sp2_tp2_train_step_matches_one_rank(inputs, tmp_path_factory):
    ranks = _sp_run(inputs, tmp_path_factory, 1, 2, 2)
    assert [r["coords"] for r in ranks] == [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)]
    _held_to_one_rank(ranks, _one_rank(inputs["data"], trainer.TrainConfig(finetune_unet=True)))


@pytest.mark.slow
def test_dp2_sp2_tp2_train_step_matches_one_rank(inputs, tmp_path_factory):
    ranks = _sp_run(inputs, tmp_path_factory, 2, 2, 2)
    _held_to_one_rank(ranks, _one_rank(inputs["data"], trainer.TrainConfig(finetune_unet=True)))
