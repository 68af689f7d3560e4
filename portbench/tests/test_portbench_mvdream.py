"""MVDream's architecture file (portbench/archs/mvdream.py) on the CPU: its
stored counts against a fresh count, its traffic's prompts, and one cell
of it at the tiny sizes (nn/mvdream.py's MVDreamConfig().tiny() in float32)
added to a copy of the tiny root as files, run through the harness untraced
and traced, with the fp8 control failing where the program passes."""

from __future__ import annotations

import json
import time

import pytest
import torch

from conftest import REPO, make_root

from portbench import cells, control, run

CONFIG = "mvdream-sd21-4view"
TINY_MODEL = dict(image_size=8, model_channels=32, channel_mult=[1, 2, 2], num_res_blocks=1, num_head_channels=8,
                  context_dim=64, vae_ch=32, vae_ch_mult=[1, 2], vae_num_res_blocks=1, text_vocab_size=1000,
                  text_width=64, text_layers=3, text_heads=2, dtype="float32")
# the port on its plain route in float32 reads ~1e-6 of these here; the
# control ~1e-1 and above (test_tiny_control_is_not_correct)
TINY_LIMITS = {"rgb": 1e-3, "latent": 1e-3}
SITES = 10  # the tiny UNet's joined self-attentions: 3 input, 1 middle, 6 output
MVATTN = ("mvattn_ms", "mvattn_roofline", "host_mvattn_ms")


def _config() -> dict:
    return json.loads((REPO / "portbench" / "configs" / f"{CONFIG}.json").read_text())


def test_stored_counts_are_fresh():
    cfg = _config()
    arch = cells.arch_of(cfg)
    assert cfg["counts"] == arch.count(cfg)
    assert cfg["counted"] == arch.COUNTED
    # one request-step of the UNet at the published sizes: ~1.63 TFLOP, the joined attention ~21% of it
    assert 1.6e12 < cfg["counts"]["unet"]["flops"] < 1.7e12
    assert 0.15 < cfg["counts"]["mvattn"]["flops"] / cfg["counts"]["unet"]["flops"] < 0.3


def test_prompts_of_a_pass():
    """BOS, 8-40 ids below BOS, EOS, zeros; the empty prompt BOS, EOS; the
    same seed gives the same pass, another seed another."""
    cfg = _config()
    arch, m, inf = cells.arch_of(cfg), cfg["model"], cfg["inference"]
    p = arch.make_pass(m, inf, 8, 2**31 + 99, 0, "cpu")
    bos, eos = 49406, 49407
    assert p["tokens"].shape == (8, 77) and p["init_noise"].shape == (8, 4, 32, 32, 4)
    for row in p["tokens"].tolist():
        end = row.index(eos)
        assert row[0] == bos and 9 <= end <= 41 and all(0 <= i < bos for i in row[1:end])
        assert all(i == 0 for i in row[end + 1:])
    assert p["null_tokens"][0, :2].tolist() == [bos, eos] and not p["null_tokens"][0, 2:].any()
    assert ((0 <= p["azimuth"]) & (p["azimuth"] < 360)).all() and len(set(p["azimuth"])) == 8
    q = arch.make_pass(m, inf, 8, 2**31 + 99, 0, "cpu")
    assert torch.equal(q["tokens"], p["tokens"]) and torch.equal(q["init_noise"], p["init_noise"])
    assert not torch.equal(arch.make_pass(m, inf, 8, 2**31 + 100, 0, "cpu")["tokens"], p["tokens"])


@pytest.fixture(scope="module")
def mv_root(tmp_path_factory):
    """The tiny root with a tiny MVDream cell, tiny-mvdream, added as files:
    its configuration, traffic and workload, BENCHMARK.json's entries, and
    the mvattn metrics listing it in mvdream4-b8's place."""
    root = make_root(tmp_path_factory.mktemp("portbench_mvdream") / "root")
    pb = root / "portbench"
    cfg = _config()
    cfg["model"].update(TINY_MODEL)
    cfg["inference"].update(image_size=64, steps=4, prompt_tokens=[3, 20])
    cfg["counts"] = cells.arch_of(cfg, root).count(cfg)
    (pb / "configs" / "tiny-mvdream.json").write_text(json.dumps(cfg))
    t = json.loads((REPO / "portbench" / "traffic" / "t2mv-b8.json").read_text())
    (pb / "traffic" / "t2mv-b2.json").write_text(json.dumps(dict(t, scenes_per_pass=2)))
    (pb / "workloads" / "tiny-mvdream.json").write_text(json.dumps({"sample": {"scenes": 2}, "limits": TINY_LIMITS}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="tiny-mvdream", source=cfg["source"], file="portbench/configs/tiny-mvdream.json",
                                 reduced=[], why="CPU test"))
    bench["workloads"].append(dict(name="tiny-mvdream", config="tiny-mvdream", traffic="t2mv-b2", chips=1,
                                   why="CPU test"))
    for metric in bench["per_layer"]:
        if metric["name"] in MVATTN:
            metric["workloads"] = ["tiny-mvdream"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_serves(mv_root, traced):
    cell = cells.load("tiny-mvdream", root=mv_root)
    assert cell.arch.__file__ == str(mv_root / "portbench" / "archs" / "mvdream.py")
    steps = cell.config["inference"]["steps"]
    res = run.run(cell, 2**31 + 2525, 0.3, traced, "cpu", t0=time.perf_counter())
    line = run.result_line(cell, res, traced, "cpu")
    assert line["correct"] is True and line["failed"] == 0 and set(line["check"]) == {"rgb", "latent"}
    info = res["info"]
    if traced:
        calls = info.trace["span_calls"]
        assert calls["step"] == calls["unet"] == steps and calls["text"] == 1 and calls["vae_decode"] == 2
        assert {calls[f"mvattn.{i}"] for i in range(SITES)} == {steps} and f"mvattn.{SITES}" not in calls
        # on the CPU the trace holds no device operation: the device readers find nothing
        assert {"prepare_ms", "decode_ms", "step_mfu", "host_step_ms", "host_unet_ms", "host_mvattn_ms"} <= \
            set(line["metrics"])
        assert not {"mvattn_ms", "mvattn_roofline", "gridattn_ms", "host_gridattn_ms"} & set(line["metrics"])
        assert 0 < line["metrics"]["host_mvattn_ms"]["value"] < line["metrics"]["host_unet_ms"]["value"]
    else:
        assert len(info.step_ms) == len(info.passes) * steps
        assert line["metrics"]["views_per_s"]["value"] == len(info.passes) * 2 * 4 / info.window_s


def test_tiny_control_is_not_correct(mv_root):
    """The port in float32 on its plain route sits within float32 rounding
    of the reference; the control (the reference in float8) misses every
    limit."""
    cell = cells.load("tiny-mvdream", root=mv_root)
    res = control.readings(cell, [3, 4], [3, 4], "cpu", log=lambda *a, **k: None)
    assert all(res["correct"]["program"].values()) and not any(res["correct"]["control"].values())
    for nums in res["program"].values():
        assert all(v < TINY_LIMITS[k] / 10 for k, v in nums.items()), nums
    for nums in res["control"].values():
        assert all(v > 10 * TINY_LIMITS[k] for k, v in nums.items()), nums


def test_host_mvattn_ms_is_none_without_joined_spans(tiny_root):
    """An MVD-Fusion run records no model.mvattn span: the reader gives
    None there (as on a program without the span)."""
    cell = cells.load("tiny-serve", root=tiny_root)
    res = run.run(cell, 2**31 + 2526, 0.2, False, "cpu", t0=time.perf_counter())
    assert cells.reader(cell, "host_mvattn_ms")(res["info"]) is None
