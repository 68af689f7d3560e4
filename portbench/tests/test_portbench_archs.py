"""A second architecture is added as files alone: a toy latent-diffusion
model with no GridAttn (token context, a one-block UNet, a decoder to RGB)
written as portbench/archs/toy.py into a copy of the tiny root, with its
configuration, traffic, workload and BENCHMARK.json entries, and run
through the harness on the CPU as a cell of the repo's is."""

from __future__ import annotations

import json
import time

import pytest

from conftest import REPO, make_root

from portbench import cells, control, run

TOY = '''"""A toy latent-diffusion architecture: token context, a one-block UNet
with cross-attention, a plain update loop and a decoder to RGB; no
GridAttn. The program's UNet attends by F.scaled_dot_product_attention, its
float32 reference by an explicit softmax."""

import time

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench import counts, weights

OUTPUTS = dict(rgb="pred_rgb")
COUNTED = "FlopCounterMode over the toy reference on the meta device"


class Text(nn.Module):
    def __init__(self, m):
        super().__init__()
        self.tok_embedding = nn.Embedding(m["vocab"], m["width"])
        self.ln = nn.LayerNorm(m["width"])
        self.proj = nn.Linear(m["width"], m["width"])

    def forward(self, tokens):
        return self.proj(self.ln(self.tok_embedding(tokens)))


class UNet(nn.Module):
    def __init__(self, m):
        super().__init__()
        w, c = m["width"], m["latent_channels"]
        self.conv_in = nn.Conv2d(c, w, 3, padding=1)
        self.time = nn.Linear(1, w)
        self.norm = nn.GroupNorm(4, w)
        self.q, self.k, self.v, self.o = (nn.Linear(w, w) for _ in range(4))
        self.conv_out = nn.Conv2d(w, c, 3, padding=1)

    def attend(self, q, k, v):
        return torch.softmax(q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5, dim=-1) @ v

    def forward(self, x, t, ctx):
        h = self.conv_in(x) + self.time(t[:, None])[:, :, None, None]
        B, C, H, W = h.shape
        a = self.attend(self.q(self.norm(h).flatten(2).transpose(1, 2)), self.k(ctx), self.v(ctx))
        return self.conv_out(F.silu(h + self.o(a).transpose(1, 2).reshape(B, C, H, W)))


class FastUNet(UNet):
    def attend(self, q, k, v):
        return F.scaled_dot_product_attention(q, k, v)


class Decoder(nn.Module):
    def __init__(self, m):
        super().__init__()
        self.conv = nn.Conv2d(m["latent_channels"], 12, 3, padding=1)

    def forward(self, z):
        return torch.sigmoid(F.pixel_shuffle(self.conv(z), 2)).permute(0, 2, 3, 1)


class Toy(nn.Module):
    unet_class = UNet

    def __init__(self, m):
        super().__init__()
        self.text, self.unet, self.decoder = Text(m), self.unet_class(m), Decoder(m)


class ToyProgram(Toy):
    unet_class = FastUNet


def sample(model, tokens, init, step_noise, inf):
    """tokens (N, L), init (N, V, C, h, w), step_noise (N, S, V, C, h, w)."""
    N, V = init.shape[:2]
    ctx = model.text(tokens).repeat_interleave(V, 0)
    x, S = init.flatten(0, 1), inf["steps"]
    for k in range(S):
        eps = model.unet(x, torch.full((N * V,), 1.0 - k / S, device=x.device), ctx)
        x = x - eps / S + (0.1 / S if k < S - 1 else 0.0) * step_noise[:, k].flatten(0, 1)
    return x.unflatten(0, (N, V))


def build(model_cfg, state, device):
    model = ToyProgram(model_cfg).to(device)
    weights.load_program(model, state)
    return model.eval()


def reload(model, state):
    weights.load_program(model, state)
    return model


def modules(model):
    return dict(text=model.text, unet=model.unet, vae_decode=model.decoder, step=model.unet)


def views(inf):
    return inf["views"]


@torch.no_grad()
def generate(model, p, inf, timings):
    t0 = time.perf_counter()
    lat = sample(model, p["tokens"], p["init_noise"], p["step_noise"], inf)
    t1 = time.perf_counter()
    rgb = model.decoder(lat.flatten(0, 1)).unflatten(0, lat.shape[:2])
    timings.append(dict(prepare=0.0, sample=t1 - t0, decode=time.perf_counter() - t1))
    return dict(pred_rgb=rgb)


ENTRIES = dict(generate=generate)


def make_pass(model_cfg, inf, scenes, seed, index, device, purpose=weights.PASS):
    g = torch.Generator(device=device).manual_seed(weights.sub_seed(seed, purpose, index))
    N, V, S, c, ls = scenes, inf["views"], inf["steps"], model_cfg["latent_channels"], model_cfg["latent_size"]
    randn = lambda *shape: torch.randn(shape, generator=g, device=device)
    return dict(tokens=torch.randint(model_cfg["vocab"], (N, model_cfg["tokens"]), generator=g, device=device),
                init_noise=randn(N, V, c, ls, ls), step_noise=randn(N, S, V, c, ls, ls))


def reference_class(model_cfg):
    return Toy(model_cfg)


def reference_scene(ref, inf, p, n, decode_gt):
    one = slice(n, n + 1)
    lat = sample(ref, p["tokens"][one], p["init_noise"][one], p["step_noise"][one], inf)
    return dict(pred_rgb=ref.decoder(lat[0]))


def count(config):
    m, inf = config["model"], config["inference"]
    V, c, ls, L = inf["views"], m["latent_channels"], m["latent_size"], m["tokens"]
    with torch.device("meta"), torch.no_grad():
        ref = Toy(m)
        x, t, ctx = torch.zeros(V, c, ls, ls), torch.zeros(V), torch.zeros(V, L, m["width"])
        unet = dict(flops=counts.flops(lambda: ref.unet(x, t, ctx)), param_bytes=counts.BYTES * counts.params(ref.unet),
                    act_bytes=counts.BYTES * counts.numel(x, t, ctx, x))
        return dict(unet=unet, step=dict(flops=unet["flops"]),
                    text=dict(flops=counts.flops(lambda: ref.text(torch.zeros(1, L, dtype=torch.long)))),
                    decode_view=dict(flops=counts.flops(lambda: ref.decoder(torch.zeros(1, c, ls, ls)))))


def pass_flops(cell):
    c, inf = cell.config["counts"], cell.config["inference"]
    scene = c["text"]["flops"] + inf["steps"] * c["step"]["flops"] + inf["views"] * c["decode_view"]["flops"]
    return cell.traffic["scenes_per_pass"] * scene
'''

TEXT_CALLS = '''"""Calls of the toy's text tower in the traced pass (its `text` span)."""


def read(run):
    return run.trace["span_calls"].get("text") if run.trace else None
'''

TEXT_CALLS_METRIC = dict(name="text_calls", unit="calls", better="lower", source="device_trace", layer="toy text",
                         moves="views_per_s", workloads=["toy-b2"])

TOY_CONFIG = {
    "arch": "toy",
    "model": {"vocab": 64, "tokens": 8, "width": 32, "latent_channels": 4, "latent_size": 8},
    "inference": {"views": 3, "steps": 5},
}


def _files(d):
    return {p: (p.stat().st_size, p.stat().st_mtime_ns) for p in d.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    """A tiny root with the toy added as files: its arch, a configuration,
    a traffic mix, a workload, a metric of its own and BENCHMARK.json
    entries. The toy's metric is in the BENCHMARK.json that make_root
    reads, its `workloads` naming the toy's cell, as a later change adds it
    to the repo's file."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["per_layer"].append(TEXT_CALLS_METRIC)
    root = make_root(tmp_path_factory.mktemp("portbench_toy") / "root", bench)
    pb = root / "portbench"
    (pb / "archs" / "toy.py").write_text(TOY)
    (pb / "metrics" / "text_calls.py").write_text(TEXT_CALLS)
    cfg = dict(TOY_CONFIG)
    cfg["counts"] = cells.arch_of(cfg, root).count(cfg)
    (pb / "configs" / "toy.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "toy-b2.json").write_text(json.dumps(
        {"entry": "generate", "scenes_per_pass": 2, "decodes_ground_truth": False}))
    (pb / "workloads" / "toy-b2.json").write_text(json.dumps({"sample": {"scenes": 2}, "limits": {"rgb": 1e-4}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="toy", source="a test's toy", file="portbench/configs/toy.json", reduced=[],
                                 why="a second architecture added as files"))
    bench["workloads"].append(dict(name="toy-b2", config="toy", traffic="toy-b2", chips=1, why="CPU test"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("traced", [False, True])
def test_toy_arch_runs_as_files(toy_root, traced):
    before = _files(REPO / "portbench")
    cell = cells.load("toy-b2", root=toy_root)
    assert cell.arch.__file__ == str(toy_root / "portbench" / "archs" / "toy.py")
    steps = cell.config["inference"]["steps"]
    res = run.run(cell, 2**31 + 4242, 0.3, traced, "cpu", t0=time.perf_counter())
    line = run.result_line(cell, res, traced, "cpu")
    assert line["correct"] is True and line["failed"] == 0 and set(line["check"]) == {"rgb"}
    info = res["info"]
    if traced:
        assert info.trace["span_calls"]["step"] == steps
        assert info.trace["span_calls"]["unet"] == steps and info.trace["span_calls"]["text"] == 1
        assert {"decode_ms", "step_mfu"} <= set(line["metrics"])
        assert line["metrics"]["text_calls"] == {"value": 1, "unit": "calls"}
        assert not {m["name"] for m in cell.per_layer} & {"gridattn_ms", "gridattn_roofline", "host_gridattn_ms",
                                                          "gridattn_graph_share"}
    else:
        assert len(info.step_ms) == len(info.passes) * steps
        assert {"step_p95_ms", "views_per_s", "setup_s"} <= set(line["metrics"])
        assert line["metrics"]["views_per_s"]["value"] == len(info.passes) * 2 * 3 / info.window_s
    assert _files(REPO / "portbench") == before


def test_toy_perturbed_output_is_not_correct(toy_root, monkeypatch):
    cell = cells.load("toy-b2", root=toy_root)
    entry = cell.arch.ENTRIES["generate"]

    def shifted(model, p, inf, timings):
        out = entry(model, p, inf, timings)
        out["pred_rgb"][:, :1] += 0.05
        return out

    monkeypatch.setitem(cell.arch.ENTRIES, "generate", shifted)
    res = run.run(cell, 2**31 + 4243, 0.2, False, "cpu", t0=time.perf_counter())
    line = run.result_line(cell, res, False, "cpu")
    assert line["correct"] is False and line["check"]["rgb"]["value"] > 0.04


def test_toy_control_is_not_correct(toy_root):
    """The fp8 control (precision.fake_quantize_ on the toy's reference)
    fails the toy's limit; the program on the same seeds passes it."""
    cell = cells.load("toy-b2", root=toy_root)
    res = control.readings(cell, [3, 4], [3, 4], "cpu", log=lambda *a, **k: None)
    assert all(res["correct"]["program"].values()) and not any(res["correct"]["control"].values())


def test_metric_of_another_cell_passes_through_make_root(toy_root):
    """A metric whose `workloads` names a cell the tiny root does not map
    keeps that name, and the tiny cells do not report it."""
    bench = json.loads((toy_root / "BENCHMARK.json").read_text())
    assert [m for m in bench["per_layer"] if m["name"] == "text_calls"] == [TEXT_CALLS_METRIC]
    assert all(set(m["workloads"]) <= {"tiny-eval", "tiny-serve"} for m in bench["per_layer"]
               if "workloads" in m and m["name"] != "text_calls")
    for cell in ("tiny-eval", "tiny-serve"):
        assert "text_calls" not in [m["name"] for m in cells.load(cell, root=toy_root).per_layer]
    assert "gridattn_ms" not in [m["name"] for m in cells.load("toy-b2", root=toy_root).per_layer]


def test_config_without_arch_is_mvdfusion(tiny_root):
    for name in ("mvdfusion-gso15", "mvdfusion-view8"):
        assert "arch" not in json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())
    for cell in ("tiny-eval", "tiny-serve"):
        assert cells.load(cell, root=tiny_root).arch.__file__ == str(tiny_root / "portbench" / "archs" / "mvdfusion.py")
    assert cells.load("gso15-b2").arch.__file__ == str(REPO / "portbench" / "archs" / "mvdfusion.py")
