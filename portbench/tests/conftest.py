"""A tiny copy of the benchmark's files for the CPU tests: the repo's
BENCHMARK.json metrics and readers, with one configuration cut to the JAX
package's test sizes (ViewFusionConfig().tiny()) in float32 and two cells
over it, one through each entry. Run with

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_MODEL = dict(latent_size=16, viewattn_hidden=32, viewattn_layers=2, viewattn_heads=4, unet_model_channels=32,
                  unet_num_res_blocks=1, unet_num_heads=4, context_dim=64, vae_ch=32, vae_ch_mult=[1, 2, 4],
                  vae_num_res_blocks=1, clip_width=64, clip_layers=2, clip_heads=2, time_embed_dim=32,
                  dtype="float32")
TINY_LIMITS = {"rgb": 1e-3, "depth": 1e-3, "vae": 1e-3}


def make_root(dst: Path) -> Path:
    """dst holds BENCHMARK.json and portbench/{configs,traffic,workloads,metrics}
    for the cells tiny-eval (eval_scenes, 2 scenes a pass) and tiny-serve
    (requests, 2 scenes a pass)."""
    from portbench import counts

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = dst / "portbench"
    for d in ("configs", "traffic", "workloads"):
        (pb / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "portbench" / "metrics", pb / "metrics", ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((REPO / "portbench" / "configs" / "mvdfusion-gso15.json").read_text())
    cfg["model"].update(TINY_MODEL)
    cfg["inference"].update(views=5, targets=[1, 2, 3, 4], image_size=64, steps=4)
    cfg["counts"] = counts.count(cfg)
    (pb / "configs" / "tiny.json").write_text(json.dumps(cfg))
    for name, src in (("eval-b2", "eval-b2"), ("serve-b2", "serve-b4")):
        t = json.loads((REPO / "portbench" / "traffic" / f"{src}.json").read_text())
        t["scenes_per_pass"] = 2
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for cell, keys in (("tiny-eval", ("rgb", "depth", "vae")), ("tiny-serve", ("rgb", "depth"))):
        limits = {k: TINY_LIMITS[k] for k in keys}
        (pb / "workloads" / f"{cell}.json").write_text(json.dumps({"sample": {"scenes": 2}, "limits": limits}))
    bench["configs"] = [dict(bench["configs"][0], name="tiny", file="portbench/configs/tiny.json")]
    bench["workloads"] = [
        dict(name="tiny-eval", config="tiny", traffic="eval-b2", chips=1, why="CPU test"),
        dict(name="tiny-serve", config="tiny", traffic="serve-b2", chips=1, why="CPU test"),
    ]
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("portbench_tiny"))
