"""The frozen counts against hand sums at the tiny configuration's shapes,
and the stored counts against a fresh count."""

from __future__ import annotations

import json

import pytest

from conftest import REPO

from portbench import cells, counts, yardstick


def gridattn_hand(m, B, ls):
    """GridAttn's products, by hand: the z embedder, the camera products,
    the token projection, the DiT over views, the pooling weight and the
    final projection (a multiply-add is 2)."""
    hid, D, out, r = m["viewattn_hidden"], m["n_pts_per_ray"], m["context_dim"], m["viewattn_mlp_ratio"]
    HW = ls * ls
    N = B * HW * D  # query points; every view sees all of them
    T = B * N  # tokens: (point, view)
    f = 2 * (B + 1) * HW * 5 * hid  # z_embedder on the targets and the input
    f += 2 * (2 * B * HW * 9)  # pixel_rays' two unprojections
    f += 2 * B * N * 9 + 2 * N * 9  # the points into every target and into the input
    f += 2 * B * 9  # camera centres
    f += 2 * T * (2 * hid + 211) * hid  # pre_layer_b
    per = 2 * hid * 6 * hid + 2 * T * hid * 3 * hid + 4 * N * B * B * hid + 2 * T * hid * hid + 4 * T * hid * int(r * hid)
    f += m["viewattn_layers"] * per
    f += 2 * T * hid  # weight_layer
    f += 2 * N * hid * out  # final_layer_b
    return f


def test_gridattn_by_hand(tiny_root):
    cell = cells.load("tiny-eval", root=tiny_root)
    m, inf = cell.config["model"], cell.config["inference"]
    assert counts.count(cell.config)["gridattn"]["flops"] == gridattn_hand(m, len(inf["targets"]), m["latent_size"])


def test_decode_params_and_pass(tiny_root):
    cell = cells.load("tiny-eval", root=tiny_root)
    c, inf = cell.config["counts"], cell.config["inference"]
    ch = cell.config["model"]["vae_ch"]
    # the decoder's first product: a 3x3 conv of 4 -> 4 ch_mult[-1] channels at the latent size
    assert c["decode_view"]["flops"] > 2 * 16 * 16 * 4 * (4 * ch) * 9
    B, S = len(inf["targets"]), inf["steps"]
    scene = (1 + B) * c["encode_image"]["flops"] + c["clip_image"]["flops"] + S * c["step"]["flops"] \
        + 2 * B * c["decode_view"]["flops"]
    assert yardstick.pass_flops(cell) == 2 * scene
    # bytes: parameters once a call, activations a scene
    u = c["unet"]
    assert yardstick.call_bound_s(cell, "unet", 3) == max(3 * u["flops"] / yardstick.PEAK_BF16_FLOPS,
                                                         (u["param_bytes"] + 3 * u["act_bytes"]) / yardstick.PEAK_BYTES)


@pytest.mark.parametrize("config", ["mvdfusion-gso15", "mvdfusion-view8"])
def test_stored_counts_are_fresh(config):
    cfg = json.loads((REPO / "portbench" / "configs" / f"{config}.json").read_text())
    assert cfg["counts"] == counts.count(cfg)
    assert cfg["counted"] == counts.HOW
