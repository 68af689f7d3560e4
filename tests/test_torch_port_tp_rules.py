"""The port's tensor-parallel layout (mvdfusion_tpu_torch/parallel/mesh.py::
param_spec) against the JAX package's Megatron rules (parallel/mesh.py::
_spec_for), no processes and no weights.

Every parameter of ViewFusionConfig().tiny() and of the default config (the
model built on the meta device) is mapped to its flax path(s) and layout
through convert/from_jax.py's table; _spec_for on that path and the flax
shape, moved into torch's layout, must give the port's cut at tp = 2 and 4.
The one named exception: the weights of the grafted ViewAligned sites that
take a site kernel (C <= 768), which the kernels read whole and the JAX
rule's _FUSED_SITE pattern misses (`up_{0,1}_view_attn_{0,1,2}` at the
default config: 60 weights).
"""

import re

import numpy as np
import pytest

from mvdfusion_tpu.parallel.mesh import _spec_for
from mvdfusion_tpu_torch.convert.from_jax import viewfusion_table
from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig
from mvdfusion_tpu_torch.parallel.mesh import Spec, param_layout, param_spec

_TO_FLAX_SHAPE = {
    "none": lambda s: [s],
    "linear": lambda s: [s[::-1]],
    "conv": lambda s: [(s[2], s[3], s[1], s[0])],
    "conv1x1": lambda s: [(s[1], s[0])],
    "qkv": lambda s: [(s[1], s[0] // 3)] * 3,
    "qkvb": lambda s: [(s[0] // 3,)] * 3,
}
# a flax dim -> the torch dim of the same axis, by layout kind
_TORCH_DIM = {
    "none": lambda d: d,
    "linear": lambda d: 1 - d,
    "conv1x1": lambda d: 1 - d,
    "qkv": lambda d: 1 - d,
    "conv": lambda d: {3: 0, 2: 1, 0: 2, 1: 3}[d],
}
_VIEW_SITE = re.compile(r"\.aligned_attn_transformer_blocks\.")


def _jax_spec(paths, kind, tshape, tp):
    """The torch dim the JAX rule cuts (None: whole), the same for every flax
    path the key packs."""
    dims = set()
    for path, fshape in zip(paths, _TO_FLAX_SHAPE[kind](tshape)):
        spec = tuple(_spec_for("params/" + "/".join(path), fshape, tp))
        cut = [d for d, a in enumerate(spec) if a == "tp"]
        dims.add(_TORCH_DIM[kind](cut[0]) if cut else None)
    assert len(dims) == 1, (paths, dims)
    return dims.pop()


def _fused_view_site(name, shape):
    width = shape[1] if name.endswith("ff.net.0.proj.weight") else shape[0]
    return bool(_VIEW_SITE.search(name)) and len(shape) == 2 and width <= 768


@pytest.fixture(scope="module", params=["tiny", "default"])
def model(request):
    cfg = ViewFusionConfig()
    return ViewFusion(cfg.tiny() if request.param == "tiny" else cfg, device="meta")


@pytest.mark.parametrize("tp", [2, 4])
def test_param_spec_matches_jax_spec_for(model, tp):
    table = viewfusion_table(model.cfg)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert set(table) == set(shapes)
    layout = param_layout(model, tp)
    exceptions, split = [], 0
    for name, (paths, kind) in table.items():
        ours = layout[name]
        ref = _jax_spec(paths, kind, shapes[name], tp)
        if ours is None and ref is not None and _fused_view_site(name, shapes[name]):
            exceptions.append(name)
            continue
        assert (None if ours is None else ours.dim) == ref, (name, shapes[name], ours, ref)
        split += ours is not None
        if ours is not None:
            assert ours.parts == (3 if kind == "qkv" else 2 if name.endswith("ff.net.0.proj.weight") else 1), name
    if model.cfg.unet_model_channels == 320:
        # the six ViewAligned sites at C = 320 and 640, ten 2-D weights each
        assert len(exceptions) == 60, len(exceptions)
        assert {re.search(r"output_blocks\.(\d+)\.2", n).group(1) for n in exceptions} == {"6", "7", "8", "9", "10",
                                                                                       "11"}
    assert split > 0


def test_default_config_split_counts_at_tp2():
    """The default config at tp = 2, by subtree and kind: the UNet's column
    (123), row (49) and conv (51) cuts, CLIP's (96, 49, 1), the VAE's 57
    convs, and GridAttn whole; then the port's departure, 60 ViewAligned
    weights whole."""
    m = ViewFusion(ViewFusionConfig(), device="meta")
    table = viewfusion_table(m.cfg)
    count = {}
    for name, p in m.named_parameters():
        paths, kind = table[name]
        ref = _jax_spec(paths, kind, tuple(p.shape), 2)
        if ref is None:
            continue
        top = name.split(".")[0]
        what = "conv" if p.ndim == 4 and p.shape[2] > 1 else ("column" if ref == 0 else "row")
        if top == "clip_image_encoder" and name.endswith("visual.proj"):
            what = "row"
        count[(top, what)] = count.get((top, what), 0) + len(paths)
    assert count == {("unet_model", "column"): 123, ("unet_model", "row"): 49, ("unet_model", "conv"): 51,
                     ("clip_image_encoder", "column"): 96, ("clip_image_encoder", "row"): 49,
                     ("clip_image_encoder", "conv"): 1, ("vae", "conv"): 57, ("time_embed", "column"): 1,
                     ("time_embed", "row"): 1}, count


@pytest.mark.parametrize("name,shape,tp,want", [
    ("unet_model.unet_model.input_blocks.7.1.transformer_blocks.0.attn1.to_q.weight", (1280, 1280), 2, Spec(0, 1)),
    ("unet_model.unet_model.input_blocks.7.1.transformer_blocks.0.attn2.to_k.weight", (1280, 768), 2, None),
    ("unet_model.unet_model.middle_block.2.aligned_attn_transformer_blocks.0.attn2.to_k.weight", (1280, 768), 2,
     Spec(0, 1)),
    ("unet_model.unet_model.output_blocks.9.2.aligned_attn_transformer_blocks.0.attn1.to_q.weight", (320, 320), 2,
     None),
    ("unet_model.unet_model.input_blocks.7.1.transformer_blocks.0.ff.net.0.proj.weight", (10240, 1280), 4,
     Spec(0, 2)),
    ("unet_model.unet_model.input_blocks.7.1.transformer_blocks.0.ff.net.2.weight", (1280, 5120), 4, Spec(1, 1)),
    ("unet_model.unet_model.out.2.weight", (5, 320, 3, 3), 2, None),
    ("vae.encoder.conv_out.weight", (8, 512, 3, 3), 2, Spec(0, 1)),
    ("vae.encoder.conv_out.weight", (8, 512, 3, 3), 4, None),  # fewer than 4 x tp outputs
    ("vae.encoder.mid.attn_1.q.weight", (512, 512, 1, 1), 2, None),
    ("clip_image_encoder.model.visual.proj", (1024, 768), 2, Spec(0, 1)),
    ("view_attn.aggregation_transformer.layer_list.0.attn.qkv.weight", (768, 256), 2, None),
    ("time_embed.0.weight", (256, 256), 2, Spec(0, 1)),
    ("time_embed.2.weight", (256, 256), 2, Spec(1, 1)),
    ("cc_projection.0.weight", (768, 796), 2, None),
])
def test_param_spec_cases(name, shape, tp, want):
    assert param_spec(name, shape, tp) == want
    assert param_spec(name, shape, 1) is None
    assert np.prod(shape) > 0
