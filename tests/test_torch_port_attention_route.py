"""K2's route (ops/attention.py::attention_route): which kernel a call takes,
decided from the operands' dtype, head dim, rounding form, scale, query and
key counts and alignment alone.

No card here: `OnCard` reports a CPU tensor's shape, dtype, strides and
pointer as a tensor on the card, which is all the route reads. The kernels
themselves are held against attention_plain on the card by
tests/test_torch_port_gpu.py.
"""

import pytest
import torch

from mvdfusion_tpu_torch.ops import _lib
from mvdfusion_tpu_torch.ops import attention as K2

BF, F32 = torch.bfloat16, torch.float32
SCALE = 64**-0.5  # dh^-0.5 at dh 64: 1/8, a power of two


class OnCard:
    """A CPU tensor as attention_route sees a CUDA one (`offset` bytes added
    to its pointer)."""

    def __init__(self, t, offset=0):
        self.t, self.offset = t, offset
        self.shape, self.dtype, self.device = t.shape, t.dtype, torch.device("cuda")

    def stride(self, dim=None):
        return self.t.stride() if dim is None else self.t.stride(dim)

    def data_ptr(self):
        return self.t.data_ptr() + self.offset


def separate(B, Nq, Nk, H, dh, dt=BF):
    return OnCard(torch.empty(B, Nq, H, dh, dtype=dt)), *(OnCard(torch.empty(B, Nk, H, dh, dtype=dt)) for _ in "kv")


def packed(B, N, H, dh, dt=BF):
    """q/k/v as strided views of one (B, N, 3, H, dh) buffer, as K3 passes them."""
    qkv = torch.empty(B, N, 3, H, dh, dtype=dt)
    return tuple(OnCard(qkv[:, :, i]) for i in range(3))


MVDREAM_SHAPES = [(16, 4096, 5, 64), (16, 1024, 10, 64), (16, 256, 20, 64)]  # attn1 over 4 views joined


@pytest.mark.parametrize("layout", ["separate", "packed"])
@pytest.mark.parametrize("shape", MVDREAM_SHAPES, ids=lambda s: f"{s[1]}keys")
def test_mvdream_joined_attention_takes_sm90(shape, layout):
    B, N, H, dh = shape
    q, k, v = separate(B, N, N, H, dh) if layout == "separate" else packed(B, N, H, dh)
    assert K2.attention_mode(dh) == K2.MODE_PV
    assert K2.attention_route(q, k, v, dh**-0.5) == "sm90"
    assert K2.attention_route(q, k, v, dh**-0.5, K2.MODE_PV) == "sm90"


MMA_CASES = {
    "CLIP ViT-L/14, 257 ragged keys": (lambda: packed(1, 257, 16, 64), None),
    "K3's 32^2 sites, dh 40": (lambda: packed(16, 1024, 8, 40), K2.MODE_PROBS),
    "K3's 16^2 sites, dh 80": (lambda: packed(16, 256, 8, 80), K2.MODE_PROBS),
    "dh 40 in the pv form": (lambda: separate(2, 1024, 1024, 8, 40), K2.MODE_PV),
    "the probs form at dh 64": (lambda: separate(2, 1024, 1024, 10, 64), K2.MODE_PROBS),
    "Nk not a multiple of the tile": (lambda: separate(2, 1024, 1000, 10, 64), None),
    "Nq not a multiple of the tile": (lambda: separate(2, 1000, 1024, 10, 64), None),
    "one key tile": (lambda: separate(2, 1024, 128, 10, 64), None),
    "dh 128": (lambda: separate(2, 1024, 1024, 4, 128), K2.MODE_PV),
}
MMA_SCALES = [0.1, 0.3, 0.125 * 1.5, -0.125, 0.0]  # not a positive power of two


@pytest.mark.parametrize("scale", MMA_SCALES, ids=str)
def test_scales_off_powers_of_two_take_the_mma_tile(scale):
    """The sm90 tile scales Q in bf16 before the product, which is exact only
    for a power of two; another scale keeps attention.cu's rounding."""
    q, k, v = separate(2, 1024, 1024, 10, 64)
    assert K2.attention_route(q, k, v, SCALE) == "sm90"
    assert K2.attention_route(q, k, v, scale) == "mma"


@pytest.mark.parametrize("what", list(MMA_CASES))
def test_other_bf16_calls_take_the_mma_tile(what):
    make, mode = MMA_CASES[what]
    q, k, v = make()
    assert K2.attention_route(q, k, v, q.shape[-1] ** -0.5, mode) == "mma"


def test_operands_off_tma_rules_take_the_mma_tile():
    """A base pointer 8 bytes off 16, a row stride of 644 elements (10 heads
    of 64 and 4 more: not a multiple of 8), and operands on the CPU."""
    q, k, v = separate(2, 1024, 1024, 10, 64)
    assert K2.attention_route(q, k, v, SCALE) == "sm90"
    assert K2.attention_route(q, OnCard(k.t, offset=8), v, SCALE) == "mma"
    rows = torch.empty(2, 1024, 644, dtype=BF)[..., :640].unflatten(-1, (10, 64))
    assert K2.attention_route(q, k, OnCard(rows), SCALE) == "mma"
    assert K2.attention_route(q.t, k.t, v.t, SCALE) == "mma"


@pytest.mark.parametrize("shape", [(16, 4096, 5, 64), (2, 1024, 1, 512), (1, 257, 16, 64)], ids=str)
def test_fp32_operands_and_large_heads_take_the_fp32_loop(shape):
    B, N, H, dh = shape
    assert K2.attention_route(*separate(B, N, N, H, dh, F32), dh**-0.5) == "fp32"
    if dh > 128:
        assert K2.attention_route(*separate(B, N, N, H, dh, BF), dh**-0.5) == "fp32"


@pytest.mark.parametrize("shape", [(1, 256, 2, 64), (2, 384, 1, 64)], ids=str)
def test_cpu_calls_keep_the_plain_path(shape):
    """On the CPU a shape the card sends to sm90 runs attention_plain, bit
    for bit, and counts no launch."""
    g = torch.Generator().manual_seed(shape[1])
    q, k, v = (torch.randn(shape, generator=g).to(BF) for _ in range(3))
    before = _lib.counted()
    out = K2.fused_attention(q, k, v, 64**-0.5)
    assert torch.equal(out, K2.attention_plain(q, k, v, 64**-0.5, K2.MODE_PV))
    assert _lib.counted() == before
