"""The two precisions the comparison computes a reference in, for every
architecture: true float32 (`float32_products`) and the fp8 control
(`fake_quantize_`).

The control rounds every nn.Linear and nn.Conv2d itself. A product of an
architecture's reference that is neither (a packed in-projection, a bare
parameter matrix) is rounded by a `fake_quantize_()` method of its own
module, which `fake_quantize_` calls: the reference names its own packed
products, and nothing here knows one architecture's modules.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn


@contextlib.contextmanager
def float32_products():
    """Products in true float32 inside the block: no TF32 in matmuls or
    cuDNN convolutions (the program's own settings are restored after)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8(x):
    """Round to float8 e4m3 under a per-tensor scale that maps max|x| to 448."""
    s = 448.0 / x.abs().amax().clamp(min=1e-12)
    return (x * s).to(torch.float8_e4m3fn).to(x.dtype) / s


def fp8_input(_mod, args):
    """A forward pre-hook that rounds a module's first input to float8."""
    return (fp8(args[0]), *args[1:])


def fake_quantize_(model: nn.Module) -> nn.Module:
    """Every Linear and Conv2d computes on fp8-rounded weights and inputs,
    and every module with a `fake_quantize_()` method rounds its own
    products; the rest stays in float32."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                mod.weight.copy_(fp8(mod.weight))
                mod.register_forward_pre_hook(fp8_input)
            elif callable(getattr(mod, "fake_quantize_", None)):
                mod.fake_quantize_()
    return model
