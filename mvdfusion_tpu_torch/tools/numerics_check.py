"""The whole model's kernels against their plain versions on the card
(counterpart of mvdfusion_tpu/tools/tpu_numerics_check.py).

One apply_model_cfg at full width (bf16 towers, random weights from a seed,
no zero-inits, so no path is vacuous), 8 target views at t = 500 and CFG
2.5 on fixed inputs, twice: with the kernels, and under the kernel-off
switch (every route on its plain version: the UNet sites and GridAttn on
their module paths, GroupNorm and attention plain). Reports max|diff| and
mean|diff| of the CFG noise prediction against the reference tool's bound,
TOLERANCE x max(1, max|plain|): bf16 towers differ by their roundings, not
by 1e-5.

    python -m mvdfusion_tpu_torch.tools.numerics_check [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np

TOLERANCE = 0.05  # the reference tool's bound, x max(1, max|plain|)


def compare(model, seed: int = 0, B: int = 8) -> dict:
    """apply_model_cfg of `model` on seeded inputs with the kernels and under
    the switch. Returns max_diff, mean_diff, scale (max|plain|), bound, ok,
    both outputs' finiteness and plain_launches, the kernel launches counted
    under the switch (none, where every route takes its plain version)."""
    import torch

    from mvdfusion_tpu_torch.geometry.cameras import Cameras, look_at_view_transform
    from mvdfusion_tpu_torch.ops import _lib

    dev = next(model.parameters()).device
    cfg = model.cfg
    H, D = cfg.latent_size, cfg.n_pts_per_ray
    rng = np.random.default_rng(seed)
    R, T = look_at_view_transform(dist=1.5, elev=20.0, azim=np.linspace(0, 360, B + 1, endpoint=False) + 90)
    cams = lambda s: Cameras(torch.tensor(R[s], device=dev), torch.tensor(T[s], device=dev),
                             torch.full((len(R[s]), 2), 2.1875, device=dev), torch.zeros(len(R[s]), 2, device=dev))
    r = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32), device=dev)
    args = (r(B, H, H, 5), cams(slice(1, None)), r(1, H, H, 5), cams(slice(0, 1)), r(B, 1, cfg.context_dim + 28),
            torch.full((B,), 500, device=dev), 2.5, r(B, H, H, D))
    with torch.no_grad():
        fused = model.apply_model_cfg(*args).float()
        before = sum(_lib.counted().values())
        with _lib.plain_versions():
            plain = model.apply_model_cfg(*args).float()
        plain_launches = sum(_lib.counted().values()) - before
    err = (fused - plain).abs()
    scale = plain.abs().max().item()
    bound = TOLERANCE * max(1.0, scale)
    finite = bool(torch.isfinite(fused).all() and torch.isfinite(plain).all())
    return dict(max_diff=err.max().item(), mean_diff=err.mean().item(), scale=scale, bound=bound,
                finite=finite, ok=finite and err.max().item() <= bound, plain_launches=plain_launches)


def main(argv=None) -> int:
    import torch

    from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    model = randomize_(ViewFusion(ViewFusionConfig(), device=dev), seed=0).cast_for_inference().eval()
    res = compare(model)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"apply_model_cfg kernels vs plain versions on {kind}: max|diff| {res['max_diff']:.5f}, mean|diff| "
          f"{res['mean_diff']:.6f}, max|plain| {res['scale']:.3f}, bound {res['bound']:.4f} -> "
          f"{'OK' if res['ok'] else 'MISS'}")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
