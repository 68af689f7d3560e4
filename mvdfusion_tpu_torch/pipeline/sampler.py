"""eta-DDIM sampling loop (torch counterpart of mvdfusion_tpu/pipeline/sampler.py).

A Python loop over the DDIM steps; each step is one `apply_model_cfg` and one
`ddim_step`, shared timestep across views, at any eta (1, the default, is
the reference's sampler) on uniform or quad timesteps, the carry clamped to
[-x_clip, x_clip] after each update where `x_clip` is given. With
`feed_prev_depth`, each step's pred_x0 depth channel replaces the next
step's GridAttn depth estimate; step 0, which has none yet, takes the unbiased estimate
x_t[depth] / sqrt(abar_t) as the reference does. All randomness is drawn up front
from an explicit torch.Generator, or passed in (`init_noise`, `step_noise`,
`jitter_noise`) so a test can feed the JAX sampler and this one the same
noise stream. `ddim_sample_scenes` runs N scenes in one pass (one UNet call
a step over their CFG batch), the counterpart of the JAX package's vmap
over scenes; `ddim_sample` is its one-scene case. `ddim_sample_views` runs
MVDream (nn/mvdream.py): N text requests of F views, one CFG UNet call a
step, no GridAttn. Both go through one loop (`_ddim_loop`), whose pass and
steps are spans of utils/trace.py (`sample.pass`, `sample.step`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from mvdfusion_tpu_torch.core.schedule import DDIMSchedule, ddim_step, make_ddim_schedule
from mvdfusion_tpu_torch.geometry.cameras import Cameras
from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion
from mvdfusion_tpu_torch.utils.trace import span


class SampleResult(NamedTuple):
    latents: torch.Tensor  # (B, H, W, C)
    pred_x0_trajectory: Optional[torch.Tensor]  # (S, B, H, W, C) if requested


def _ddim_loop(x, ddim: DDIMSchedule, num_steps: int, predict: Callable, step_noise, dev,
               x_clip: Optional[float] = None, after: Optional[Callable] = None):
    """The DDIM steps of a pass, each a `sample.step` span: loop step i runs
    index S-1-i, eps = predict(i, index, x), one ddim_step with
    step_noise[i] (None: no noise, for eta 0), the clamp where `x_clip` is
    given, then after(i, pred_x0). Returns the final x."""
    for i in range(num_steps):
        with span("sample.step", step=i, device=dev):
            index = num_steps - 1 - i
            x, pred_x0 = ddim_step(ddim, x, predict(i, index, x), index, None if step_noise is None else step_noise[i])
            if x_clip is not None:
                x = torch.clamp(x, -x_clip, x_clip)
            if after is not None:
                after(i, pred_x0)
    return x


@torch.no_grad()
def ddim_sample(
    model: ViewFusion,
    batch_cameras: Cameras,
    input_latents: torch.Tensor,  # (1, h, w, 5)
    input_cameras: Cameras,
    clip_v_embed: torch.Tensor,  # (B, 1, ctx + 28), ctx + 4 on the legacy pose path
    cfg_scale: float,
    num_steps: int = 50,
    eta: float = 1.0,
    feed_prev_depth: bool = False,
    return_trajectory: bool = False,
    init_noise: Optional[torch.Tensor] = None,  # (B, H, W, C)
    step_noise: Optional[torch.Tensor] = None,  # (S, B, H, W, C)
    jitter_noise: Optional[torch.Tensor] = None,  # (S, B, H, W, D)
    generator: Optional[torch.Generator] = None,
    x_clip: Optional[float] = None,
    method: str = "uniform",
) -> SampleResult:
    """Generate B views of 5-channel (RGB-D) latents with eta-DDIM. Loop
    step i runs DDIM index S-1-i and consumes step_noise[i] and jitter_noise[i].
    `x_clip` (None: the reference, which has no clamp) clamps the carry after
    every update, a rail against the blow-up a short-trained model can hit
    late in an eta=1 trajectory."""
    lead = lambda a: None if a is None else a[None]
    res = ddim_sample_scenes(
        model, [batch_cameras], [input_latents], [input_cameras], clip_v_embed[None], cfg_scale, num_steps=num_steps,
        eta=eta, feed_prev_depth=feed_prev_depth, return_trajectory=return_trajectory, init_noise=lead(init_noise),
        step_noise=lead(step_noise), jitter_noise=lead(jitter_noise), generators=[generator], x_clip=x_clip,
        method=method,
    )
    traj = res.pred_x0_trajectory
    return SampleResult(latents=res.latents[0], pred_x0_trajectory=None if traj is None else traj[0])


@torch.no_grad()
def ddim_sample_scenes(
    model: ViewFusion,
    batch_cameras: Sequence[Cameras],  # N scenes
    input_latents: Sequence[torch.Tensor],  # N x (1, h, w, 5)
    input_cameras: Sequence[Cameras],
    clip_v_embed: torch.Tensor,  # (N, B, 1, ctx + 28)
    cfg_scale: float,
    num_steps: int = 50,
    eta: float = 1.0,
    feed_prev_depth: bool = False,
    return_trajectory: bool = False,
    init_noise: Optional[torch.Tensor] = None,  # (N, B, H, W, C)
    step_noise: Optional[torch.Tensor] = None,  # (N, S, B, H, W, C)
    jitter_noise: Optional[torch.Tensor] = None,  # (N, S, B, H, W, D)
    generators: Optional[Sequence[Optional[torch.Generator]]] = None,  # one per scene
    x_clip: Optional[float] = None,
    method: str = "uniform",
) -> SampleResult:
    """ddim_sample over N scenes in one pass: each step is one
    apply_model_cfg_scenes (GridAttn a scene, one UNet call over the 2NB
    CFG batch) and one ddim_step on the (N, B, ...) carry. Scene n's noise
    comes from generators[n], drawn in the order of a one-scene run (init,
    step, jitter), so a scene's draws do not depend on its batch mates.
    Returns latents (N, B, H, W, C) and the trajectory (N, S, B, H, W, C)."""
    with span("sample.pass", opens_pass=True):
        cfg = model.cfg
        dev = clip_v_embed.device
        N, B = clip_v_embed.shape[:2]
        H = W = cfg.latent_size
        C = cfg.unet_out_channels
        ddim = make_ddim_schedule(cfg.timesteps, num_steps, cfg.linear_start, cfg.linear_end, device=dev, eta=eta,
                                  method=method)
        gens = list(generators) if generators is not None else [None] * N
        xs, steps, jitters = [], [], []
        for n in range(N):
            draw = lambda *shape: torch.randn(shape, generator=gens[n], device=dev, dtype=torch.float32)
            xs.append(draw(B, H, W, C) if init_noise is None else init_noise[n])
            steps.append(draw(num_steps, B, H, W, C) if step_noise is None else step_noise[n])
            jitters.append(draw(num_steps, B, H, W, cfg.n_pts_per_ray) if jitter_noise is None else jitter_noise[n])
        x = torch.stack(xs).to(dev, torch.float32)
        step_noise = torch.stack(steps, dim=1).to(dev, torch.float32)  # (S, N, B, ...)
        jitter_noise = torch.stack(jitters, dim=1).to(dev, torch.float32)

        traj = []
        prev_depth = [None]

        def predict(i, index, x):
            t = ddim.timesteps[index].expand(B)
            if feed_prev_depth and i == 0:
                prev_depth[0] = x[..., 4:5] / torch.sqrt(ddim.alphas[index])
            return model.apply_model_cfg_scenes(x, batch_cameras, input_latents, input_cameras, clip_v_embed, t,
                                                cfg_scale, jitter_noise[i], prev_depth=prev_depth[0])

        def after(i, pred_x0):
            if feed_prev_depth:
                prev_depth[0] = pred_x0[..., 4:5]
            if return_trajectory:
                traj.append(pred_x0)

        x = _ddim_loop(x, ddim, num_steps, predict, step_noise, dev, x_clip, after)
        return SampleResult(latents=x, pred_x0_trajectory=torch.stack(traj, dim=1) if return_trajectory else None)


@torch.no_grad()
def ddim_sample_views(
    model,
    context: torch.Tensor,  # (N, M, ctx): each request's prompt
    uncond_context: torch.Tensor,  # (1, M, ctx): the empty prompt
    camera: torch.Tensor,  # (N, F, 16)
    cfg_scale: float,
    num_steps: int = 50,
    init_noise: Optional[torch.Tensor] = None,  # (N, F, h, w, C)
    generators: Optional[Sequence[Optional[torch.Generator]]] = None,  # one per request
) -> SampleResult:
    """MVDream's sampler (nn/mvdream.py::MVDream; the LDM DDIM sampler as
    t2i.py runs it: eta 0, uniform timesteps) over N requests of F views in
    one pass: each step one apply_model_cfg (one UNet call over the 2NF CFG
    batch) and one ddim_step. Request n's initial latents come from
    generators[n] where not given, so a request's draw does not depend on
    its batch mates. Returns latents (N, F, h, w, C)."""
    with span("sample.pass", opens_pass=True):
        cfg = model.cfg
        dev = context.device
        N, F = camera.shape[:2]
        h = cfg.image_size
        ddim = make_ddim_schedule(cfg.timesteps, num_steps, cfg.linear_start, cfg.linear_end, device=dev, eta=0.0)
        if init_noise is None:
            gens = list(generators) if generators is not None else [None] * N
            init_noise = torch.stack([torch.randn(F, h, h, cfg.out_channels, generator=g, device=dev) for g in gens])
        x = init_noise.to(dev, torch.float32)

        def predict(i, index, x):
            return model.apply_model_cfg(x, ddim.timesteps[index], context, uncond_context, camera, cfg_scale)

        return SampleResult(latents=_ddim_loop(x, ddim, num_steps, predict, None, dev), pred_x0_trajectory=None)
