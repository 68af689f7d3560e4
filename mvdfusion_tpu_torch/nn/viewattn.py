"""Depth-guided cross-view attention, GridAttn (torch counterpart of
mvdfusion_tpu/nn/viewattn.py).

Per denoising step: unbias the noisy depth channel by 1/sqrt(abar_t) (or
take the caller's depth, `overwrite_attn_depth`) and jitter it by
sqrt(1-abar)/sqrt(abar)/10; shoot one ray per latent pixel to that metric
depth; reproject every point into all V views and the input
view; build per-point tokens across V (gathered features + geometric
embeddings); run the adaLN-Zero DiT across V, softmax-pool and project to a
(B, H, W, D, out) frustum.

Two paths compute it, as in the reference: K4 (ops/crossview.py, the
gather + DiT + pool kernels) where its gate is open (V <= 16 views, maps of
at most 8192 pixels, hid <= 512) and fuse_mode is "auto", and the general
path (the reference's XLA branch, nn/viewattn.py:335-371) everywhere else:
past the gate, with the top-k view window (keep_top_k_views: a static window
of top_k + 1 views by index, wrapping), under fuse_mode "never" (every
train step) or the kernel-off switch. The general path is differentiable
PyTorch that rounds where the reference's modules round.

The pre_layer_b Linear over the 723-wide concat is applied factorised: the
feature-map parts are projected before the gather (they commute with the
bilinear interpolation), the view-invariant parts form `b_acc`, and the
geometric parts are repacked into the K4 kernel's `kall` rows. Names follow
view_attn_efficient2.py (z_embedder.0, pre_layer_b.0, aggregation_transformer
.layer_list.{i}, weight_layer, final_layer_b).

`views` (a slice of the target views) restricts the queries to those views'
rays, as a rank of the sp axis runs it (parallel/mesh.py): N = |views| H W D
query points, each still gathering from and attending across all V views'
embedded latents, so the caller passes every view's noisy latent. GridAttn
is whole under tensor parallelism (the JAX rule replicates view_attn).

`forward` runs its body (`eager_forward`) as it is, or, where its tensors
are on CUDA, autograd records nothing and the stream is not capturing, as a
CUDA graph of that body (utils/graphs.py): captured at the first call of a
key (`graph_key`: the shapes and every choice the body makes, and the
parameters' pointers and versions), then replayed, its inputs copied in and
its output copied out. Both issue the same kernels and aten ops; a replay
issues them without the host. The last MAX_GRAPHS graphs are kept; a
parameter's change (a weight reload) drops the graphs of the old weights.
Each graph call is a span of utils/trace.py, `gridattn.capture` or
`gridattn.replay`.
"""

from __future__ import annotations

import collections

import torch
import torch.nn as nn
import torch.nn.functional as F

from mvdfusion_tpu_torch.core.schedule import DDPMSchedule
from mvdfusion_tpu_torch.geometry.cameras import Cameras, camera_center, camera_slice, transform_points_ndc
from mvdfusion_tpu_torch.geometry.gridsample import grid_sample
from mvdfusion_tpu_torch.geometry.harmonics import frequency_tensor, harmonic_embed, harmonic_frequencies
from mvdfusion_tpu_torch.geometry.rays import pixel_grid, pixel_rays, plucker_coords, rays_to_points
from mvdfusion_tpu_torch.nn.layers import Linear, Mlp, TimmAttention, gelu_exact, silu
from mvdfusion_tpu_torch.ops import _lib
from mvdfusion_tpu_torch.ops.crossview import (
    AggregatorWeights,
    GeoWeights,
    crossview_aggregate,
    prepared_crossview_weights,
    should_fuse_crossview,
)
from mvdfusion_tpu_torch.utils.graphs import Graphed
from mvdfusion_tpu_torch.utils.trace import span


def _ln_plain(x, eps: float = 1e-6):
    """Affine-free LayerNorm in fp32, cast back (the reference's
    LayerNormFp32(use_scale_bias=False))."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(x.dtype)


class DiTBlock(nn.Module):
    """adaLN-Zero DiT block; adaLN_modulation = [SiLU, Linear(hid, 6 hid)]."""

    def __init__(self, hidden: int, heads: int, mlp_ratio: float = 2.0):
        super().__init__()
        self.attn = TimmAttention(hidden, heads)
        self.mlp = Mlp(hidden, int(hidden * mlp_ratio), hidden)
        self.adaLN_modulation = nn.ModuleList([nn.Identity(), Linear(hidden, 6 * hidden)])

    def forward(self, x, c):
        """x (N, V, C) tokens, c (1 or N, C) conditioning, both in the
        weights' dtype."""
        mod = self.adaLN_modulation[1](silu(c))
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = (m[:, None] for m in mod.chunk(6, dim=-1))
        x = x + g_a * self.attn(_ln_plain(x) * (1 + sc_a) + sh_a)
        return x + g_m * self.mlp(_ln_plain(x) * (1 + sc_m) + sh_m)


class AggregationTransformer(nn.Module):
    def __init__(self, hidden: int, heads: int, num_layers: int = 3, mlp_ratio: float = 2.0):
        super().__init__()
        self.layer_list = nn.ModuleList([DiTBlock(hidden, heads, mlp_ratio) for _ in range(num_layers)])
        self.weight_layer = Linear(hidden, 1)

    def forward(self, x, c):
        """-> (tokens (N, V, C), pooling logits (N, V, 1))."""
        for block in self.layer_list:
            x = block(x, c)
        return x, self.weight_layer(x)


# reference hyperparameters (view_attn_efficient2.py): metric depth range and
# the harmonic embedding's 7 frequencies omega0 * 2^k
DEPTH_SCALE, DEPTH_SHIFT = 2.0, 0.5
N_HARMONIC, OMEGA0 = 7, 0.1
MAX_GRAPHS = 4  # GridAttn's CUDA graphs kept at once (one a call shape)


def graphable(x: torch.Tensor) -> bool:
    """Whether a call on activations `x` runs as a CUDA graph: x on CUDA,
    autograd recording nothing, the stream not capturing already."""
    return x.is_cuda and not torch.is_grad_enabled() and not torch.cuda.is_current_stream_capturing()


class GridAttn(nn.Module):
    def __init__(
        self,
        in_channels: int = 5,
        hidden_size: int = 256,
        output_dim: int = 768,
        num_heads: int = 8,
        mlp_ratio: float = 2.0,
        num_layers: int = 3,
        n_pts_per_ray: int = 1,
        keep_top_k_views: bool = False,
        top_k: int = 4,
    ):
        super().__init__()
        self.hidden_size, self.output_dim, self.num_heads = hidden_size, output_dim, num_heads
        self.n_pts_per_ray = n_pts_per_ray
        self.keep_top_k_views, self.top_k = keep_top_k_views, top_k
        hs = hidden_size
        # concat order: view feats | input feats | ref plucker | ref depth | query plucker | query depth | mask
        self.dims = (hs, hs, 90, 15, 90, 15, 1)
        self.z_embedder = nn.ModuleList([Linear(in_channels, hs)])
        self.pre_layer_b = nn.ModuleList([Linear(sum(self.dims), hs)])
        self.aggregation_transformer = AggregationTransformer(hs, num_heads, num_layers, mlp_ratio)
        self.final_layer_b = Linear(hs, output_dim)
        self._graphs = collections.OrderedDict()  # graph_key -> Graphed, oldest use first

    def part_weight(self, i: int) -> torch.Tensor:
        """(hid, dims[i]) slice of pre_layer_b for concat slot i."""
        off = sum(self.dims[:i])
        return self.pre_layer_b[0].weight[:, off : off + self.dims[i]]

    def _part(self, i: int, x):
        w = self.part_weight(i)
        return (x.to(w.dtype).float() @ w.float().t()).to(w.dtype)

    def _z_embed(self, a):
        """z_embedder then the exact GELU, rounded to the weight's dtype where
        the reference's Dense(dtype) and jax.nn.gelu round, op by op: the
        product, then the bias add; GELU as (0.5 x) * erfc(-x * sqrt(1/2)),
        sqrt(1/2), each product and the erfc in that dtype."""
        lin = self.z_embedder[0]
        dt = lin.weight.dtype
        return gelu_exact((a.to(dt).float() @ lin.weight.float().t()).to(dt) + lin.bias.to(dt))

    def _kernel_params(self) -> tuple:
        """Every parameter that _static_kernel_weights reads."""
        wl = self.aggregation_transformer.weight_layer
        per_layer = (
            t for b in self.aggregation_transformer.layer_list
            for t in (b.attn.qkv.weight, b.attn.qkv.bias, b.attn.proj.weight, b.attn.proj.bias,
                      b.mlp.fc1.weight, b.mlp.fc1.bias, b.mlp.fc2.weight, b.mlp.fc2.bias)
        )
        return (self.pre_layer_b[0].weight, *per_layer, wl.weight, wl.bias, self.final_layer_b.weight,
                self.final_layer_b.bias)

    def _static_kernel_weights(self):
        """K4's operands that depend on the parameters alone: the geometric
        rows `kall` in the kernel's [raw | sin freq-major | cos] order, and the
        DiT weights (mods left None)."""
        nh, hs = N_HARMONIC, self.hidden_size
        P90 = self.part_weight(2).t()  # (90, hid): harmonic layout per dim: n sin, n cos ... then raw 6
        P15 = self.part_weight(3).t()  # (15, hid)
        kx = torch.cat([P90[12 * nh :], P15[2 * nh :]], dim=0)  # (7, hid)
        sin_all = torch.cat(
            [P90[: 6 * nh].reshape(6, nh, hs).transpose(0, 1), P15[:nh].reshape(nh, 1, hs)], dim=1
        ).reshape(7 * nh, hs)
        cos_all = torch.cat(
            [P90[6 * nh : 12 * nh].reshape(6, nh, hs).transpose(0, 1), P15[nh : 2 * nh].reshape(nh, 1, hs)], dim=1
        ).reshape(7 * nh, hs)
        geo = GeoWeights(kall=torch.cat([kx, sin_all, cos_all], dim=0), kmask=self.part_weight(6)[:, 0])
        layers = self.aggregation_transformer.layer_list
        wl = self.aggregation_transformer.weight_layer
        agg = AggregatorWeights(
            qkv_w=[b.attn.qkv.weight for b in layers], qkv_b=[b.attn.qkv.bias for b in layers],
            proj_w=[b.attn.proj.weight for b in layers], proj_b=[b.attn.proj.bias for b in layers],
            fc1_w=[b.mlp.fc1.weight for b in layers], fc1_b=[b.mlp.fc1.bias for b in layers],
            fc2_w=[b.mlp.fc2.weight for b in layers], fc2_b=[b.mlp.fc2.bias for b in layers],
            mods=None, wl_w=wl.weight, wl_b=wl.bias,
            fin_w=self.final_layer_b.weight, fin_b=self.final_layer_b.bias,
        )
        return geo, agg

    def kernel_weights(self, t_embed0: torch.Tensor, prepared: bool = False):
        """K4's operands from this module's params: _static_kernel_weights
        (with `prepared`, their prepared form, kept on this module until a
        parameter changes: ops/crossview.py::prepared_crossview_weights) and
        the shared-t adaLN modulation of this step (fp32)."""
        dt = self.pre_layer_b[0].weight.dtype
        cs = silu(t_embed0.to(dt).float())  # shared-t conditioning in dt
        mods = torch.stack([
            F.linear(cs, b.adaLN_modulation[1].weight.float(), b.adaLN_modulation[1].bias.float())
            .reshape(6, self.hidden_size)
            for b in self.aggregation_transformer.layer_list
        ])
        if prepared:
            geo, agg = prepared_crossview_weights(self, self._kernel_params(), self._static_kernel_weights, dt,
                                                  self.num_heads, harmonic_frequencies(N_HARMONIC, OMEGA0))
        else:
            geo, agg = self._static_kernel_weights()
        return geo, agg._replace(mods=mods)

    def graph_key(self, noisy_latents, batch_cameras, predict_mask, t_embed, t, sched, input_latents, input_cameras,
                  jitter_noise, overwrite_attn_depth=None, fuse_mode="auto", views=None) -> tuple:
        """What a CUDA graph of eager_forward fixes for forward's arguments:
        every tensor's shape and dtype (None for the overwrite not given),
        the device, fuse_mode, views, the kernel-off switch, the DDPM tables'
        pointers, and the data pointer, version and dtype of every parameter
        (as the prepared weights' cache, ops/_lib.py::cached), last."""
        tensors = (noisy_latents, *batch_cameras, predict_mask, t_embed, t, input_latents, *input_cameras,
                   jitter_noise, overwrite_attn_depth)
        return (
            tuple(None if x is None else (x.shape, x.dtype) for x in tensors), noisy_latents.device, fuse_mode,
            None if views is None else (views.start, views.stop), _lib.switched_off(),
            sched.sqrt_alphas_cumprod.data_ptr(), sched.sqrt_one_minus_alphas_cumprod.data_ptr(),
            tuple((p.data_ptr(), p._version, p.dtype) for p in self.parameters()),
        )

    def forward(self, noisy_latents, batch_cameras: Cameras, predict_mask, t_embed, t, sched: DDPMSchedule,
                input_latents, input_cameras: Cameras, jitter_noise, overwrite_attn_depth=None,
                fuse_mode: str = "auto", views: slice | None = None):
        """eager_forward, as a CUDA graph where `graphable` (module
        docstring)."""
        args = (noisy_latents, batch_cameras, predict_mask, t_embed, t, sched, input_latents, input_cameras,
                jitter_noise, overwrite_attn_depth, fuse_mode, views)
        if not graphable(noisy_latents):
            return self.eager_forward(*args)
        key = self.graph_key(*args)
        # the body reads t_embed's row 0 alone (the shared t)
        inputs = (noisy_latents, *batch_cameras, predict_mask, t_embed[:1], t, input_latents, *input_cameras,
                  jitter_noise, overwrite_attn_depth)
        graph = self._graphs.get(key)
        if graph is not None:
            self._graphs.move_to_end(key)
            with span("gridattn.replay"):
                return graph(inputs)
        params = key[-1]
        for old in [k for k in self._graphs if k[-1] != params]:  # the old weights' graphs
            del self._graphs[old]
        while len(self._graphs) >= MAX_GRAPHS:
            self._graphs.popitem(last=False)

        def body(x, R, T, f, c, mask, te, tt, x_in, R_in, T_in, f_in, c_in, jitter, overwrite):
            return self.eager_forward(x, Cameras(R, T, f, c), mask, te, tt, sched, x_in,
                                      Cameras(R_in, T_in, f_in, c_in), jitter, overwrite, fuse_mode, views)

        with span("gridattn.capture"):
            graph = Graphed(body, inputs)
            # what the graph reads without a copy, held while it lives
            graph.keep = (sched, getattr(self, "_mvdf_crossview_weights", None),
                          [p.detach() for p in self.parameters()],
                          frequency_tensor(N_HARMONIC, OMEGA0, noisy_latents.device),
                          pixel_grid(*noisy_latents.shape[1:3], noisy_latents.device))
            self._graphs[key] = graph
            return graph(inputs)

    def eager_forward(
        self,
        noisy_latents,  # (B, H, W, 5) NHWC
        batch_cameras: Cameras,  # V == B target cameras
        predict_mask,  # (B,)
        t_embed,  # (B, time_embed_dim); only row 0 is used (shared t)
        t,  # (B,) int timesteps
        sched: DDPMSchedule,
        input_latents,  # (1, H, W, 5)
        input_cameras: Cameras,
        jitter_noise,  # (B, H, W, D) unit normal
        overwrite_attn_depth=None,  # (B, H, W, 1): the sampler's previous pred_x0 depth
        fuse_mode: str = "auto",  # "auto": K4 where its gate is open; "never": the general path
        views: slice | None = None,  # the query views (all by default); t, jitter, overwrite: all B views
    ):
        V, H, W, _ = noisy_latents.shape
        D = self.n_pts_per_ray
        q = slice(0, V) if views is None else views
        B = q.stop - q.start  # query views
        dt = self.pre_layer_b[0].weight.dtype

        # 1. depth: the unbiased estimate (or the given override) + jitter
        t = t[q]
        sqrt_acp = sched.sqrt_alphas_cumprod[t]
        depth_std = (sched.sqrt_one_minus_alphas_cumprod[t] / sqrt_acp / 10.0)[:, None, None, None]
        if overwrite_attn_depth is None:
            depth = noisy_latents[q][..., 4:5].float() / sqrt_acp[:, None, None, None]
        else:
            depth = overwrite_attn_depth[q].float()
        depth = depth.expand(B, H, W, D) + depth_std * jitter_noise[q].float()
        depth = torch.clamp((depth + 1.0) * 0.5, 0.0, 1.0) * DEPTH_SCALE + DEPTH_SHIFT

        # 2. rays and world points
        rays = pixel_rays(batch_cameras if views is None else camera_slice(batch_cameras, q), H, W)
        pts_flat = rays_to_points(rays, depth).reshape(1, B * H * W * D, 3)
        N = B * H * W * D

        # 3. embedded latents, pre-projected by their pre_layer_b slices
        view_feat_p = self._part(0, self._z_embed(noisy_latents))  # (V, H, W, hid)
        input_feat_p = self._part(1, self._z_embed(input_latents))  # (1, H, W, hid)
        ndc_all = transform_points_ndc(batch_cameras, pts_flat)  # (V, N, 3)
        ndc_in = transform_points_ndc(input_cameras, pts_flat)  # (1, N, 3)

        # 4. view-invariant token parts: input-view gather + query geometry + bias
        hembed = lambda a: harmonic_embed(a, N_HARMONIC, OMEGA0)
        centers = camera_center(batch_cameras)  # (V, 3)
        q_dir = rays.directions / torch.clamp(torch.linalg.norm(rays.directions, dim=-1, keepdim=True), min=1e-12)
        q_dir = q_dir[:, :, :, None, :].expand(B, H, W, D, 3).reshape(1, N, 3)
        q_origin = centers[q, None, None, None, :].expand(B, H, W, D, 3).reshape(1, N, 3)
        acc_b = (
            grid_sample(input_feat_p, -ndc_in[..., :2])
            + self._part(4, hembed(plucker_coords(q_origin, q_dir)))
            + self._part(5, hembed(depth.reshape(1, N, 1)))
            + self.pre_layer_b[0].bias.to(dt)
        )  # (1, N, hid)

        if fuse_mode == "auto" and not self.keep_top_k_views and should_fuse_crossview(V, H, W, self.hidden_size):
            prepared = _lib.reads_prepared(noisy_latents)
            if prepared and _lib.needs_grad(t_embed, self._kernel_params()):
                # the kernels read the prepared weights, the gradient reaches the parameters
                kernel_w = self.kernel_weights(t_embed[0], prepared=True)
                geo, agg = self.kernel_weights(t_embed[0])
            else:
                geo, agg = kernel_w = self.kernel_weights(t_embed[0], prepared=prepared)
            frustum = crossview_aggregate(
                -ndc_all[..., :2], pts_flat[0], centers, predict_mask, acc_b[0], view_feat_p, geo, agg,
                self.num_heads, harmonic_frequencies(N_HARMONIC, OMEGA0), prepared=kernel_w,
            )
            return frustum.reshape(B, H, W, D, self.output_dim)

        # 5. the general path: per-view geometry, the token sum, the DiT across views, the softmax pool
        ref_dir = pts_flat[0][None] - centers[:, None]  # (V, N, 3)
        ref_depth = torch.linalg.norm(ref_dir, dim=-1, keepdim=True)
        ref_dir = ref_dir / torch.clamp(ref_depth, min=1e-12)
        mask_tok = predict_mask[:, None, None].to(dt).expand(V, N, 1)
        acc_v = (
            grid_sample(view_feat_p, -ndc_all[..., :2])
            + self._part(2, hembed(plucker_coords(centers[:, None], ref_dir)))
            + self._part(3, hembed(ref_depth))
            + self._part(6, mask_tok)
        )  # (V, N, hid)
        if self.keep_top_k_views:
            # a static window of top_k + 1 views by index, wrapping; tokens are view-major
            offsets = torch.arange(-(self.top_k // 2), self.top_k // 2 + 1, device=acc_v.device)
            idx = (torch.arange(N, device=acc_v.device) // (H * W * D) + q.start)[None, :] + offsets[:, None]
            acc_v = torch.gather(acc_v, 0, (idx % V)[:, :, None].expand(-1, -1, acc_v.shape[-1]))
        tokens = gelu_exact((acc_v + acc_b).transpose(0, 1))  # (N, V', hid)
        out, w = self.aggregation_transformer(tokens, t_embed[:1].to(dt))
        w = torch.softmax(w.float(), dim=-2).to(dt)
        frustum = self.final_layer_b((out * w).sum(dim=-2))
        return frustum.reshape(B, H, W, D, self.output_dim)
