"""mvdfusion_tpu_torch — the PyTorch/CUDA port of mvdfusion_tpu for NVIDIA Hopper.

Same layering as the JAX package it is held against (bottom -> top):
    core      — diffusion schedules
    geometry  — cameras / rays / harmonics / grid sampling (PyTorch3D conventions)
    utils     — small shared helpers
    ops       — hand-written CUDA kernels (csrc/) with their plain PyTorch
                versions, one module per Pallas kernel of the JAX package
    nn        — torch modules: VAE, CLIP image tower, UNet, GridAttn, ViewFusion
    pipeline  — the eta=1 DDIM sampler
    convert   — loading the JAX package's params into the port

Layouts follow the JAX package at every public function (NHWC images and
latents, (B, N, H, dh) attention operands), so both packages take the same
numpy arrays. Module and parameter names follow the reference checkpoint's
state-dict keys. Entry points run on CUDA unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain version.
"""

__version__ = "0.1.0"
