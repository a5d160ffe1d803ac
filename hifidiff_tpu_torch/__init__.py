"""PyTorch + CUDA port of hifidiff_tpu for NVIDIA Hopper (H100).

Mirrors hifidiff_tpu's layout (ops/, nn/, models/, vae/, diffusion/, train/,
pipeline.py, and the entry points' cli/, data/, eval/ and utils/). Modules
are NCHW `nn.Module`s whose `state_dict()` keys are the
HifiDiff reference checkpoint's own (diffusers' for the VAE); the public
pipeline keeps the JAX package's NHWC uint8 image layout. The TPU's Pallas
kernels are hand-written CUDA kernels in `csrc/`, each with a plain PyTorch
version beside it that CPU tensors take. `ln_film` and the affine warp have
backward kernels and train (`train/`); the int8 matmul, the fused
GroupNorm + SiLU and the fused small-map block are inference only and raise
where a gradient is wanted.

Importing the package imports nothing beyond torch and numpy, never jax.
"""
