"""PyTorch/CUDA port of fea_tpu, beside the JAX package it is held against.

Ported so far: the FDN-UNet model family and the conditional DDPM
(`models`), the regression and diffusion trainers (`train`) with the
dataset (`data`), and the flash-attention and fused GroupNorm+SiLU kernels
written by hand in CUDA for Hopper (`ops`, `csrc`). Public model functions
keep fea_tpu's NHWC layout.
"""
