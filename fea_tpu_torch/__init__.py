"""PyTorch/CUDA port of fea_tpu, beside the JAX package it is held against.

Ported so far: the FDN-UNet model family, the plain UNet and the
conditional DDPM (`models`), the regression and diffusion trainers
(`train`) with the PNG dataset, the condition store and the
device-resident store (`data`), the flash-attention and fused
GroupNorm+SiLU kernels written by hand in CUDA for Hopper (`ops`, `csrc`),
and the single-mesh FEM core (`fem`) over the CDT mesher (`mesh`,
`geometry`, `materials`). Public model functions keep fea_tpu's NHWC
layout; FEM arrays keep its element-minor, planar-dof layouts.
"""
