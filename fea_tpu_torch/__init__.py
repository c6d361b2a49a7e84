"""PyTorch/CUDA port of fea_tpu, beside the JAX package it is held against.

Ported so far: the FDN-UNet model family, the plain UNet and the
conditional DDPM (`models`), the regression and diffusion trainers
(`train`) with the PNG dataset, the condition store and the
device-resident store (`data`), the flash-attention and fused
GroupNorm+SiLU kernels written by hand in CUDA for Hopper (`ops`, `csrc`),
the FEM core (`fem`: the single-mesh solve and the flat plate-group solve)
over the CDT mesher (`mesh`, `geometry`, `materials`), the raster
(`raster`), datagen, sequential and batched (`datagen`), the accuracy
metrics (`metrics`), the application runner (`apps`), the training-log
tools (`utils.logs`), the CLI (`cli`, `python -m fea_tpu_torch`) and
multi-GPU data parallelism over torch.distributed (`parallel`: the
trainers data-parallel over a process group, datagen's chunks sharded over
devices). Public model functions keep fea_tpu's NHWC layout; FEM arrays
keep its element-minor, planar-dof layouts.
"""
