"""PyTorch/CUDA port of the ISSGD system.

Mirrors the layout of the JAX reference package ``repro`` (kernels,
models, configs, optim, core, data, launch) and imports nothing of it.
"""
