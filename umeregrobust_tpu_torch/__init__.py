"""PyTorch/CUDA port of umeregrobust_tpu (LiDAR rigid registration).

Sub-packages mirror the JAX package: `core/` (SO(3), transforms, UME),
`ops/` (neighbors, voxels, dense grid, kernel maps, sparse conv and the
hand-written Hopper kernels' wrappers), `models/` (the ResUNet backbone
as an `nn.Module`, weight loading), `pipeline/` (UME generation,
matching, correlator, consensus, ICP, the per-pair entry point) and
`data/` (synthetic scenes and SEM resampling). CUDA sources live in
`csrc/` and are built with nvcc at first use (ops/_build.py).

The package imports torch, numpy and scipy only; it never imports jax or
the JAX package.
"""
