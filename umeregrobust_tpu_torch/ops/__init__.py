"""Neighbor search, voxels, dense grid, kernel maps, sparse conv, the
wrappers of the hand-written CUDA kernels (cuda_nn, cuda_ume, cuda_corr,
cuda_gather, cuda_conv), and the voxel hash table and hash-grid NN
(hashing, gridnn).

The hash table and grid NN are exported here as the JAX package's
ops/__init__.py exports them, loaded on first use: ops/voxel.py serves
the host-only data layer, which must not pull in torch.
"""
_LAZY = {"HashTable": "hashing", "build_hash_table": "hashing",
         "lookup": "hashing", "GridIndex": "gridnn", "build_grid": "gridnn",
         "nn_query": "gridnn", "overflow_count": "gridnn"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(
            f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
