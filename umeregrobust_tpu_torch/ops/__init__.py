"""Neighbor search, voxels, dense grid, kernel maps, sparse conv, and the
wrappers of the hand-written CUDA kernels (cuda_nn, cuda_ume, cuda_corr)."""
