"""Projection, pair staging and rasterization (plain torch plus CUDA kernels)."""
