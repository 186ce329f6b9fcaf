"""Compute primitives: quaternion and SoA math, the physics step and its
CUDA kernel."""
