"""Attention primitives and the hand-written Hopper kernels (csrc/)."""
