"""Kernels of the serving path: plain PyTorch versions (``ref``), the
entry points the models call (``ops``), and the hand-written Hopper
kernels (``rmsnorm``, ``paged_attention``, ``decode_attention``, built
from ``csrc/`` by ``_build``), whose wrappers dispatch by device."""
