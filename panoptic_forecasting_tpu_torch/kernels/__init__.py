"""Kernels of the port: K1 ``placement.place_min`` and K2
``stem.onehot_stem_conv`` (hand-written CUDA, ``csrc/``), and the plain
PyTorch z-buffer and mask-paste code around them."""
