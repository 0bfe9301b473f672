"""Kernels of the port: K1 ``placement.place_min`` and K2
``stem.onehot_stem_conv`` on the forecast path, K3
``experimental.minwin.place_minwin`` and the K4 probes of
``strided_load`` off it (hand-written CUDA, ``csrc/``), and the plain
PyTorch z-buffer and mask-paste code around them."""
