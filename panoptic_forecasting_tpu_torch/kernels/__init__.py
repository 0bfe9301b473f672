"""Kernels of the port: K1 ``placement.place_min_fold`` (placement fused
with the corner fold) and K2 ``stem.onehot_stem_conv`` on the forecast
path; the generic K1 ``placement.place_min``, K3
``experimental.minwin.place_minwin`` and the K4 probes of
``strided_load`` off it (hand-written CUDA, ``csrc/``); and the plain
PyTorch z-buffer and mask-paste code around them."""
