"""Kernels off every production path: K3 ``minwin.place_minwin``, the
sortless min-window placement, and its plain version. Nothing in the
port's forecast imports this package."""
