"""Attention kernels of the serving path: hand-written CUDA for sm_90a
(``csrc/``), their ctypes wrappers, the plain PyTorch versions (``ref``) and
the device dispatch (``ops``). Nothing is built at import."""
