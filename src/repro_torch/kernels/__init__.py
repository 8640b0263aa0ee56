"""Kernels of the serving path (attention, and the int8-weight matmul):
hand-written CUDA for sm_90a (``csrc/``), their ctypes wrappers, the plain
PyTorch versions (``ref``) and the device dispatch (``ops``). Nothing is
built at import."""
