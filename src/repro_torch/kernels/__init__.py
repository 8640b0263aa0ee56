"""Kernels of the port: the serving path's attention and (int8-weight)
matmul, and the kernel API's tuned ops (flat flash attention, RMSNorm, row
softmax, axpy, dot product, Stockham FFT, conv2d): hand-written CUDA for
sm_90a (``csrc/``), their ctypes wrappers, the plain PyTorch versions
(``ref``), the block-size tuner (``autotune``) and the device dispatch
(``ops``). Nothing is built at import."""
