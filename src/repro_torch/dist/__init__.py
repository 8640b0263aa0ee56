"""Distributed-serving helpers of the port. Only the row quantizer of the
quantized KV cache is ported so far (``compression``)."""
