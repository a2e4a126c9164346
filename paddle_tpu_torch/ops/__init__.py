"""Tensor ops of the port (counterpart of ``paddle_tpu/ops``)."""
