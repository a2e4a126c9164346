"""Core helpers of the PyTorch port (counterpart of ``paddle_tpu/core``)."""
