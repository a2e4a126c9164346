"""Incubating APIs (counterpart of ``paddle_tpu/incubate``): the fused
inference ops of ``incubate.nn``."""
