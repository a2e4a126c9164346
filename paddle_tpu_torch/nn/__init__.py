"""Neural-network helpers of the port (counterpart of ``paddle_tpu/nn``;
only what the ported training path uses)."""
