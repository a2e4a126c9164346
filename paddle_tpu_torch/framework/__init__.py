"""Framework types of the port (counterpart of ``paddle_tpu/framework``;
only ``SelectedRows`` so far)."""
