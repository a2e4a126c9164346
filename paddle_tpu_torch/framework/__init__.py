"""Framework types of the port (counterpart of ``paddle_tpu/framework``):
``SelectedRows`` (``selected_rows.py``) and ``save`` / ``load`` in the
JAX package's file format (``io.py``)."""
