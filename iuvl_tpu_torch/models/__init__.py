"""Models of the port (counterparts of ``iuvl_tpu/models``)."""
