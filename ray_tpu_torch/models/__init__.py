"""Models of the port (PyTorch counterparts of ``ray_tpu.models``)."""
