"""Serving (PyTorch counterparts of ``ray_tpu.serve``)."""
