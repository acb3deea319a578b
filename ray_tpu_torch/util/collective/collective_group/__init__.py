"""The port's collective backends (``ray_tpu/util/collective/
collective_group``): ``SHMGroup`` (``shm``), ``TorchGroup`` (``torch``,
for the reference's ``XLAGroup``) and ``CudaGroup`` (``cuda``, for its
``PallasGroup``). ``GroupManager`` imports each on first use."""
