"""Where the port's entry points run."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card. Asking for CUDA on a host without one
    raises: the port never drops to the CPU unless the caller asks for it
    (``device="cpu"``, as the tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; the port runs on the card by "
            "default (pass device='cpu' to run the plain versions on the "
            "CPU)")
    return dev
