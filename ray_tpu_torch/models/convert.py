"""Params from numpy: the bridge from the JAX package's param tree.

The caller turns the JAX tree into numpy (bf16 leaves upcast to float32
first, since numpy has no bf16 of its own); this module turns that tree
into the port's, on a device, with the port's dtypes. Both the plain tree
of ``init_params`` and the int8 tree of ``quantize_weights_int8``
(``w_q``/``w_s``, ``lm_head_q``/``lm_head_s``) convert. The layout is
the same on both sides (stacked layers, weights [in, out]), so nothing is
transposed.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.llama import LlamaConfig


def _leaf(name: str, arr: Any, config: LlamaConfig,
          dev: torch.device) -> torch.Tensor:
    a = np.array(arr)                         # a writable, owned copy
    t = torch.from_numpy(a)
    if a.dtype == np.int8:
        return t.to(dev)                      # int8 weights stay int8
    if not np.issubdtype(a.dtype, np.floating):
        raise TypeError(f"param {name!r}: unexpected dtype {a.dtype}")
    # Quantization scales are f32 in the reference whatever param_dtype.
    dtype = torch.float32 if name.endswith("_s") else config.param_dtype
    return t.to(device=dev, dtype=dtype)


def params_from_numpy(tree: Dict[str, Any], config: LlamaConfig,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Dict[str, Any]:
    """numpy param tree (the JAX layout) -> the port's param tree on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for name, value in tree.items():
        if name == "layers":
            out[name] = {k: _leaf(k, v, config, dev)
                         for k, v in value.items()}
        else:
            out[name] = _leaf(name, value, config, dev)
    return out
