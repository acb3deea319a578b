"""Params to and from numpy: the bridge between the JAX package's param
tree and the port's.

The caller turns the JAX tree into numpy (bf16 leaves upcast to float32
first, since numpy has no bf16 of its own); ``params_from_numpy`` turns
that tree into the port's, on a device, in the config's ``param_dtype``
(f32 or bf16: a bf16 value upcast to f32 converts back exactly), and
``params_to_numpy`` is its inverse, so trained params can be held
against the reference's. Both the plain tree
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


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's param tree -> numpy on the host, float leaves as f32
    (bf16 upcast exactly), int8 leaves as int8: the layout the JAX
    package's tree has, for comparing the two."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    return {name: ({k: leaf(v) for k, v in value.items()}
                   if isinstance(value, dict) else leaf(value))
            for name, value in tree.items()}
