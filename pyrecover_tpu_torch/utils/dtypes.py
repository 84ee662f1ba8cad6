"""Dtype policy: precision strings to torch dtypes.

As in the JAX package, there is no global default dtype: ``param_dtype``
is the dtype parameters are stored in and ``compute_dtype`` the one
activations and matrix products run in; weights are cast at each use.
"""

import torch

PRECISION_STR_TO_DTYPE = {
    "fp16": torch.float16,
    "bf16": torch.bfloat16,
    "fp32": torch.float32,
    "fp64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}


def resolve_dtype(name):
    if isinstance(name, torch.dtype):
        return name
    try:
        return PRECISION_STR_TO_DTYPE[str(name).lower()]
    except KeyError:
        raise ValueError(
            f"Unknown precision {name!r}; expected one of {sorted(PRECISION_STR_TO_DTYPE)}"
        ) from None
