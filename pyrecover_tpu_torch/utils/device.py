"""The device an entry point runs on."""

import torch


def resolve_device(name="cuda"):
    """``cuda`` -> the current card, raising when there is none; ``cpu``; a
    ``torch.device`` as it is. Entry points run on the card unless the
    caller asks for the CPU; none falls back to the CPU when it finds no
    card."""
    if isinstance(name, torch.device):
        return name
    if str(name) == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pyrecover_tpu_torch runs on the card; pass "
                "--device cpu (device='cpu') to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    if str(name) == "cpu":
        return torch.device("cpu")
    raise ValueError(f"device must be cuda or cpu, got {name!r}")
