"""Device resolution shared by the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card. When
no card is present that raises: a run that asked for the card never
falls back to the CPU without saying so. Tests and CPU runs pass
``device="cpu"``.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; raise when a CUDA device is
    asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:       # compare equal to tensors' devices
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

