"""Device resolution shared by every entry point of the port.

The port runs on the card: ``device=None`` means ``cuda``. With no card and no
explicit ``device="cpu"`` an entry point raises instead of carrying on quietly
on the CPU, where every kernel would silently become its plain version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no card is present); else ``device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "orp_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def as_indices(indices, device=None) -> torch.Tensor:
    """Path indices as an int64 tensor: a tensor stays on its own device (or
    moves to ``device`` when one is given); anything else is placed on
    ``resolve_device(device)``, the card by default."""
    if isinstance(indices, torch.Tensor) and device is None:
        return indices.to(torch.int64)
    return torch.as_tensor(indices).to(device=resolve_device(device), dtype=torch.int64)


def path_indices(n_paths: int, indices=None, device=None) -> torch.Tensor:
    """The Sobol point indices of a pricer: ``arange(n_paths)`` on
    ``resolve_device(device)`` when ``indices`` is None, else
    :func:`as_indices` (a tensor keeps its own device)."""
    if indices is None:
        return torch.arange(n_paths, dtype=torch.int64, device=resolve_device(device))
    return as_indices(indices, device)
