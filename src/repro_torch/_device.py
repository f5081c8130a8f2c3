"""The port's one device policy.

Entry points run on the CUDA card unless the caller asks for the CPU:
``set_device("cpu")`` process-wide, or ``device="cpu"`` on a call.  A
CUDA request on a machine without a CUDA device raises; nothing falls
back to the CPU on its own.  ``"meta"`` builds shapes and dtypes
without storage (``input_specs``, ``abstract_train_state``).
"""

from __future__ import annotations

import torch

#: process-wide default set by :func:`set_device`; ``None`` means "cuda"
_default: torch.device | None = None


def set_device(device: str | torch.device | None) -> None:
    """Process-wide default device for the port's entry points
    (``None`` restores the default, ``"cuda"``)."""
    global _default
    _default = None if device is None else torch.device(device)


def policy() -> torch.device | None:
    """What :func:`set_device` last set (``None``: the default, the card)
    — handed to spawned workers, which start with the defaults."""
    return _default


def default_device_type() -> str:
    """The configured device type, without checking it exists."""
    return _default.type if _default is not None else "cuda"


def get_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve ``device`` (else the process default, else ``"cuda"``) and
    check that it exists.  Raises when CUDA is asked for and absent."""
    if device is not None:
        dev = torch.device(device)
    elif _default is not None:
        dev = _default
    else:
        dev = torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "present; pass device='cpu' or call "
            "repro_torch.set_device('cpu') to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu' "
                         f"('meta' for shapes only)")
    return dev
