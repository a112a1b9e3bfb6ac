"""The default device of new tensors and layers (port of
``paddle_tpu/device/__init__.py``'s ``set_device``/``get_device``).

Unset, it is ``cuda``, and without a GPU :func:`default_device` raises
instead of landing on the CPU: ``set_device("cpu")`` asks for the CPU
explicitly.
"""

from __future__ import annotations

import torch

_CURRENT: list = [None]   # the device set_device chose, or None


def set_device(device):
    """``"cpu"``, ``"gpu"``, ``"gpu:N"``, ``"cuda"`` or ``"cuda:N"``;
    returns the ``torch.device``."""
    name, _, index = str(device).partition(":")
    if name in ("gpu", "cuda"):
        dev = torch.device("cuda", int(index) if index else 0)
    elif name == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"set_device: unsupported device {device!r}; "
                         "the port runs on 'gpu' (cuda) or 'cpu'")
    _CURRENT[0] = dev
    return dev


def default_device() -> torch.device:
    """The device of new tensors and layers."""
    if _CURRENT[0] is not None:
        return _CURRENT[0]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device and none is available; "
            "call paddle.set_device('cpu') (or pass device='cpu') to run on "
            "the CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())


def get_device() -> str:
    """Paddle's name of the default device: ``"cpu"`` or ``"gpu:N"``."""
    dev = default_device()
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}"


__all__ = ["default_device", "get_device", "set_device"]
