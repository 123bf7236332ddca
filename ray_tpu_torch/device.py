"""The device every entry point of the port runs on.

CUDA unless the caller asks for the CPU: with no ``device`` argument the
port runs on ``cuda`` and raises when there is none. It never picks the
CPU by itself, so a run that was meant for the card cannot quietly run
somewhere else.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def default_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` when ``device`` is None; ``cpu`` only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on CUDA and no CUDA device is available; "
            "pass device='cpu' to run the plain CPU path")
    return dev
