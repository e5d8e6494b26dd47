"""Device resolution for the port's entry points.

Every entry point takes a ``device`` argument. ``None`` means the card:
``cuda``, which must be present and must be a Hopper part (compute
capability 9.0), since the kernels are compiled for ``sm_90a`` only. The
CPU is used only when a caller asks for it by name (``device="cpu"``), as
the CPU tests do: there every kernel wrapper runs its plain torch version.
Nothing here falls back from one device to the other.
"""

from __future__ import annotations

import torch

from elasticsearch_tpu_torch.common.errors import DeviceUnavailableError

HOPPER_CAPABILITY = (9, 0)


def resolve(device=None) -> torch.device:
    """The torch.device an entry point runs on; raises when CUDA is
    requested (explicitly or by default) and absent or not sm_90."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise DeviceUnavailableError(
            f"device {dev} is not supported: pass 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "torch versions of the kernels on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cap = torch.cuda.get_device_capability(dev)
    if cap != HOPPER_CAPABILITY:
        raise DeviceUnavailableError(
            f"{torch.cuda.get_device_name(dev)} has compute capability "
            f"{cap}; the kernels are built for sm_90a (Hopper)")
    return dev
