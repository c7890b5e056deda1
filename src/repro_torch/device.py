"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for but
    missing (the port never moves to the CPU on its own).  ``"meta"`` is
    taken when the caller names it: tensors with shapes and dtypes and no
    data, on which the kernel wrappers allocate what they would allocate and
    launch nothing (the dry-run, ``launch/dryrun.py``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
