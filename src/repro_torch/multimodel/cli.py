"""Legacy CLI shim: forwards to the general solver front door.

A copy of the JAX package's ``multimodel/cli.py``, which is JAX-free.

    PYTHONPATH=src python -m repro_torch.multimodel.cli \
        --mix resnet50:1,alexnet:1 --hw mcm16 [--step 1] [--baselines]

is now exactly

    PYTHONPATH=src python -m repro_torch solve --strategy coschedule \
        --mix resnet50:1,alexnet:1 --hw mcm16 [--step 1] [--baselines]

(every historical flag is accepted by ``repro_torch solve`` under the same
name; the pinned strategy preserves this CLI's historical behavior of always
running ``co_schedule``, even for single-entry mixes where ``repro_torch
solve``'s auto-selection would pick the single-model DSE).  Kept so
existing invocations keep working; new code should call ``python -m
repro_torch solve`` or :func:`repro_torch.api.solve` directly.
"""
from __future__ import annotations

import sys


def main(argv=None) -> None:
    from ..__main__ import main as repro_main

    argv = list(sys.argv[1:] if argv is None else argv)
    # First so an explicit user --strategy (argparse last-wins) overrides.
    repro_main(["solve", "--strategy", "coschedule", *argv])


if __name__ == "__main__":
    main()
