"""Device choice of the port's entry points: the card unless the caller
asks for the CPU. The example scripts (``examples/torch_port/``) take the
CPU only with ``--cpu`` (``add_cpu_flag``, ``script_device``) and label
every time they print with ``card_name``."""

from __future__ import annotations

import argparse
import subprocess
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """None means "cuda". A CUDA device without a usable card raises: the
    port never carries on on the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "manuscript_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def add_cpu_flag(parser: argparse.ArgumentParser) -> None:
    """The scripts' ``--cpu``: without it they run on the card, and no card
    is an error."""
    parser.add_argument(
        "--cpu", action="store_true",
        help="run on the CPU (default: the CUDA card; without one the script raises)",
    )


def script_device(cpu: bool) -> torch.device:
    """The CPU with ``--cpu``, else the card (``resolve_device``)."""
    return resolve_device("cpu" if cpu else None)


def card_name(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them; "cpu" for the CPU."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[dev.index or 0]
