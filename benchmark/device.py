"""The device a number was measured on (a frozen copy of
``llckbdm_tpu_torch/tools/timing.py::device_label``)."""
from __future__ import annotations

import subprocess

import torch


def device_label(device) -> str:
    """The device a number was measured on: the card's name and power limit
    as ``nvidia-smi`` gives them, or the CPU's (whose times are no card's)."""
    if torch.device(device).type != "cuda":
        return "cpu (plain versions; no card)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]
