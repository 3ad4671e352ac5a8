"""Device helpers shared by the drivers."""
from __future__ import annotations

import torch


def on_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if on_cuda(device):
        torch.cuda.synchronize()


def reset_peak(device) -> None:
    if on_cuda(device):
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated() if on_cuda(device) else 0


def free(device) -> None:
    if on_cuda(device):
        torch.cuda.empty_cache()
