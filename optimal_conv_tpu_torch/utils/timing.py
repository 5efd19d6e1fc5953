"""Timing on the card with CUDA events.

``cuda_ms`` warms up, then records one event pair around `iters` calls
and divides by the count.  ``cuda_ms_cold`` times each call on its own,
after a write that pushes the call's data out of the L2 cache.  Both
refuse to run without a CUDA device: a time measured on the CPU is not
a device time.
"""

from __future__ import annotations

import torch


def _require_cuda(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"timing needs a CUDA device, got {dev}")
    return dev


def cuda_ms(fn, device="cuda", iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of fn() over `iters` back-to-back calls."""
    dev = _require_cuda(device)
    with torch.cuda.device(dev):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters


def cuda_ms_cold(fn, device="cuda", iters: int = 20, warmup: int = 3,
                 flush_bytes: int = 1 << 29) -> float:
    """Mean device milliseconds of fn() with a cold L2: before each timed
    call a `flush_bytes` buffer (ten times the H100's 50 MB L2) is
    overwritten.  The overwrite also keeps the device busy while the host
    enqueues fn(), so the event pair brackets device work, not enqueue
    gaps."""
    dev = _require_cuda(device)
    with torch.cuda.device(dev):
        flush = torch.empty(flush_bytes, dtype=torch.uint8, device=dev)
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize(dev)
        return sum(s.elapsed_time(e) for s, e in pairs) / iters
