"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the one given, else CUDA.

    Never falls back to the CPU: with no device given and no CUDA present this
    raises, so a run that was meant for the card cannot quietly run elsewhere.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available and no device was given; pass device='cpu' "
            "explicitly to run on the CPU"
        )
    return torch.device("cuda")


class HostPool:
    """One block of host memory, carved into tensors by `take`, for state
    that streams to and from `device` (offloaded optimizer moments,
    streamed gradients).

    On CUDA the block is page-locked with cudaHostRegister, so copies to and
    from the card are asynchronous DMA; if that fails it raises (nothing
    falls back to pageable memory). PyTorch's pinned allocator is not used:
    it rounds every allocation up to a power of two, which at tens of GB of
    moments wastes a third of the host. On the CPU the block is ordinary
    memory. Each tensor `take` gives has a storage of its own over its bytes
    (so `torch.save` writes it as any other tensor); all are zeroed."""

    ALIGN = 4096

    def __init__(self, nbytes: int, device: Union[str, torch.device]):
        self.device = torch.device(device)
        self.nbytes = int(nbytes)
        base = np.zeros(self.nbytes + self.ALIGN, dtype=np.uint8)
        start = (-base.ctypes.data) % self.ALIGN
        self.buffer = base[start:start + self.nbytes]
        self._registered = False
        if self.device.type == "cuda" and self.nbytes:
            err = torch.cuda.cudart().cudaHostRegister(self.buffer.ctypes.data, self.nbytes, 0)
            if int(getattr(err, "value", err)) != 0:
                raise RuntimeError(f"cudaHostRegister of {self.nbytes} bytes failed: {err}")
            self._registered = True
        self._used = 0

    @staticmethod
    def size_of(shape, dtype: torch.dtype) -> int:
        """The bytes `take` uses for a tensor (rounded up to 256)."""
        n = math.prod(int(d) for d in shape) * torch.empty((), dtype=dtype).element_size()
        return -(-n // 256) * 256

    def take(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """A zeroed tensor of `shape` and `dtype` in the pool."""
        size = self.size_of(shape, dtype)
        if self._used + size > self.nbytes:
            raise RuntimeError(f"host pool of {self.nbytes} bytes is full")
        n = math.prod(int(d) for d in shape)
        out = torch.frombuffer(self.buffer, dtype=dtype, count=n, offset=self._used).view(tuple(shape))
        if self._registered and not out.is_pinned():
            raise RuntimeError("host pool tensor is not page-locked after cudaHostRegister")
        self._used += size
        return out

    def __del__(self):
        if self._registered:
            # no copy still queued on any stream may read or write the block
            torch.cuda.synchronize(self.device)
            torch.cuda.cudart().cudaHostUnregister(self.buffer.ctypes.data)
            self._registered = False
