"""Hand-written Hopper kernels of the port, one package per TPU kernel:
``<name>/ref.py`` is the plain PyTorch version, ``<name>/ops.py`` the
wrapper that runs the plain version on CPU tensors and the CUDA kernel
(``csrc/<name>.cu``, built by ``kernels/build.py``) on CUDA tensors."""
from __future__ import annotations

import torch

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (plain path); False when
    every one lies on one CUDA device (kernel path).  Anything else is
    refused."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return _DTYPE_CODES[t.dtype]


def require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def lane_ints(x, b: int, device) -> torch.Tensor:
    """A (B,) int32 contiguous tensor on ``device`` (zeros for None)."""
    if x is None:
        return torch.zeros((b,), dtype=torch.int32, device=device)
    require(tuple(x.shape) == (b,), f"expected ({b},) per-lane ints, got "
            f"{tuple(x.shape)}")
    return x.to(device=device, dtype=torch.int32).contiguous()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
