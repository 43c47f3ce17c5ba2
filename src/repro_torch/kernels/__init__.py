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


def check_pools(q, k_pool, v_pool, tbl) -> torch.Tensor:
    """Shape checks of a paged kernel's arguments: q (B, T, Hq, D),
    k/v_pool (NP + 1, P, Hk, D) page pools (not a layer-stacked leaf, not
    a dense cache with its lane axis), tbl (B, n_tbl) page ids.  Returns
    the table as contiguous int32."""
    b, _, hq, d = q.shape
    require(k_pool.dim() == 4 and k_pool.shape == v_pool.shape
            and k_pool.shape[3] == d and k_pool.shape[0] >= 2,
            f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} are not "
            f"(NP + 1, P, Hk, {d}) page pools")
    require(tbl.dim() == 2 and tbl.shape[0] == b and tbl.shape[1] >= 1
            and not tbl.is_floating_point(),
            f"block table {tuple(tbl.shape)} {tbl.dtype} is not ({b}, n_tbl) "
            "page ids")
    hk = k_pool.shape[2]
    require(hq % hk == 0 and d in HEAD_DIMS,
            f"heads {hq}/{hk}, head_dim {d} not supported")
    require(q.dtype == k_pool.dtype == v_pool.dtype, "q/pool dtypes differ")
    require(all(x.is_contiguous() for x in (q, k_pool, v_pool)),
            "q and the pools must be contiguous")
    require(all(x.data_ptr() % 16 == 0 for x in (q, k_pool, v_pool)),
            "q and the pools must be 16-byte aligned (the kernel loads "
            "16-byte vectors)")
    return tbl.to(torch.int32).contiguous()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
