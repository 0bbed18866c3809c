"""Shared helpers for the batched PyTorch kernels.

Counterpart of ``pyjac_tpu/ops/common.py``.  The port computes in
float64 (the H100 has IEEE f64 in hardware), so there is no
dtype-demotion switch: every packed float table becomes a
``torch.float64`` tensor and every index table a ``torch.int64``
tensor on the requested device.  The one float32 path, ``F32Jacobian``
(``ops/jacobian_f32.py``), keeps its own tables and its own range guard
(1e-30, not :data:`TINY`).
"""

from __future__ import annotations

import math
import weakref
from types import SimpleNamespace

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes

# Guard floor used by the reference generated code for log10 arguments
# (reference: pyjac/core/rate_subs.py:1189-1233 'fmax(..., 1.0e-300)').
TINY = 1.0e-300
LOG10 = math.log(10.0)

F64 = torch.float64

_CACHE = {}


def _tracing() -> bool:
    """Whether a tracer runs the caller: ``torch.export`` or
    ``torch.compile``, or a fake tensor mode, under which new tensors
    carry shapes and no data."""
    return (torch.compiler.is_compiling() or
            torch._guards.detect_fake_mode() is not None)


def cached(packed, key, build):
    """``build()``, cached per (``packed``, ``key``) for as long as
    ``packed`` lives: the cache holds only a weak reference to it, so a
    recycled ``id`` never returns another mechanism's entry and a
    dropped mechanism's tensors are freed with it.  Under a tracer
    (:func:`_tracing`) ``build()`` runs outside its modes: the tensors it
    would make there are fake ones, which a later eager call must not be
    served."""
    k = (id(packed), key)
    hit = _CACHE.get(k)
    if hit is not None and hit[0]() is packed:
        return hit[1]
    if _tracing():
        # build real tensors beside the tracer, which lifts them as
        # constants, as it does a value cached before it started
        with _disable_current_modes():
            val = build()
    else:
        val = build()
    _CACHE[k] = (weakref.ref(packed), val)
    weakref.finalize(packed, _CACHE.pop, k, None)
    return val


def to_device(packed, device) -> SimpleNamespace:
    """Every array field of ``packed`` as a tensor on ``device``.

    Floats become float64, integers int64, booleans bool; cached per
    (packed, device) by :func:`cached`, so repeated calls are free.
    """
    device = torch.device(device)

    def build():
        out = {}
        for name in packed.__dataclass_fields__:
            val = getattr(packed, name)
            if not isinstance(val, np.ndarray):
                continue
            if val.dtype == np.bool_:
                out[name] = torch.as_tensor(val, device=device)
            elif np.issubdtype(val.dtype, np.integer):
                out[name] = torch.as_tensor(val.astype(np.int64),
                                            device=device)
            else:
                out[name] = torch.as_tensor(val.astype(np.float64),
                                            device=device)
        return SimpleNamespace(**out)

    return cached(packed, ('tables', str(device)), build)


def entry_device(device='cuda') -> torch.device:
    """The device of an entry point: the CUDA card unless the caller
    asks for another (``device='cpu'`` runs the kernels' plain
    versions).  Raises when a CUDA device is asked for and none is
    present."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass '
                           "device='cpu' to run on the CPU")
    return device


def as_f64(x, device=None) -> torch.Tensor:
    """``x`` (tensor, array or scalar) as a float64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=F64, device=device if device is not None
                    else x.device)
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def safe_log10(x):
    """log10 clamped away from zero exactly like the reference's
    ``log10(fmax(x, 1e-300))``; the clamp also zeroes the derivative
    below the floor, keeping forward-mode AD NaN-free."""
    return torch.log10(torch.clamp(x, min=TINY))


def safe_log(x):
    return torch.log(torch.clamp(x, min=TINY))


def int_pow(c, nu_int: int):
    """c ** nu for a small static integer nu, as repeated multiplication
    (mirrors the reference's unrolled multiplications,
    rate_subs.py:641-648)."""
    if nu_int == 0:
        return torch.ones_like(c)
    out = c
    for _ in range(nu_int - 1):
        out = out * c
    return out
