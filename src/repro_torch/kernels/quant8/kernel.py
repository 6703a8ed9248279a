"""Blockwise symmetric int8 quantize / dequantize: the CUDA kernels'
wrappers (port of ``repro.kernels.quant8.kernel``).

The two Pallas TPU kernels become hand-written sm_90a kernels in
``csrc/quant8.cu`` (see the note at its top):

* ``_quant_kernel``   -> :func:`quantize_blocks` -> (int8 q, fp32 scales);
* ``_dequant_kernel`` -> :func:`dequantize_blocks` -> values.

Each wrapper launches its kernel for a CUDA tensor (and counts the launch
in its ``.launches``), runs the plain version in ``ref.py`` for a CPU
tensor, and raises for anything else.  Unlike the TPU function, which
asserted ``N % block == 0`` and a row count its 256-row tile divides,
:func:`quantize_blocks` takes any N: the ragged tail of the last row is
read as 0 (inside the kernel on the card), and q comes back with the
padded length ``rows * block``, as the JAX function returned it after
its caller padded.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as Fn

from repro_torch.kernels.build import c_args, load_library, refuse_abstract
from repro_torch.kernels.quant8 import ref

BLOCKS = (128, 256, 512)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_cuda(t: torch.Tensor, name: str, block: int) -> None:
    _check(t.device.type == "cuda", name,
           f"tensor on {t.device}, not CUDA/CPU")
    _check(block in BLOCKS, name, f"block {block} not in {BLOCKS}")
    _check(t.dim() == 1 and t.is_contiguous(), name,
           "expects a contiguous 1-D tensor")
    _check(t.data_ptr() % 16 == 0, name, "data must be 16-byte aligned")


def quantize_blocks(x: torch.Tensor, *, block: int = 256
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (N,) fp32 or bf16 -> (int8 q (rows*block,), fp32 scales
    (rows,)), rows = ceil(N / block); the tail past N counts as 0."""
    n = x.shape[0]
    rows = -(-n // block)
    refuse_abstract(x, "the int8 quantize kernel",
                    "quant8.ref.quantize_reference")
    if x.device.type == "cpu":
        return ref.quantize_reference(Fn.pad(x, (0, rows * block - n)),
                                      block)
    _check_cuda(x, "quantize_blocks", block)
    _check(x.dtype in _DTYPES, "quantize_blocks",
           f"dtype {x.dtype} not in {tuple(_DTYPES)}")
    q = torch.empty(rows * block, dtype=torch.int8, device=x.device)
    s = torch.empty(rows, dtype=torch.float32, device=x.device)
    err = _launchers()[0](x.data_ptr(), q.data_ptr(), s.data_ptr(), n, rows,
                          block, _DTYPES[x.dtype],
                          torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_blocks: CUDA launch failed with "
                           f"error {err}")
    quantize_blocks.launches += 1
    return q, s


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor, *,
                      block: int = 256, dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """q: (rows*block,) int8, scale: (rows,) fp32 -> (rows*block,)
    values in ``dtype`` (fp32 or bf16 on the card)."""
    refuse_abstract(q, "the int8 dequantize kernel",
                    "quant8.ref.dequantize_reference")
    if q.device.type == "cpu":
        return ref.dequantize_reference(q, scale, block, dtype)
    _check_cuda(q, "dequantize_blocks", block)
    rows = q.shape[0] // block
    _check(q.dtype == torch.int8 and q.shape[0] == rows * block,
           "dequantize_blocks", f"q must be int8 of a multiple of {block}")
    _check(scale.device == q.device and scale.dtype == torch.float32
           and scale.shape == (rows,) and scale.is_contiguous(),
           "dequantize_blocks", f"scale must be ({rows},) float32 on "
           f"{q.device}")
    _check(dtype in _DTYPES, "dequantize_blocks",
           f"dtype {dtype} not in {tuple(_DTYPES)}")
    out = torch.empty(rows * block, dtype=dtype, device=q.device)
    err = _launchers()[1](q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                          rows, block, _DTYPES[dtype],
                          torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dequantize_blocks: CUDA launch failed with "
                           f"error {err}")
    dequantize_blocks.launches += 1
    return out


quantize_blocks.launches = 0
dequantize_blocks.launches = 0


@functools.lru_cache(maxsize=None)
def _launchers():
    """The C entry points of ``csrc/quant8.cu``, built on first use."""
    lib = load_library("quant8")
    quant, dequant = lib.quant8_quantize_launch, lib.quant8_dequantize_launch
    quant.argtypes = c_args("ppplliip")
    dequant.argtypes = c_args("pppliip")
    quant.restype = dequant.restype = ctypes.c_int
    return quant, dequant
