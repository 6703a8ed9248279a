"""AdamW's clipping norm and fused update: the CUDA kernels' wrappers.

No TPU kernel is replaced: the JAX package's AdamW is plain ``jnp`` that
XLA fuses.  Run eagerly in PyTorch, the same update is some twenty
elementwise kernels a leaf (``ref.py``); the hand-written sm_90a kernels
in ``csrc/adamw.cu`` (see the note at its top) move only what it needs:

* :func:`square_sums` -> Σ x² of each leaf, one launch a leaf and one
  that adds each leaf's partial sums in a fixed order;
* :func:`adamw_update` -> one leaf's step in place, one launch.

Each wrapper launches its kernel for CUDA tensors (and counts the launch
in its ``.launches``), runs the plain version in ``ref.py`` for CPU
tensors, and raises for anything else: a ``meta`` or fake tensor, and a
card tensor the kernel cannot read (:func:`takes`, :func:`update_takes`)
rather than giving way to the plain version on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List

import torch

from repro_torch.kernels.adamw import ref
from repro_torch.kernels.build import c_args, load_library, refuse_abstract

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# partial sums a leaf: fixed, so a leaf's sum is taken in an order that
# depends on its length alone; 1024 blocks of 256 threads fill the card
NORM_BLOCKS = 1024


def takes(t: torch.Tensor) -> bool:
    """Whether the kernels read ``t``: a plain CUDA tensor (not a fake,
    ``meta`` or DTensor), contiguous, on 16 bytes, fp32 or bf16."""
    return (t.device.type == "cuda"
            and type(t) in (torch.Tensor, torch.nn.Parameter)
            and t.dtype in _DTYPES and t.is_contiguous()
            and t.data_ptr() % 16 == 0)


def update_takes(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                 nu: torch.Tensor, *scalars: torch.Tensor) -> bool:
    """Whether :func:`adamw_update` launches its kernel for this leaf:
    p, g, mu and nu of one length on one card, each :func:`takes`, the
    moments of one dtype, and every scalar (lr, clip, bc1, bc2) one fp32
    element on the same card."""
    return (all(takes(t) for t in (p, g, mu, nu))
            and g.device == mu.device == nu.device == p.device
            and g.numel() == mu.numel() == nu.numel() == p.numel()
            and mu.dtype == nu.dtype
            and all(type(s) is torch.Tensor and s.device == p.device
                    and s.dtype == torch.float32 and s.numel() == 1
                    for s in scalars))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def square_sums(xs: List[torch.Tensor]) -> torch.Tensor:
    """(len(xs),) fp32: Σ x² of each tensor, each summed in fp32 in an
    order fixed by its length (two calls give the same bits).  Every
    tensor on one card must be one :func:`takes`; CPU tensors take the
    plain sum."""
    for x in xs:
        refuse_abstract(x, "the AdamW norm kernel",
                        "adamw.ref.square_sum_reference")
    if xs and all(x.device.type == "cpu" for x in xs):
        return torch.stack([ref.square_sum_reference(x) for x in xs])
    if not xs:
        raise ValueError("square_sums: no tensors")
    dev = xs[0].device
    bad = [i for i, x in enumerate(xs) if x.device != dev or not takes(x)]
    if bad:
        raise ValueError(f"square_sums: tensors {bad} are not contiguous "
                         f"fp32/bf16 CUDA tensors on 16 bytes on {dev}")
    partial = torch.empty(len(xs), NORM_BLOCKS, dtype=torch.float32,
                          device=dev)
    out = torch.empty(len(xs), dtype=torch.float32, device=dev)
    leaf, finish = _launchers()[:2]
    stream = _stream(xs[0])
    for i, x in enumerate(xs):
        _raise_on(leaf(x.data_ptr(), x.numel(), _DTYPES[x.dtype],
                       partial[i].data_ptr(), NORM_BLOCKS, stream),
                  "square_sums")
        square_sums.launches += 1
    _raise_on(finish(partial.data_ptr(), NORM_BLOCKS, len(xs),
                     out.data_ptr(), stream), "square_sums")
    return out


def adamw_update(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                 nu: torch.Tensor, *, lr: torch.Tensor, clip: torch.Tensor,
                 bc1: torch.Tensor, bc2: torch.Tensor, b1: float, b2: float,
                 eps: float, weight_decay: float, decay: bool) -> None:
    """One leaf's AdamW step, in place on ``p``, ``mu`` and ``nu``, the
    plain loop's math bit for bit (``ref.adamw_update_reference``).
    ``lr``, ``clip``, ``bc1`` and ``bc2`` are 0-d fp32 tensors on the
    leaf's device, read by the kernel (the host never waits for them)."""
    refuse_abstract(p, "the AdamW update kernel",
                    "adamw.ref.adamw_update_reference")
    hyper = dict(lr=lr, clip=clip, bc1=bc1, bc2=bc2, b1=b1, b2=b2, eps=eps,
                 weight_decay=weight_decay, decay=decay)
    if p.device.type == "cpu":
        return ref.adamw_update_reference(p, g, mu, nu, **hyper)
    if not update_takes(p, g, mu, nu, lr, clip, bc1, bc2):
        raise ValueError(
            "adamw_update: p, g, mu, nu must be contiguous fp32/bf16 CUDA "
            "tensors of one length on 16 bytes (moments of one dtype), and "
            "lr, clip, bc1, bc2 one fp32 element each on the same card; "
            f"got {[(t.dtype, t.shape, t.stride()) for t in (p, g, mu, nu)]}"
            f" and {[(s.dtype, s.device) for s in (lr, clip, bc1, bc2)]}")
    _raise_on(_launchers()[2](
        p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), p.numel(),
        lr.data_ptr(), clip.data_ptr(), bc1.data_ptr(), bc2.data_ptr(),
        b1, 1 - b1, b2, 1 - b2, eps, weight_decay, int(decay),
        _DTYPES[p.dtype], _DTYPES[g.dtype], _DTYPES[mu.dtype], _stream(p)),
        "adamw_update")
    adamw_update.launches += 1


square_sums.launches = 0
adamw_update.launches = 0


@functools.lru_cache(maxsize=None)
def _launchers():
    """The C entry points of ``csrc/adamw.cu``, built on first use."""
    lib = load_library("adamw")
    leaf, finish = lib.adamw_sqsum_launch, lib.adamw_sqsum_finish_launch
    update = lib.adamw_update_launch
    leaf.argtypes = c_args("plipip")
    finish.argtypes = c_args("piipp")
    update.argtypes = c_args("pppplppppffffffiiiip")
    leaf.restype = finish.restype = update.restype = ctypes.c_int
    return leaf, finish, update
