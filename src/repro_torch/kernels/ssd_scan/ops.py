"""Public SSD scan in model layout (port of ``repro.kernels.ssd_scan.ops``).

The JAX wrapper padded s to a multiple of the chunk and transposed every
operand to (b, h, s, ·), two copies of each.  Here the kernel reads the
(b, s, h, ·) tensors through transposed views and handles the ragged last
chunk itself, so :func:`ssd` makes no copy and has no fallback: on the
card it is the kernel, on the CPU its plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_bhcq


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk_size: int) -> torch.Tensor:
    """SSD scan, model layout.  x: (b,s,h,p); dt: (b,s,h) fp32; A: (h,)
    fp32; B/C: (b,s,g,n) -> y (b,s,h,p) in x's dtype."""
    y = ssd_bhcq(x.transpose(1, 2), dt.transpose(1, 2), A,
                 B.transpose(1, 2), C.transpose(1, 2), chunk=chunk_size)
    return y.transpose(1, 2)
