"""The FA-2 kernels' share of their roofline over the traced stretch:
the least time of every attention call the stretch's steps make (forward,
dq and dk/dv at the cell's shapes, ``work/fa2.py``), over the device time
of the kernels named ``fa_fwd*_kernel<`` and ``fa_bwd*_kernel<``."""

from portbench.lib.peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S
from portbench.lib.registry import work

PATTERN = r"\bfa_(fwd|bwd)\w*_kernel<"


def read(run):
    t, w = run.trace, run.work.get("fa2")
    if t is None or w is None:
        return None
    secs, n = t.kernel_seconds(PATTERN)
    if n == 0 or secs <= 0:
        return None
    one = work("fa2").bound_s(w["batch"], w["seq"], w["heads"],
                              w["kv_heads"], w["head_dim"], w["head_dim"],
                              BF16_FLOP_PER_S, HBM_BYTES_PER_S)
    return 100.0 * one * w["calls_per_step"] * t.steps / secs
