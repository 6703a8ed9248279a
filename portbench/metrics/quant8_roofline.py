"""The int8 kernels' share of their roofline over the traced stretch: the
bytes that quantizing and dequantizing every leaf of every replica's
pseudo-gradient needs (``work/quant8.py``), at the card's bandwidth, over
the device time of ``quant8_quantize_kernel`` and ``quant8_dequantize_kernel``."""

from portbench.lib.peaks import HBM_BYTES_PER_S
from portbench.lib.registry import work

PATTERN = r"\bquant8_(quantize|dequantize)_kernel\b"


def read(run):
    t, w = run.trace, run.work.get("quant8")
    if t is None or w is None or not t.rounds:
        return None
    secs, n = t.kernel_seconds(PATTERN)
    if n == 0 or secs <= 0:
        return None
    q = work("quant8")
    b = w["block"]
    per_round = sum(q.quantize_bytes(x, b) + q.dequantize_bytes(x, b)
                    for x in w["elements_per_round"])
    return 100.0 * per_round * t.rounds / HBM_BYTES_PER_S / secs
