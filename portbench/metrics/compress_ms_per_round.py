"""Device milliseconds a local-SGD round spends compressing its
pseudo-gradients: the program's ``compress`` device phases around each
leaf's ``optim/compress.py::compress_leaf`` (int8 with error feedback),
summed within each ``round``, median over the window's rounds
(``lib/spans.py``)."""

from portbench.lib import spans

spans.install()


def read(run):
    return spans.median_ms(run, "compress", ("round",))
