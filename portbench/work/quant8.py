"""Bytes of the int8 kernels on a leaf of ``n`` elements (a frozen copy
of the port's count): quantize reads the fp32 input and writes the codes
(``rows * block``) and one fp32 scale a row; dequantize reads them and
writes ``rows * block`` fp32 values."""

from __future__ import annotations


def rows(n: int, block: int) -> int:
    return -(-n // block)


def quantize_bytes(n: int, block: int, in_elem: int = 4) -> int:
    r = rows(n, block)
    return n * in_elem + r * block + r * 4


def dequantize_bytes(n: int, block: int, out_elem: int = 4) -> int:
    r = rows(n, block)
    return r * block + r * 4 + r * block * out_elem
