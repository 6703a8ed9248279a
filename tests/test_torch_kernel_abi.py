"""The ctypes mirrors of the CUDA kernels' parameter structs against the
structs in ``src/repro_torch/csrc``: the same members in the same order,
pointers as pointers, 64-bit integers as 64-bit integers.  A mirror that
drifts from its struct makes every launch read the wrong fields, which
only the card would show."""

import ctypes
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.build import CSRC  # noqa: E402
from repro_torch.kernels.flash_attention import decode  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd  # noqa: E402

_KIND = {ctypes.c_void_p: "ptr", ctypes.c_longlong: "i64",
         ctypes.c_int: "i32", ctypes.c_float: "f32"}


def c_members(source: str, namespace: str, struct: str = "Params"):
    """[(name, kind)] of ``namespace::struct``'s members, in order: kind
    ptr, i64, i32, f32 or the name of a member struct."""
    text = (CSRC / source).read_text()
    body = re.search(r"namespace %s \{.*?struct %s \{(.*?)\n\};"
                     % (namespace, struct), text, re.S).group(1)
    members = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip()
        if not decl:
            continue
        ctype, names = re.match(
            r"((?:const )?(?:long long|[\w:]+)\s*\*?)\s*(.*);",
            decl).groups()
        base = ctype.replace("const", "").strip()
        kind = ("ptr" if "*" in ctype else
                "i64" if "long long" in decl else
                {"float": "f32", "int": "i32"}.get(base, base))
        for name in names.split(","):
            name = name.strip().lstrip("*")
            if name:
                members.append((name, kind))
    return members


@pytest.mark.parametrize("source,namespace,mirror", [
    ("ssd_scan.cu", "ssd", ssd._Params),
    ("flash_decode.cu", "fd", decode._DecodeParams),
    ("flash_attn.cuh", "fa", fa._Params),
], ids=["ssd_scan", "flash_decode", "flash_attn"])
def test_ctypes_mirror_matches_the_struct(source, namespace, mirror):
    want = c_members(source, namespace)
    got = [(name, _KIND.get(kind, kind.__name__.lstrip("_")))
           for name, kind in mirror._fields_]
    assert got == want
