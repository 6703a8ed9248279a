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


class _FakeLibrary:
    """Stands in for a built library: each entry point the wrapper asks
    for is an object that keeps the ``argtypes`` and ``restype`` set on
    it, recorded by name in ``seen``."""

    def __init__(self, seen):
        self._seen = seen

    def __getattr__(self, name):
        return self._seen.setdefault(name, type(name, (), {})())


def _wrapper_entry_points(monkeypatch):
    """{entry point name: the object its wrapper set argtypes on}, from
    every wrapper's library getter run against a fake library."""
    from repro_torch.kernels.adamw import kernel as aw
    from repro_torch.kernels.quant8 import kernel as q8
    seen = {}
    for mod in (q8, decode, fa, ssd, aw):
        monkeypatch.setattr(mod, "load_library",
                            lambda name: _FakeLibrary(seen))
    q8._launchers.__wrapped__()
    aw._launchers.__wrapped__()
    decode._library.__wrapped__()
    fa._lib.__wrapped__()
    ssd._launcher.__wrapped__()
    return seen


def c_launchers():
    """[(source, name, [kind])] of every ``extern "C"`` function in
    ``csrc/*.cu``: kind ptr, i64, i32 or f32 for each parameter."""
    out = []
    for path in sorted(CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\((.*?)\)\s*\{',
                                       path.read_text(), re.S):
            kinds = []
            for p in " ".join(params.split()).split(","):
                kinds.append("ptr" if "*" in p else
                             "i64" if "long long" in p else
                             "f32" if p.split()[0] == "float" else "i32")
            out.append((path.name, name, kinds))
    return out


LAUNCHERS = c_launchers()


def _ctypes_kind(t):
    if t is ctypes.c_void_p or issubclass(t, ctypes._Pointer):
        return "ptr"
    return _KIND[t]


@pytest.mark.parametrize("source,name,kinds", LAUNCHERS,
                         ids=[n for _, n, _ in LAUNCHERS])
def test_ctypes_argtypes_match_the_c_launcher(source, name, kinds,
                                              monkeypatch):
    """Each C entry point's parameters against the argtypes its wrapper
    sets: a pointer or a 64-bit count passed as a 32-bit int is cut
    without a word, which only the card would show."""
    fn = _wrapper_entry_points(monkeypatch).get(name)
    assert fn is not None, f"no wrapper sets argtypes for {source}::{name}"
    assert [_ctypes_kind(t) for t in fn.argtypes] == kinds
    assert fn.restype is ctypes.c_int


def test_every_c_launcher_is_checked():
    names = [n for _, n, _ in LAUNCHERS]
    assert sorted(names) == sorted(
        ["quant8_quantize_launch", "quant8_dequantize_launch",
         "flash_decode_paged_launch", "fa_fwd_launch", "fa_bwd_dq_launch",
         "fa_bwd_dkdv_launch", "ssd_scan_launch", "adamw_update_launch",
         "adamw_sqsum_launch", "adamw_sqsum_finish_launch"])


def c_reporters():
    """[(source, name)] of every ``extern "C" const char*`` function in
    ``csrc/*.cu``: the reports of the instantiation a library last
    launched, which take no argument."""
    return [(path.name, name) for path in sorted(CSRC.glob("*.cu"))
            for name in re.findall(
                r'extern "C" const char\* (\w+)\(\)\s*\{', path.read_text())]


REPORTERS = c_reporters()


@pytest.mark.parametrize("source,name", REPORTERS,
                         ids=[n for _, n in REPORTERS])
def test_ctypes_reads_each_instantiation_report_as_a_string(
        source, name, monkeypatch):
    """Each report's wrapper takes no argument and reads a C string: a
    pointer read as the default int restype would be cut to 32 bits."""
    fn = _wrapper_entry_points(monkeypatch).get(name)
    assert fn is not None, f"no wrapper sets restype for {source}::{name}"
    assert fn.argtypes == [] and fn.restype is ctypes.c_char_p


def test_every_library_with_a_kernel_of_two_instantiations_reports():
    """The FA-2 and flash-decode libraries, whose launchers pick one of
    several instantiations, each report the one they launched."""
    assert sorted(REPORTERS) == [
        ("flash_attn_bwd.cu", "fa_bwd_last_kernel"),
        ("flash_attn_fwd.cu", "fa_fwd_last_kernel"),
        ("flash_decode.cu", "flash_decode_last_kernel")]
