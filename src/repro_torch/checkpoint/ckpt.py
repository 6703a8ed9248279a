"""Pure-numpy elastic sharded checkpoints (port of
``repro.checkpoint.ckpt``).

The on-disk format is the JAX package's, so either package restores what
the other wrote, bit for bit.  Under ``<dir>/step_<N>/`` every leaf is one
or more ``.npy`` files plus per-writer json manifests that list every
leaf's key (the ``jax.tree_util.keystr`` path, as ``bridge.keystr`` builds
it) and every data file's CRC32.  bfloat16 leaves are stored as their
uint16 bit patterns and viewed back on restore.  Two shard layouts:

* ``leaf_modulo`` (:func:`save`): leaf ``i`` belongs to shard
  ``i % num_shards`` and is saved whole.  Placement-blind; the
  single-host trainers' default.
* ``layer_sliced`` (:func:`save_sharded`, :func:`save_for_placement`),
  driven by a :class:`~repro_torch.checkpoint.spec.CheckpointSpec`
  derived from the executing
  :class:`~repro_torch.core.placement.PlacementSpec`: each stage shard
  saves its contiguous layer-range slice of every stacked decoder leaf
  (file ``<leaf>.L<a>-<b>.npy`` holds ``leaf[a:b]``), non-layer leaves
  are distributed round-robin, and ``replication`` makes each writer
  also persist its upstream neighbours' shards (§5 partial proactive
  replication).  Slice files are named by *layer range*, not by writer,
  so :func:`restore_for_placement` re-slices the stacked layer arrays
  across *different* stage boundaries and :func:`reshard` rewrites a
  checkpoint under another placement: 3 stages → 2 → 3 is bit-identical.

:func:`restore` validates completeness against the manifest before
touching any array (one :class:`IncompleteCheckpointError` names every
missing file); reads are CRC-checked and retried per
:class:`RestorePolicy`, and persistent failures aggregate into one
:class:`ShardReadError`.  **Self-healing:** :func:`damaged_files` audits
a step (missing or CRC-failing files), and :func:`heal_step` — or
``restore(..., sources=...)`` — re-fetches each damaged file from the
first neighbour holder whose copy checksums clean, with a per-source
wall-clock budget so one dead holder cannot stall the heal; the fetched
bytes are priced by :func:`repro_torch.checkpoint.elastic.heal_cost`.
:func:`prune` keeps the newest complete steps and never deletes a newer
in-flight one.  Restored tensors land on the prototype's device.

**Under a ``(data, model)`` mesh** (``act_sharding.use_mesh``, every rank
of it calling) the leaves may be DTensors.  :func:`save` then writes one
leaf-modulo shard a rank (``num_shards`` the rank count, ``shard_id`` the
rank): leaf by leaf, every rank takes part in gathering it and only the
leaf's writer keeps it, so no rank holds the whole tree.  Rank 0 writes
the layer-sliced layout, gathering likewise, and prunes, after a
barrier.  :func:`restore` into DTensor prototypes reads each leaf file
mapped and keeps the rank's own block.  The files are the single-device
format, so a checkpoint moves between mesh shapes and to one process.
"""

from __future__ import annotations

import io
import json
import mmap
import shutil
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.bridge import flatten
from repro_torch.checkpoint.spec import CheckpointSpec
from repro_torch.distributed.act_sharding import (current_mesh, is_sharded,
                                                  mesh_rank)
from repro_torch.models.params import tree_unflatten
from repro_torch.obs.trace import get_tracer

PyTree = Any

LAYOUT_LEAF_MODULO = "leaf_modulo"
LAYOUT_LAYER_SLICED = "layer_sliced"


class IncompleteCheckpointError(FileNotFoundError):
    """A restore/validation found manifest-expected files missing."""


class ShardReadError(IncompleteCheckpointError):
    """Shard files present but unreadable (corrupt or persistent I/O
    failure) after retries and healing; names every bad shard."""


class ShardChecksumError(ValueError):
    """A shard file's bytes do not match its manifest CRC32."""


@dataclass(frozen=True)
class RestorePolicy:
    """Retry/heal discipline for shard reads: ``retries`` transient-I/O
    retries per file with exponential backoff from ``backoff_s``.
    Checksum mismatches are not retried locally (bit-rot is
    deterministic) — they go to the heal path, where each source gets at
    most ``source_timeout_s`` of cumulative wall clock before it is
    skipped for the remaining files."""
    retries: int = 2
    backoff_s: float = 0.05
    source_timeout_s: float = 5.0
    verify_checksums: bool = True


@dataclass
class HealReport:
    """What a self-healing restore actually did."""
    healed: List[Dict[str, Any]] = field(default_factory=list)
    # each: {file, reason: missing|corrupt, source, bytes}
    unrecovered: List[str] = field(default_factory=list)
    bytes_fetched: int = 0
    per_source_bytes: Dict[str, int] = field(default_factory=dict)
    retried_reads: int = 0
    sources_timed_out: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.unrecovered


_DEFAULT_POLICY = RestorePolicy()


def _escape(path_str: str) -> str:
    return path_str.replace("/", "_").replace("'", "").replace("[", "(") \
        .replace("]", ")")


def _slice_name(key: str, a: int, b: int) -> str:
    return f"{_escape(key)}.L{a:05d}-{b:05d}.npy"


def _leaf_name(key: str) -> str:
    return _escape(key) + ".npy"


def _whole_on(leaf, writer: int):
    """A DTensor ``leaf`` whole on the ``writer`` rank, None on the others
    (every rank of its mesh calls).  Over the ``host`` transport the
    ranks' blocks meet in host memory on the writer alone
    (``runtime.HostSlots.gather``); else DTensor gathers it on every
    rank."""
    from torch.distributed.tensor import Shard
    from repro_torch.distributed import runtime
    from repro_torch.distributed.sharding import local_index
    mesh, place = leaf.device_mesh, leaf.placements
    ways: Dict[int, int] = {}
    for p, n in zip(place, mesh.shape):
        if isinstance(p, Shard):
            ways[p.dim] = ways.get(p.dim, 1) * n
    coll = runtime.collectives()
    if coll is None or coll.slots is None or any(
            leaf.shape[d] % n for d, n in ways.items()):
        full = leaf.full_tensor()
        return full if mesh_rank()[0] == writer else None
    parts = coll.slots.gather(leaf.to_local().detach(), writer)
    if parts is None:
        return None
    full = torch.empty(leaf.shape, dtype=leaf.dtype)
    ranks = mesh.mesh.reshape(-1).tolist()
    for rank, part in enumerate(parts):
        at = np.unravel_index(ranks.index(rank), tuple(mesh.shape))
        full[local_index(tuple(leaf.shape), mesh, place, at)] = part
    return full


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            # numpy has no bfloat16: store the bit pattern as uint16, as
            # the JAX package does
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _save_array(path: Path, leaf) -> int:
    """Write one ``.npy``; returns the CRC32 of the bytes written."""
    buf = io.BytesIO()
    np.save(buf, _to_numpy(leaf))
    data = buf.getbuffer()                # the bytes, without a copy
    path.write_bytes(data)
    return zlib.crc32(data)


def _read_bytes_retry(path: Path, policy: RestorePolicy,
                      report: Optional[HealReport] = None) -> bytes:
    """Read raw bytes, retrying transient I/O errors with exponential
    backoff; a missing file raises at once."""
    delay = policy.backoff_s
    for attempt in range(policy.retries + 1):
        try:
            return path.read_bytes()
        except FileNotFoundError:
            raise
        except OSError:
            if attempt == policy.retries:
                raise
            if report is not None:
                report.retried_reads += 1
            time.sleep(delay)
            delay *= 2


def _load_array(path: Path, *, crc: Optional[int],
                policy: RestorePolicy,
                report: Optional[HealReport] = None,
                mapped: bool = False) -> np.ndarray:
    """One ``.npy``, CRC-checked; ``mapped`` leaves it mapped (a rank
    reads only its block's pages after the checksum pass)."""
    if mapped:
        try:
            with open(path, "rb") as f, \
                    mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
                ok = crc is None or not policy.verify_checksums \
                    or zlib.crc32(m) == crc
        except ValueError as e:               # an empty file maps nothing
            raise ShardChecksumError(f"{path.name}: {e}") from e
    else:
        data = _read_bytes_retry(path, policy, report)
        ok = crc is None or not policy.verify_checksums \
            or zlib.crc32(data) == crc
    if not ok:
        raise ShardChecksumError(
            f"{path.name}: CRC32 mismatch against manifest (bit-rot or "
            "partial write)")
    try:
        if mapped:
            return np.load(path, mmap_mode="r", allow_pickle=False)
        return np.load(io.BytesIO(data), allow_pickle=False)
    except ValueError as e:
        raise ShardChecksumError(f"{path.name}: unparseable npy "
                                 f"({e})") from e


def _to_tensor(arr: np.ndarray, proto: torch.Tensor,
               shape: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """The stored array as a tensor of ``proto``'s dtype and device, of
    ``proto``'s shape or ``shape`` (a stage's crop of a layer leaf); for
    a DTensor ``proto``, the rank's block of it placed as ``proto``."""
    want = tuple(proto.shape) if shape is None else tuple(shape)
    if tuple(arr.shape) != want:
        raise ValueError(f"stored shape {tuple(arr.shape)} != {want}")
    if is_sharded(proto):
        from torch.distributed.tensor import DTensor
        from repro_torch.distributed.sharding import local_index
        local = _to_tensor(arr[local_index(want, proto.device_mesh,
                                           proto.placements)],
                           proto.to_local(), tuple(proto.to_local().shape))
        return DTensor.from_local(local, proto.device_mesh,
                                  proto.placements, run_check=False,
                                  shape=proto.shape, stride=proto.stride())
    if proto.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C"))
    return t.to(device=proto.device, dtype=proto.dtype)


# --------------------------------------------------------------------------- #
# Saving
# --------------------------------------------------------------------------- #

def _step_dir(directory: Union[str, Path], step: int) -> Path:
    return Path(directory) / f"step_{step:08d}"


def save(directory: Union[str, Path], step: int, tree: PyTree, *,
         num_shards: Optional[int] = None,
         shard_id: Optional[int] = None) -> Path:
    """Write (a leaf-modulo shard of) a checkpoint; returns the step dir.
    ``num_shards`` and ``shard_id`` default to the ambient mesh's rank
    count and rank (1 and 0 with none)."""
    shard_id = mesh_rank()[0] if shard_id is None else shard_id
    num_shards = mesh_rank()[1] if num_shards is None else num_shards
    d = _step_dir(directory, step)
    d.mkdir(parents=True, exist_ok=True)
    flat = list(flatten(tree))
    checksums: Dict[str, int] = {}
    manifest = {"step": step, "layout": LAYOUT_LEAF_MODULO,
                "num_leaves": len(flat), "num_shards": num_shards,
                "shard_id": shard_id, "keys": [k for k, _ in flat],
                "checksums": checksums}
    mine = []
    for i, (key, leaf) in enumerate(flat):
        if is_sharded(leaf):
            # every rank takes part in the gather; only the writer keeps it
            leaf = _whole_on(leaf, i % num_shards)
        if i % num_shards == shard_id:
            mine.append((key, leaf))
    # written after the gathers, so that a mesh's writers write at once
    for key, leaf in mine:
        name = _leaf_name(key)
        checksums[name] = _save_array(d / name, leaf)
    (d / f"manifest_{shard_id}.json").write_text(json.dumps(manifest))
    return d


def _is_layer_leaf(key: str, leaf, num_layers: int) -> bool:
    """Stacked decoder leaf: it sits under ``decoder`` and its leading
    dim is the layer stack (the JAX package's contract, for uniform dense
    decoder stacks).  Everything else (embeddings, lm head, norms,
    optimizer scalars) is placement-independent and saved whole."""
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
    return ("decoder" in key and len(shape) >= 1
            and shape[0] == num_layers and num_layers > 1)


def _save_shard(d: Path, step: int, flat: List[Tuple[str, Any]],
                spec: CheckpointSpec, shard_id: int,
                written: Optional[Dict[str, int]] = None) -> None:
    """Write writer ``shard_id``'s files of a layer-sliced step from the
    flat ``(key, leaf)`` list, and its manifest.  ``written`` maps the
    files another writer of the same directory already wrote (a
    neighbour's copy has the same name and bytes) to their CRC32: those
    are listed, not written again."""
    written = {} if written is None else written
    checksums: Dict[str, int] = {}

    def put(name: str, leaf) -> None:
        if name not in written:
            written[name] = _save_array(d / name, leaf)
        checksums[name] = written[name]

    keys = [k for k, _ in flat]
    layer_keys = [k for k, leaf in flat
                  if _is_layer_leaf(k, leaf, spec.num_layers)]
    layer_set = set(layer_keys)
    held = set(spec.held_shards(shard_id))
    slices = spec.slices()
    nonlayer_i = 0
    for key, leaf in flat:
        if key in layer_set:
            for s in held:
                a, b = slices[s]
                put(_slice_name(key, a, b), leaf[a:b])
        else:
            if nonlayer_i % spec.num_shards in held:
                put(_leaf_name(key), leaf)
            nonlayer_i += 1
    manifest = {"step": step, "layout": LAYOUT_LAYER_SLICED,
                "num_leaves": len(flat), "num_shards": spec.num_shards,
                "shard_id": shard_id, "keys": keys,
                "layer_keys": layer_keys,
                "num_layers": spec.num_layers,
                "boundaries": list(spec.boundaries),
                "replication": spec.replication,
                "holders": [list(h) for h in spec.holders],
                "checksums": checksums}
    (d / f"manifest_{shard_id}.json").write_text(json.dumps(manifest))


def save_sharded(directory: Union[str, Path], step: int, tree: PyTree,
                 spec: CheckpointSpec, shard_id: int) -> Path:
    """Write stage-shard ``shard_id`` of a layer-sliced checkpoint: the
    writer persists its own layer-range slices plus (per
    ``spec.replication``) its upstream neighbours' — slice files are
    named by layer range, so neighbour copies land on the same paths and
    the union stays complete even if one writer never finishes."""
    if not 0 <= shard_id < spec.num_shards:
        raise ValueError(f"shard_id={shard_id} outside "
                         f"0..{spec.num_shards - 1}")
    d = _step_dir(directory, step)
    d.mkdir(parents=True, exist_ok=True)
    _save_shard(d, step, list(flatten(tree)), spec, shard_id)
    return d


def _as_ckpt_spec(spec, replication: int = 0) -> CheckpointSpec:
    if isinstance(spec, CheckpointSpec):
        if replication and replication != spec.replication:
            # an explicit nonzero replication= wins over the spec's
            return CheckpointSpec(
                spec.num_layers, spec.boundaries,
                min(replication, spec.num_shards - 1), spec.holders)
        return spec
    if hasattr(spec, "pipelines"):               # PlacementSpec duck-type
        return CheckpointSpec.from_placement(spec, replication)
    raise TypeError(f"expected CheckpointSpec or PlacementSpec, got "
                    f"{type(spec).__name__}")


def save_for_placement(directory: Union[str, Path], step: int, tree: PyTree,
                       spec, *, replication: int = 0) -> Path:
    """Write every stage shard of a layer-sliced checkpoint.

    ``spec`` is a :class:`CheckpointSpec` or a ``PlacementSpec`` (each
    stage slot then saves exactly the layer range it executes).  This is
    the host-side simulation of all stage writers (a real fleet calls
    :func:`save_sharded` once per stage): every leaf is copied to the host
    once, and a file that several writers hold is written once, with the
    same bytes and manifests as one write per writer."""
    cspec = _as_ckpt_spec(spec, replication)
    d = _step_dir(directory, step)
    d.mkdir(parents=True, exist_ok=True)
    # under a mesh rank 0 writes; every rank takes part in each DTensor
    # leaf's gather
    flat = [(k, _whole_on(leaf, 0) if is_sharded(leaf) else leaf)
            for k, leaf in flatten(tree)]
    if mesh_rank()[0] != 0:
        return d
    flat = [(k, _to_numpy(leaf)) for k, leaf in flat]
    written: Dict[str, int] = {}
    for s in range(cspec.num_shards):
        _save_shard(d, step, flat, cspec, s, written)
    return d


# --------------------------------------------------------------------------- #
# Manifest reading + completeness validation
# --------------------------------------------------------------------------- #

def _read_manifest(d: Path) -> Dict[str, Any]:
    manifests = sorted(d.glob("manifest_*.json"))
    if not manifests:
        raise FileNotFoundError(f"no checkpoint manifest under {d}")
    m = json.loads(manifests[0].read_text())
    m.setdefault("layout", LAYOUT_LEAF_MODULO)
    m.setdefault("checksums", {})
    # each writer's manifest carries CRCs for only its own files
    for extra in manifests[1:]:
        try:
            m["checksums"].update(
                json.loads(extra.read_text()).get("checksums", {}))
        except (json.JSONDecodeError, OSError):
            continue
    return m


def _expected_files(m: Dict[str, Any]) -> List[Tuple[str, str]]:
    """Every data file the manifest expects: ``(filename, description)``
    naming the leaf and the shard responsible for writing it."""
    out: List[Tuple[str, str]] = []
    S = int(m.get("num_shards", 1))
    if m["layout"] == LAYOUT_LEAF_MODULO:
        for i, key in enumerate(m["keys"]):
            out.append((_leaf_name(key), f"(leaf {key}, shard {i % S})"))
        return out
    layer_set = set(m["layer_keys"])
    slices = list(zip(m["boundaries"][:-1], m["boundaries"][1:]))
    nonlayer_i = 0
    for key in m["keys"]:
        if key in layer_set:
            for s, (a, b) in enumerate(slices):
                out.append((_slice_name(key, a, b),
                            f"(leaf {key} layers {a}:{b}, shard {s})"))
        else:
            out.append((_leaf_name(key),
                        f"(leaf {key}, shard {nonlayer_i % S})"))
            nonlayer_i += 1
    return out


def _missing_files(d: Path, m: Dict[str, Any]) -> List[str]:
    """Manifest-expected data files absent on disk."""
    return [f"{name} {desc}" for name, desc in _expected_files(m)
            if not (d / name).exists()]


def _validate(d: Path) -> Dict[str, Any]:
    m = _read_manifest(d)
    missing = _missing_files(d, m)
    if missing:
        shown = "\n  ".join(missing[:20])
        more = f"\n  ... and {len(missing) - 20} more" \
            if len(missing) > 20 else ""
        raise IncompleteCheckpointError(
            f"checkpoint {d} is incomplete ({len(missing)} of its "
            f"manifest's files missing):\n  {shown}{more}")
    return m


def _step_complete(d: Path) -> bool:
    try:
        _validate(d)
        return True
    except (FileNotFoundError, json.JSONDecodeError):
        return False


def _all_steps(directory: Union[str, Path]) -> List[int]:
    return sorted(int(p.name.split("_")[1])
                  for p in Path(directory).glob("step_*"))


def latest_step(directory: Union[str, Path]) -> Optional[int]:
    steps = _all_steps(directory)
    return steps[-1] if steps else None


def complete_steps(directory: Union[str, Path]) -> List[int]:
    """Steps whose manifest-expected files are all present."""
    base = Path(directory)
    return [s for s in _all_steps(directory)
            if _step_complete(_step_dir(base, s))]


def latest_complete_step(directory: Union[str, Path]) -> Optional[int]:
    steps = complete_steps(directory)
    return steps[-1] if steps else None


def _resolve_step(directory: Union[str, Path], step: Optional[int]) -> Path:
    base = Path(directory)
    if step is not None:
        return _step_dir(base, step)
    steps = _all_steps(base)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {base}")
    complete = [s for s in steps if _step_complete(_step_dir(base, s))]
    # nothing complete: surface the newest step's precise gap
    return _step_dir(base, complete[-1] if complete else steps[-1])


# --------------------------------------------------------------------------- #
# Self-healing: checksum audit + re-fetch from neighbour holders
# --------------------------------------------------------------------------- #

def _crc_ok(path: Path, crc: Optional[int]) -> bool:
    if crc is None:
        return True                   # legacy manifest: existence only
    try:
        return zlib.crc32(path.read_bytes()) == crc
    except OSError:
        return False


def damaged_files(directory: Union[str, Path],
                  step: Optional[int] = None) -> List[Tuple[str, str]]:
    """Audit one step: ``(filename, reason)`` for every manifest-expected
    file that is absent (``missing``) or fails its CRC32 (``corrupt``).
    Empty list == the step restores clean."""
    d = _resolve_step(directory, step)
    m = _read_manifest(d)
    crcs = m.get("checksums", {})
    out: List[Tuple[str, str]] = []
    for name, _ in _expected_files(m):
        f = d / name
        if not f.exists():
            out.append((name, "missing"))
        elif not _crc_ok(f, crcs.get(name)):
            out.append((name, "corrupt"))
    return out


def _norm_sources(sources) -> List[Tuple[str, Path]]:
    """``sources`` entries are directories or ``(holder_name, dir)``
    pairs; plain directories are labelled by their own path."""
    out: List[Tuple[str, Path]] = []
    for s in sources:
        if isinstance(s, (tuple, list)) and len(s) == 2:
            out.append((str(s[0]), Path(s[1])))
        else:
            out.append((str(s), Path(s)))
    return out


def heal_step(directory: Union[str, Path], step: Optional[int] = None, *,
              sources: Sequence = (),
              policy: Optional[RestorePolicy] = None) -> HealReport:
    """Repair a damaged step in place from neighbour holders.

    Every missing/corrupt file (per :func:`damaged_files`) is re-fetched
    from the first source whose copy checksums clean against the
    manifest.  ``sources`` are the §5 ``held_shards`` holders — their
    local copy of the step directory (or its parent checkpoint dir).
    Transient reads retry with backoff; a source whose cumulative wall
    clock exceeds ``policy.source_timeout_s`` is skipped for the
    remaining files.  Detection and repair land on the obs timeline as
    ``fault.corrupt`` / ``fault.heal`` instants."""
    policy = policy or _DEFAULT_POLICY
    d = _resolve_step(directory, step)
    m = _read_manifest(d)
    crcs = m.get("checksums", {})
    tr = get_tracer()
    report = HealReport()
    damaged = damaged_files(directory, step)
    if not damaged:
        return report
    srcs = _norm_sources(sources)
    spent: Dict[str, float] = {name: 0.0 for name, _ in srcs}
    for name, reason in damaged:
        tr.instant("fault.corrupt", "fault", track="faults",
                   entity=name, reason=reason, step=d.name)
        healed = False
        for holder, sdir in srcs:
            if spent[holder] > policy.source_timeout_s:
                if holder not in report.sources_timed_out:
                    report.sources_timed_out.append(holder)
                continue
            t0 = time.monotonic()
            try:
                cand = sdir / name
                if not cand.exists():
                    cand = sdir / d.name / name
                data = _read_bytes_retry(cand, policy, report)
            except OSError:
                spent[holder] += time.monotonic() - t0
                continue
            spent[holder] += time.monotonic() - t0
            crc = crcs.get(name)
            if crc is not None and zlib.crc32(data) != crc:
                continue              # this holder's copy rotted too
            (d / name).write_bytes(data)
            report.healed.append({"file": name, "reason": reason,
                                  "source": holder, "bytes": len(data)})
            report.bytes_fetched += len(data)
            report.per_source_bytes[holder] = \
                report.per_source_bytes.get(holder, 0) + len(data)
            tr.instant("fault.heal", "fault", track="faults",
                       entity=name, source=holder, nbytes=len(data),
                       reason=reason)
            healed = True
            break
        if not healed:
            report.unrecovered.append(f"{name} ({reason}, no clean "
                                      "source copy)")
    return report


# --------------------------------------------------------------------------- #
# Restoring
# --------------------------------------------------------------------------- #

def _assemble_leaf(d: Path, m: Dict[str, Any], key: str,
                   span: Optional[Tuple[int, int]] = None,
                   policy: RestorePolicy = _DEFAULT_POLICY,
                   report: Optional[HealReport] = None,
                   mapped: bool = False) -> np.ndarray:
    """Load one leaf; a layer-sliced leaf is concatenated across the
    manifest's stage boundaries, optionally cropped to ``span`` (a new
    stage's range, reading only the slice files that overlap it).  A
    whole-leaf file stays ``mapped`` when asked."""
    crcs = m["checksums"]
    if m["layout"] == LAYOUT_LAYER_SLICED and key in _layer_key_set(m):
        lo, hi = span if span is not None else (0, m["num_layers"])
        parts = []
        for a, b in zip(m["boundaries"][:-1], m["boundaries"][1:]):
            s, e = max(a, lo), min(b, hi)
            if s >= e:
                continue
            name = _slice_name(key, a, b)
            arr = _load_array(d / name, crc=crcs.get(name), policy=policy,
                              report=report)
            parts.append(arr[s - a:e - a])
        return np.concatenate(parts, axis=0)
    name = _leaf_name(key)
    return _load_array(d / name, crc=crcs.get(name), policy=policy,
                       report=report, mapped=mapped)


def _layer_key_set(m: Dict[str, Any]) -> set:
    if "_layer_key_set" not in m:                 # memoized per manifest
        m["_layer_key_set"] = set(m.get("layer_keys", []))
    return m["_layer_key_set"]


def _check_keys(m: Dict[str, Any], keys: Sequence[str], d: Path) -> None:
    a, b = set(m["keys"]), set(keys)
    if a != b:
        raise ValueError(
            f"tree structure does not match checkpoint {d}: "
            f"{len(b - a)} leaves absent from the checkpoint "
            f"(e.g. {sorted(b - a)[:5]}), {len(a - b)} checkpoint leaves "
            f"unused (e.g. {sorted(a - b)[:5]})")


def _assemble_all(d: Path, m: Dict[str, Any], flat, spans,
                  policy: RestorePolicy,
                  report: Optional[HealReport]) -> List[torch.Tensor]:
    """Every leaf as a tensor on its prototype's device (a layer leaf
    cropped to its span when one is given), aggregating read failures
    into one :class:`ShardReadError` naming every shard that stayed
    unreadable after the policy's retries."""
    leaves: List[torch.Tensor] = []
    bad: List[str] = []
    for (key, proto), span in zip(flat, spans):
        try:
            # a rank restoring a DTensor keeps only its block of the file
            arr = _assemble_leaf(d, m, key, span, policy, report,
                                 mapped=is_sharded(proto))
            if span is not None and m["layout"] == LAYOUT_LEAF_MODULO:
                # whole-leaf layout: the file holds every layer, so crop
                # after the (unavoidably full) read
                arr = arr[span[0]:span[1]]
            shape = None if span is None else \
                (span[1] - span[0],) + tuple(proto.shape[1:])
            leaves.append(_to_tensor(arr, proto, shape))
        except (OSError, ShardChecksumError) as e:
            bad.append(f"{key}: {e}")
    if bad:
        shown = "\n  ".join(bad[:20])
        more = f"\n  ... and {len(bad) - 20} more" if len(bad) > 20 else ""
        raise ShardReadError(
            f"checkpoint {d}: {len(bad)} shard file(s) unreadable after "
            f"{policy.retries} retries (pass sources= to re-fetch from "
            f"neighbour holders):\n  {shown}{more}")
    return leaves


def _heal_first(directory, step, sources, policy,
                heal_report: Optional[HealReport]) -> None:
    if sources:
        rep = heal_step(directory, step, sources=sources, policy=policy)
        if heal_report is not None:
            heal_report.__dict__.update(rep.__dict__)


def restore(directory: Union[str, Path], tree_like: PyTree,
            step: Optional[int] = None, *, sources: Sequence = (),
            policy: Optional[RestorePolicy] = None,
            heal_report: Optional[HealReport] = None) -> PyTree:
    """Restore into the structure of ``tree_like`` (a nested dict of
    tensors): each leaf comes back with its prototype's dtype, shape and
    device.  ``step`` defaults to the newest complete step.  Reads both
    layouts (layer-sliced ones across whatever boundaries their manifest
    records); raises :class:`IncompleteCheckpointError` for missing files
    and one :class:`ShardReadError` naming every shard that stayed
    unreadable.  With ``sources=`` (neighbour holder directories, or
    ``(name, directory)`` pairs) damaged files self-heal first through
    :func:`heal_step`; ``heal_report`` receives what was fetched."""
    policy = policy or _DEFAULT_POLICY
    d = _resolve_step(directory, step)
    _heal_first(directory, step, sources, policy, heal_report)
    m = _validate(d)
    flat = list(flatten(tree_like))
    _check_keys(m, [k for k, _ in flat], d)
    leaves = _assemble_all(d, m, flat, [None] * len(flat), policy,
                           heal_report)
    return tree_unflatten(tree_like, leaves)


def restore_for_placement(directory: Union[str, Path], new_spec,
                          tree_like: PyTree, step: Optional[int] = None,
                          *, stage: Optional[int] = None,
                          sources: Sequence = (),
                          policy: Optional[RestorePolicy] = None,
                          heal_report: Optional[HealReport] = None
                          ) -> PyTree:
    """Restore a checkpoint onto a *different* placement.

    ``new_spec`` is the placement (or :class:`CheckpointSpec` / boundary
    list) that will execute next.  With ``stage=None`` the full tree is
    reassembled (identical to :func:`restore`).  With ``stage=s`` only
    that stage's state is materialized: layer leaves come back cropped to
    the new stage's ``[start, stop)`` range, reading only the old slice
    files that overlap it — the bytes-actually-missing read set a joining
    device fetches.  Same robustness contract as :func:`restore`,
    ``sources=`` healing included."""
    policy = policy or _DEFAULT_POLICY
    bounds: List[int] = list(getattr(new_spec, "boundaries", new_spec))
    d = _resolve_step(directory, step)
    _heal_first(directory, step, sources, policy, heal_report)
    m = _validate(d)
    if m["layout"] == LAYOUT_LAYER_SLICED and m["num_layers"] != bounds[-1]:
        raise ValueError(
            f"checkpoint has {m['num_layers']} layers but the new "
            f"placement expects {bounds[-1]}")
    flat = list(flatten(tree_like))
    _check_keys(m, [k for k, _ in flat], d)
    span = None if stage is None else (bounds[stage], bounds[stage + 1])
    if m["layout"] == LAYOUT_LAYER_SLICED:
        layer = _layer_key_set(m)
        spans = [span if k in layer else None for k, _ in flat]
    else:
        spans = [span if _is_layer_leaf(k, p, bounds[-1]) else None
                 for k, p in flat]
    leaves = _assemble_all(d, m, flat, spans, policy, heal_report)
    return tree_unflatten(tree_like, leaves)


def reshard(directory: Union[str, Path], new_spec, tree_like: PyTree, *,
            step: Optional[int] = None,
            out_directory: Optional[Union[str, Path]] = None,
            replication: int = 0) -> Path:
    """Rewrite a checkpoint under a new placement's sharding: restore
    (re-slicing across the old boundaries) and save under ``new_spec``'s
    — the post-churn state migration, done once instead of every future
    restore paying the re-slice.  3 stages → 2 → 3 is bit-identical."""
    d = _resolve_step(directory, step)
    st = int(d.name.split("_")[1])
    state = restore(directory, tree_like, st)
    return save_for_placement(out_directory or directory, st, state,
                              new_spec, replication=replication)


# --------------------------------------------------------------------------- #
# Pruning
# --------------------------------------------------------------------------- #

def prune(directory: Union[str, Path], keep: int = 2) -> None:
    """Keep the newest ``keep`` *complete* steps.  Incomplete steps older
    than the newest complete one are dead partial writes and go; newer
    incomplete steps may be in-flight writers and stay.  Under a mesh
    every rank calls: rank 0 prunes once all of them have written."""
    if current_mesh() is not None:
        import torch.distributed as dist
        dist.barrier()
        if mesh_rank()[0] != 0:
            return
    base = Path(directory)
    steps = _all_steps(base)
    complete = [s for s in steps if _step_complete(_step_dir(base, s))]
    if not complete:
        return                        # nothing provably restorable: keep all
    keep_set = set(complete[-max(keep, 1):])
    newest_complete = complete[-1]
    for s in steps:
        if s in keep_set or (s not in complete and s > newest_complete):
            continue
        shutil.rmtree(_step_dir(base, s))
