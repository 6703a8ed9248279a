"""Pure-numpy sharded checkpoints (port of ``repro.checkpoint.ckpt``).

The on-disk format is the JAX package's, so either package restores what
the other wrote.  Under ``<dir>/step_<N>/`` every leaf is one or more
``.npy`` files plus per-writer json manifests that list every leaf's key
(the ``jax.tree_util.keystr`` path, as ``bridge.keystr`` builds it) and
every data file's CRC32.  bfloat16 leaves are stored as their uint16 bit
patterns and viewed back on restore.

* :func:`save` writes the ``leaf_modulo`` layout: leaf ``i`` belongs to
  shard ``i % num_shards`` and is saved whole.
* :func:`restore` reads both layouts: ``leaf_modulo`` and the JAX
  package's elastic ``layer_sliced`` layout (files ``<leaf>.L<a>-<b>.npy``
  holding layers ``a:b`` of a stacked decoder leaf), which it reassembles
  across whatever stage boundaries its manifest records.  Completeness is
  validated up front (one :class:`IncompleteCheckpointError` names every
  missing file); reads are CRC-checked and retried per
  :class:`RestorePolicy`, and persistent failures aggregate into one
  :class:`ShardReadError`.
* :func:`prune` keeps the newest complete steps and never deletes a newer
  in-flight one.

Writing the layer-sliced layout, restoring onto another placement,
resharding and healing from neighbour copies wait for the port of
``core/placement``.
"""

from __future__ import annotations

import io
import json
import shutil
import time
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.bridge import flatten
from repro_torch.models.params import tree_unflatten

PyTree = Any

LAYOUT_LEAF_MODULO = "leaf_modulo"
LAYOUT_LAYER_SLICED = "layer_sliced"


class IncompleteCheckpointError(FileNotFoundError):
    """A restore/validation found manifest-expected files missing."""


class ShardReadError(IncompleteCheckpointError):
    """Shard files present but unreadable (corrupt or persistent I/O
    failure) after retries; names every bad shard."""


class ShardChecksumError(ValueError):
    """A shard file's bytes do not match its manifest CRC32."""


@dataclass(frozen=True)
class RestorePolicy:
    """Retry discipline for shard reads: ``retries`` transient-I/O
    retries per file with exponential backoff from ``backoff_s``.
    Checksum mismatches are not retried (bit-rot is deterministic)."""
    retries: int = 2
    backoff_s: float = 0.05
    verify_checksums: bool = True


_DEFAULT_POLICY = RestorePolicy()


def _escape(path_str: str) -> str:
    return path_str.replace("/", "_").replace("'", "").replace("[", "(") \
        .replace("]", ")")


def _slice_name(key: str, a: int, b: int) -> str:
    return f"{_escape(key)}.L{a:05d}-{b:05d}.npy"


def _leaf_name(key: str) -> str:
    return _escape(key) + ".npy"


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
    data = buf.getvalue()
    path.write_bytes(data)
    return zlib.crc32(data)


def _read_bytes_retry(path: Path, policy: RestorePolicy) -> bytes:
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
            time.sleep(delay)
            delay *= 2


def _load_array(path: Path, *, crc: Optional[int],
                policy: RestorePolicy) -> np.ndarray:
    data = _read_bytes_retry(path, policy)
    if crc is not None and policy.verify_checksums \
            and zlib.crc32(data) != crc:
        raise ShardChecksumError(
            f"{path.name}: CRC32 mismatch against manifest (bit-rot or "
            "partial write)")
    try:
        return np.load(io.BytesIO(data), allow_pickle=False)
    except ValueError as e:
        raise ShardChecksumError(f"{path.name}: unparseable npy "
                                 f"({e})") from e


def _to_tensor(arr: np.ndarray, proto: torch.Tensor) -> torch.Tensor:
    """The stored array as a tensor of ``proto``'s dtype and device."""
    if proto.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C"))
    if tuple(t.shape) != tuple(proto.shape):
        raise ValueError(f"stored shape {tuple(t.shape)} != "
                         f"{tuple(proto.shape)}")
    return t.to(device=proto.device, dtype=proto.dtype)


# --------------------------------------------------------------------------- #
# Saving
# --------------------------------------------------------------------------- #

def _step_dir(directory: Union[str, Path], step: int) -> Path:
    return Path(directory) / f"step_{step:08d}"


def save(directory: Union[str, Path], step: int, tree: PyTree, *,
         num_shards: int = 1, shard_id: int = 0) -> Path:
    """Write (a leaf-modulo shard of) a checkpoint; returns the step dir."""
    d = _step_dir(directory, step)
    d.mkdir(parents=True, exist_ok=True)
    flat = list(flatten(tree))
    checksums: Dict[str, int] = {}
    manifest = {"step": step, "layout": LAYOUT_LEAF_MODULO,
                "num_leaves": len(flat), "num_shards": num_shards,
                "shard_id": shard_id, "keys": [k for k, _ in flat],
                "checksums": checksums}
    for i, (key, leaf) in enumerate(flat):
        if i % num_shards != shard_id:
            continue
        name = _leaf_name(key)
        checksums[name] = _save_array(d / name, leaf)
    (d / f"manifest_{shard_id}.json").write_text(json.dumps(manifest))
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


def _validate(d: Path) -> Dict[str, Any]:
    m = _read_manifest(d)
    missing = [f"{name} {desc}" for name, desc in _expected_files(m)
               if not (d / name).exists()]
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
# Restoring
# --------------------------------------------------------------------------- #

def _assemble_leaf(d: Path, m: Dict[str, Any], key: str,
                   policy: RestorePolicy) -> np.ndarray:
    """Load one leaf; a layer-sliced leaf is concatenated across the
    manifest's stage boundaries."""
    crcs = m["checksums"]
    if m["layout"] == LAYOUT_LAYER_SLICED and key in set(m["layer_keys"]):
        parts = []
        for a, b in zip(m["boundaries"][:-1], m["boundaries"][1:]):
            name = _slice_name(key, a, b)
            parts.append(_load_array(d / name, crc=crcs.get(name),
                                     policy=policy))
        return np.concatenate(parts, axis=0)
    name = _leaf_name(key)
    return _load_array(d / name, crc=crcs.get(name), policy=policy)


def restore(directory: Union[str, Path], tree_like: PyTree,
            step: Optional[int] = None, *, sources: Sequence = (),
            policy: Optional[RestorePolicy] = None) -> PyTree:
    """Restore into the structure of ``tree_like`` (a nested dict of
    tensors): each leaf comes back with its prototype's dtype, shape and
    device.  ``step`` defaults to the newest complete step.  Reads both
    layouts; raises :class:`IncompleteCheckpointError` for missing files
    and one :class:`ShardReadError` naming every shard that stayed
    unreadable (CRC mismatch or persistent I/O failure)."""
    if sources:
        raise NotImplementedError("healing from neighbour copies "
                                  "(heal_step) waits for core/placement")
    policy = policy or _DEFAULT_POLICY
    d = _resolve_step(directory, step)
    m = _validate(d)
    flat = list(flatten(tree_like))
    keys = [k for k, _ in flat]
    if set(m["keys"]) != set(keys):
        extra, lacking = set(keys) - set(m["keys"]), set(m["keys"]) - set(keys)
        raise ValueError(
            f"tree structure does not match checkpoint {d}: "
            f"{len(extra)} leaves absent from the checkpoint "
            f"(e.g. {sorted(extra)[:5]}), {len(lacking)} checkpoint leaves "
            f"unused (e.g. {sorted(lacking)[:5]})")
    leaves: List[torch.Tensor] = []
    bad: List[str] = []
    for key, proto in flat:
        try:
            leaves.append(_to_tensor(_assemble_leaf(d, m, key, policy),
                                     proto))
        except (OSError, ShardChecksumError) as e:
            bad.append(f"{key}: {e}")
    if bad:
        shown = "\n  ".join(bad[:20])
        more = f"\n  ... and {len(bad) - 20} more" if len(bad) > 20 else ""
        raise ShardReadError(
            f"checkpoint {d}: {len(bad)} shard file(s) unreadable after "
            f"{policy.retries} retries:\n  {shown}{more}")
    return tree_unflatten(tree_like, leaves)


# --------------------------------------------------------------------------- #
# Pruning
# --------------------------------------------------------------------------- #

def prune(directory: Union[str, Path], keep: int = 2) -> None:
    """Keep the newest ``keep`` *complete* steps.  Incomplete steps older
    than the newest complete one are dead partial writes and go; newer
    incomplete steps may be in-flight writers and stay."""
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
