"""Versioned, checksummed checkpoints of one process (port of
``paddle_tpu/distributed/checkpoint/__init__.py``).

The files are the JAX package's: ``{rank}_0.{sid}.distcp.npz`` holds the
chunk arrays, keyed ``<tensor>##<chunk>``, and ``{rank}.{sid}.metadata.
json`` describes each chunk (offset, shape, file, key, crc32 of its
bytes) under a monotonically increasing save id ``sid``.  A save never
overwrites an earlier save's files: it writes to ``.tmp`` names, fsyncs
and renames them into place, and only then removes the older saves, so
a crash leaves the previous save loadable; a load takes the newest save
whose metadata set is complete.  bf16 chunks are written as numpy's
2-byte void arrays (``|V2``, what ``np.savez`` makes of the JAX
package's ``ml_dtypes`` bf16 arrays) with the dtype named in the
metadata, so either package reads the other's files.  A chunk whose
bytes fail their crc32 (or the archive's own CRC, for bytes changed in
place) raises :class:`CheckpointCorrupt` naming it.

Tensors are read to the host when ``save_state_dict`` is called (on a
CUDA tensor that is a device-to-host copy), so with ``async_save=True``
only the checksums and the disk write run on the writer thread;
:func:`wait_async_save` joins it and raises every error it met.  Loading
writes each target tensor in place.

One process only: a ``process_group``, a world size above 1, sharded
chunk capture (``ShardChunks``) and loading onto another sharding are
ROADMAP.md A7.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import threading
import zipfile
import zlib

import numpy as np
import torch

from ...core.tensor import Tensor

_ASYNC_THREADS = []
_ASYNC_ERRORS = []
_ASYNC_LOCK = threading.Lock()

_META_RE = r"^(\d+)\.(\d+)\.metadata\.json$"          # rank.sid.metadata.json
_LEGACY_META_RE = r"^(\d+)\.metadata\.json$"

#: numpy dtypes by the metadata's name; bf16 has none in numpy and is
#: kept as its raw 2-byte words
_BF16_ON_DISK = np.dtype("V2")
_TORCH_DTYPES = {"float64": torch.float64, "float32": torch.float32,
                 "float16": torch.float16, "bfloat16": torch.bfloat16,
                 "int64": torch.int64, "int32": torch.int32,
                 "int16": torch.int16, "int8": torch.int8,
                 "uint8": torch.uint8, "uint32": torch.uint32,
                 "bool": torch.bool}


class CheckpointCorrupt(RuntimeError):
    """A saved chunk failed its checksum on load: the bytes on disk are
    not the bytes that were written.  The message names the chunk."""


def _a7(what):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md A7 (distributed)")


def _world(process_group):
    if process_group is not None:
        raise _a7("a checkpoint over a process_group")
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise _a7(f"a checkpoint of {dist.get_world_size()} processes")
    return 0, 1


class ShardChunks:
    """The JAX package's per-shard capture of a mesh-sharded array.  A
    tensor on one device has one chunk; sharded saves are A7."""

    def __init__(self, *args, **kwargs):
        raise _a7("ShardChunks (sharded checkpoint chunks)")

    @classmethod
    def capture(cls, arr, spec=None):
        raise _a7("ShardChunks (sharded checkpoint chunks)")


def dtype_name(t):
    """The metadata's name of a torch dtype ("bfloat16", "float32", ...)."""
    return str(t).replace("torch.", "")


def to_numpy(t):
    """A CPU tensor's bytes as a numpy array (a view): bf16 as ``|V2``."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_ON_DISK)
    return t.numpy()


def from_numpy(arr, dtype):
    """The tensor a chunk array holds, its dtype named by the metadata."""
    arr = np.require(arr, requirements="C")    # keeps a 0-d array 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _host_array(v, copy):
    """``(numpy array, dtype name)`` of a value to save."""
    if isinstance(v, Tensor):
        v = v._data
    if isinstance(v, torch.Tensor):
        host = v.detach().to("cpu")
        if copy and host.data_ptr() == v.data_ptr():
            host = host.clone()
        return to_numpy(host), dtype_name(v.dtype)
    arr = np.array(v, copy=True) if copy else np.asarray(v)
    return arr, ("bfloat16" if arr.dtype.name == "bfloat16"
                 else str(arr.dtype))


def _crc32(arr):
    """Checksum of a chunk's raw bytes (the C-contiguous buffer as
    saved), read in place."""
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return zlib.crc32(memoryview(raw)) & 0xFFFFFFFF


def _flatten(state_dict, prefix=""):
    flat = {}
    for k, v in state_dict.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def wait_async_save():
    """Block until pending async writes finish and raise every error
    they met, so a failed save cannot pass for a good one.  Safe under
    concurrent callers: the thread list is snapshotted, every caller
    joins the same set and the bookkeeping is under a lock."""
    with _ASYNC_LOCK:
        pending = list(_ASYNC_THREADS)
    for t in pending:
        t.join()
    with _ASYNC_LOCK:
        for t in pending:
            if t in _ASYNC_THREADS:
                _ASYNC_THREADS.remove(t)
        errors = list(_ASYNC_ERRORS)
        del _ASYNC_ERRORS[:]
    if errors:
        if len(errors) == 1:
            raise RuntimeError("async checkpoint save failed") from errors[0]
        detail = "; ".join(f"{type(e).__name__}: {e}" for e in errors)
        raise RuntimeError(
            f"{len(errors)} async checkpoint saves failed: "
            f"{detail}") from errors[0]


atexit.register(wait_async_save)  # don't kill a mid-write daemon at exit


def _existing_save_ids(path):
    sids = set()
    for fname in os.listdir(path):
        m = re.match(_META_RE, fname)
        if m:
            sids.add(int(m.group(2)))
    return sids


def save_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, unique_id=None, async_save=False):
    """Write ``state_dict`` (nested dicts of tensors, ``Tensor``s, numpy
    arrays and JSON scalars) as save ``unique_id`` (default: one past
    the newest) under ``path``; see the module docstring for the
    layout.  Older saves are removed once this one is on disk."""
    rank, world = _world(process_group)
    wait_async_save()
    os.makedirs(path, exist_ok=True)
    # remove our own staging files left by a crashed run
    for fname in os.listdir(path):
        if fname.endswith(".tmp") and (fname.startswith(f"{rank}_0.")
                                       or fname.startswith(f"{rank}.")):
            try:
                os.remove(os.path.join(path, fname))
            except OSError:
                pass
    existing = _existing_save_ids(path)
    if unique_id is not None:
        sid = int(unique_id)
        if existing and sid <= max(existing):
            # reusing a sid would overwrite that save in place, and a
            # lower one could never be loaded (the newest complete wins)
            raise ValueError(
                f"unique_id={sid} collides with or predates existing save "
                f"ids {sorted(existing)} at {path}; pass a strictly larger "
                "id or omit unique_id for auto-increment")
    else:
        sid = (max(existing) + 1) if existing else 0
    shard_file = f"{rank}_0.{sid}.distcp.npz"
    arrays = {}
    meta = {"world_size": world, "save_id": sid, "tensors": {}}
    for k, v in _flatten(state_dict).items():
        if isinstance(v, ShardChunks):
            raise _a7("saving ShardChunks")
        if isinstance(v, (Tensor, torch.Tensor, np.ndarray)):
            # async: own the bytes now; the caller may write the tensor
            # in place while the writer thread runs
            arr, dt = _host_array(v, copy=async_save)
            key = f"{k}##0"
            arrays[key] = arr
            meta["tensors"][k] = {
                "shape": list(arr.shape), "dtype": dt,
                "chunks": [{"offset": [0] * arr.ndim,
                            "shape": list(arr.shape), "file": shard_file,
                            "key": key}]}
        else:
            meta["tensors"][k] = {"value": v.item() if isinstance(
                v, np.generic) else v}

    def _write():
        for entry in meta["tensors"].values():
            for chunk in entry.get("chunks", ()):
                chunk["crc32"] = _crc32(arrays[chunk["key"]])
        # stage to tmp names, then rename into place: versioned names mean
        # nothing of an older save id is touched
        shard_tmp = os.path.join(path, shard_file + ".tmp")
        meta_name = f"{rank}.{sid}.metadata.json"
        meta_tmp = os.path.join(path, meta_name + ".tmp")
        with open(shard_tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        with open(meta_tmp, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(shard_tmp, os.path.join(path, shard_file))
        os.replace(meta_tmp, os.path.join(path, meta_name))
        if rank == coordinator_rank:
            _gc_old_saves(path, sid, world)

    if async_save:
        def _guarded():
            try:
                _write()
            except BaseException as e:  # surfaced by wait_async_save()
                _ASYNC_ERRORS.append(e)
        t = threading.Thread(target=_guarded, daemon=True)
        with _ASYNC_LOCK:
            _ASYNC_THREADS.append(t)
        t.start()
    else:
        _write()


def _gc_old_saves(path, sid, world):
    """Delete the files of saves older than ``sid``, once save ``sid``
    is complete (all ``world`` metadata files present)."""
    present = sum(1 for f in os.listdir(path)
                  if re.match(rf"^\d+\.{sid}\.metadata\.json$", f))
    if present < world:
        return
    for fname in os.listdir(path):
        m = re.match(r"^\d+(?:_0)?\.(\d+)\.(?:metadata\.json|distcp\.npz)$",
                     fname)
        legacy = (re.match(r"^\d+(?:_0)?\.(?:metadata\.json|distcp\.npz)$",
                           fname) or fname == "metadata.json")
        if legacy or (m and int(m.group(1)) < sid):
            try:
                os.remove(os.path.join(path, fname))
            except OSError:
                pass


def _read_metadata(path):
    """The merged metadata of the newest save id whose metadata set is
    complete (file count == recorded world size); incomplete saves are
    skipped so the previous one loads."""
    by_sid = {}
    for fname in os.listdir(path):
        m = re.match(_META_RE, fname)
        if m:
            by_sid.setdefault(int(m.group(2)), []).append(fname)
        elif re.match(_LEGACY_META_RE, fname):
            by_sid.setdefault(-1, []).append(fname)  # pre-versioning layout
    if not by_sid:
        raise FileNotFoundError(f"no checkpoint metadata under {path}")
    incomplete = []
    for sid in sorted(by_sid, reverse=True):
        files = sorted(by_sid[sid])
        merged = {}
        worlds = set()
        for fname in files:
            with open(os.path.join(path, fname)) as f:
                meta = json.load(f)
            if "world_size" in meta:
                worlds.add(meta["world_size"])
            for k, entry in meta["tensors"].items():
                if k not in merged:
                    merged[k] = entry
                elif "chunks" in entry:
                    merged[k]["chunks"].extend(entry["chunks"])
        if len(worlds) == 1 and len(files) == next(iter(worlds)):
            return merged
        incomplete.append((sid, len(files), sorted(worlds)))
    raise RuntimeError(
        f"checkpoint at {path} has no complete save: per-save "
        f"(save_id, metadata_files, recorded_world_sizes) = {incomplete}")


def _corrupt():
    from ...profiler import counters as _counters
    _counters.inc("resilience.corrupt_detected")


class _ChunkReader:
    def __init__(self, path):
        self.path = path
        self._files = {}

    def get(self, chunk):
        fname, key = chunk["file"], chunk["key"]
        fpath = os.path.join(self.path, fname)
        if fname not in self._files:
            self._files[fname] = np.load(fpath)
        try:
            arr = self._files[fname][key]
        except zipfile.BadZipFile as e:
            # the archive's own CRC caught bytes changed in place
            _corrupt()
            raise CheckpointCorrupt(
                f"checksum mismatch for chunk {key!r} in {fpath}: {e}: the "
                "checkpoint bytes on disk are corrupt") from e
        want = chunk.get("crc32")
        if want is not None:
            got = _crc32(arr)
            if got != int(want):
                _corrupt()
                raise CheckpointCorrupt(
                    f"checksum mismatch for chunk {key!r} in {fpath}: "
                    f"stored crc32={int(want)}, computed crc32={got}: the "
                    "checkpoint bytes on disk are corrupt")
        return arr

    def close(self):
        for f in self._files.values():
            f.close()


def _assemble(shape, dtype, chunks, reader):
    """The whole tensor from its chunk boxes (a JAX save of a sharded
    array has several)."""
    if len(chunks) == 1 and list(chunks[0]["shape"]) == list(shape):
        return from_numpy(reader.get(chunks[0]), dtype)
    out = torch.empty(shape, dtype=_TORCH_DTYPES[dtype])
    filled = torch.zeros(shape, dtype=torch.bool)
    for chunk in chunks:
        box = tuple(slice(o, o + s)
                    for o, s in zip(chunk["offset"], chunk["shape"]))
        out[box] = from_numpy(reader.get(chunk), dtype)
        filled[box] = True
    if not bool(filled.all()):
        raise RuntimeError(
            "checkpoint is missing chunks of a tensor (multi-process "
            "checkpoint loaded with too few metadata files?)")
    return out


def load_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, unique_id=None, offload=False):
    """Fill the tensors of ``state_dict`` (``torch.Tensor``s or
    ``Tensor``s, nested in dicts) in place from the newest complete save
    under ``path``, cast to each target's dtype; a shape mismatch raises
    ``ValueError``, a corrupt chunk :class:`CheckpointCorrupt`."""
    _world(process_group)
    wait_async_save()  # a pending async save to `path` may be mid-write
    meta = _read_metadata(path)
    reader = _ChunkReader(path)
    try:
        for k, tgt in _flatten(state_dict).items():
            info = meta.get(k)
            if info is None or "value" in info:
                continue
            if isinstance(tgt, Tensor):
                tgt = tgt._data
            if not isinstance(tgt, torch.Tensor):
                continue
            shape = tuple(info["shape"])
            if tuple(tgt.shape) != shape:
                raise ValueError(
                    f"checkpoint tensor {k!r} has shape {shape}, target "
                    f"has {tuple(tgt.shape)}")
            src = _assemble(shape, info["dtype"], info["chunks"], reader)
            with torch.no_grad():
                tgt.copy_(src)
    finally:
        reader.close()
    return state_dict


__all__ = ["CheckpointCorrupt", "ShardChunks", "load_state_dict",
           "save_state_dict", "wait_async_save"]
