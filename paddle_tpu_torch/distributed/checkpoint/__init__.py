"""Versioned, checksummed, sharded checkpoints (port of
``paddle_tpu/distributed/checkpoint/__init__.py``).

The files are the JAX package's: ``{rank}_0.{sid}.distcp.npz`` holds a
rank's chunk arrays, keyed ``<tensor>##<chunk>``, and ``{rank}.{sid}.
metadata.json`` describes each chunk (offset in the whole tensor,
shape, file, key, crc32 of its bytes) under a save id ``sid`` that
every rank agrees on (the coordinator's, broadcast) and a
``world_size``.  A save never overwrites an earlier save's files: each
rank writes to ``.tmp`` names, fsyncs and renames them into place; the
ranks then agree that every one of them wrote (a barrier that carries
each rank's success), and only then does the coordinator remove the
older saves, so a crash leaves the previous save loadable; a load takes
the newest save whose metadata set is complete (as many files as its
``world_size``).  bf16 chunks are written as numpy's 2-byte void arrays
(``|V2``, what ``np.savez`` makes of the JAX package's ``ml_dtypes``
bf16 arrays) with the dtype named in the metadata, so either package
reads the other's files.  A chunk whose bytes fail their crc32 (or the
archive's own CRC, for bytes changed in place) raises
:class:`CheckpointCorrupt` naming it.

**Shards.**  A rank's piece of a tensor is a :class:`LocalShard`: the
local tensor and where it lies in the whole one (a partition spec over
the mesh, GPT's fused ``[q | k | v]`` columns, a pipeline stage's
rows; ``distributed.sharding_utils.shard_boxes``).  Saving one writes
its boxes as chunks with their global offsets, each box once: of the
ranks that hold the same boxes, the one whose index is 0 on every axis
the spec does not split writes them (``writes_shard``, the JAX
``replica_id == 0``).  Loading into one fills each of its boxes from
whatever chunks cover it, so a save on any mesh (the JAX package's
included) loads onto any other.  A plain tensor or numpy array is
whole and the same on every rank: the coordinator alone writes it, and
every rank loads it whole.  :class:`ShardChunks` is a shard already
copied to the host (``capture``).

Tensors are read to the host when ``save_state_dict`` is called (on a
CUDA tensor that is a device-to-host copy), so with ``async_save=True``
only the checksums, the disk write and the ranks' agreement run on the
writer thread; that agreement runs over a gloo group of the
checkpoint's own, so it never meets the training collectives of the
same ranks.  :func:`wait_async_save` joins the writer and raises every
error it met.  Loading writes each target tensor in place and issues
no collective.

``process_group`` (default: the whole world) gives the rank and the
world size; ``coordinator_rank`` is a rank of that group.  Every member
calls ``save_state_dict`` with the same keys.
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
from ..sharding_utils import global_shape, shard_boxes, writes_shard

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


# -- the ranks -------------------------------------------------------------
_COORD = {}   # (world group, ranks) -> the checkpoint's own gloo group


def rank_world(process_group=None):
    """``(rank, world size)`` of this process in ``process_group``
    (default: the whole world); ``(0, 1)`` without a process group."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return (dist.get_rank(process_group),
            dist.get_world_size(process_group))


def coord_group(process_group=None):
    """The gloo group over ``process_group``'s ranks that checkpoints
    coordinate on (save ids, barriers, agreement): one of their own, so a
    writer thread's collectives never meet the training collectives of
    the same ranks, and gloo, so they take host tensors whatever the
    training backend.  Made on first use, by every member (each save and
    restore is called on every rank); None at one rank."""
    dist = torch.distributed
    if rank_world(process_group)[1] <= 1:
        return None
    ranks = tuple(dist.get_process_group_ranks(process_group)
                  if process_group is not None
                  else range(dist.get_world_size()))
    key = ranks
    hit = _COORD.get(key)
    if hit is None or hit[0] is not dist.group.WORLD:
        hit = _COORD[key] = (dist.group.WORLD, dist.new_group(
            list(ranks), backend="gloo", use_local_synchronization=True))
    return hit[1]


def agree(ok, group):
    """True when ``ok`` holds on every rank of ``group`` (an all-reduce of
    the flags: also a barrier); ``ok`` itself at one rank."""
    if group is None:
        return bool(ok)
    t = torch.tensor([1 if ok else 0], dtype=torch.int32)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MIN,
                                 group=group)
    return bool(t.item())


def broadcast_int(value, group, src=0):
    """``value`` on group rank ``src``, on every rank of ``group``."""
    if group is None:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    torch.distributed.broadcast(
        t, src=torch.distributed.get_global_rank(group, src), group=group)
    return int(t.item())


# -- shards ------------------------------------------------------------------
class LocalShard:
    """A rank's piece ``tensor`` of a whole tensor, for saving and
    loading: its boxes are ``shard_boxes(shape, spec, mesh, fused,
    rows)``, laid end to end in ``tensor``.  ``whole=True``: the rank
    holds the whole tensor, and ``spec`` says which part of it the rank
    writes (a parameter held whole whose optimizer state is split: each
    rank writes its slice) while a load fills all of it.  ``shape`` is
    the whole tensor's; ``writes`` whether this rank writes its boxes."""

    def __init__(self, tensor, spec=None, mesh=None, fused=1, rows=None,
                 whole=False):
        t = tensor._data if isinstance(tensor, Tensor) else tensor
        self.tensor, self.spec, self.mesh = t, spec, mesh
        self.fused, self.rows, self.whole = fused, rows, whole
        self.shape = (tuple(t.shape) if whole or mesh is None
                      else global_shape(t.shape, spec, mesh))
        self.writes = writes_shard(spec, mesh)

    def boxes(self):
        """``[(offset, shape, local offset)]`` of the boxes this rank
        writes."""
        if self.mesh is None:
            return [((0,) * len(self.shape), self.shape,
                     (0,) * len(self.shape))]
        out = shard_boxes(self.shape, self.spec, self.mesh, self.fused,
                          self.rows)
        return [(o, s, o) for o, s, _ in out] if self.whole else out

    def load_boxes(self):
        """The boxes a load fills: all of a whole tensor, else
        :meth:`boxes`."""
        if self.whole:
            zero = (0,) * len(self.shape)
            return [(zero, self.shape, zero)]
        return self.boxes()

    def view(self, local_offset, shape):
        """The part of ``tensor`` at ``local_offset`` of ``shape``."""
        t = self.tensor
        for d, (o, n) in enumerate(zip(local_offset, shape)):
            if n != t.shape[d]:
                t = t.narrow(d, o, n)
        return t


class ShardChunks:
    """A shard copied to the host: the whole tensor's ``shape`` and
    ``dtype`` name, the ``spec`` it was split by (recorded, not read),
    and ``chunks``, ``[(offset, shape, host tensor or ndarray)]``, the
    boxes this rank writes (none when another rank writes them)."""

    __slots__ = ("shape", "dtype", "spec", "chunks")

    def __init__(self, shape, dtype, chunks, spec=None):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype if isinstance(dtype, str) else dtype_name(dtype)
        self.spec = spec
        self.chunks = chunks

    @classmethod
    def capture(cls, shard, copy=None):
        """The boxes of the :class:`LocalShard` ``shard`` this rank
        writes, each copied to the host: by ``copy(index, view)`` when
        given (a caller that queues the copies into buffers of its own
        and synchronizes once), else synchronously."""
        chunks = []
        if shard.writes:
            for i, (off, shp, loc) in enumerate(shard.boxes()):
                view = shard.view(loc, shp).detach()
                host = (copy(i, view) if copy is not None
                        else view.to("cpu", copy=True))
                chunks.append((off, shp, host))
        return cls(shard.shape, shard.tensor.dtype, chunks, spec=shard.spec)

    @property
    def nbytes(self):
        return sum(int(c.nbytes) for _, _, c in self.chunks)


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
    return arr, _np_dtype_name(arr)


def _np_dtype_name(arr):
    return "bfloat16" if arr.dtype.name == "bfloat16" else str(arr.dtype)


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


def _save_id(path, unique_id):
    """This save's id under ``path`` (``unique_id``, checked, or one past
    the newest); ValueError on a collision."""
    existing = _existing_save_ids(path)
    if unique_id is None:
        return (max(existing) + 1) if existing else 0
    sid = int(unique_id)
    if existing and sid <= max(existing):
        # reusing a sid would overwrite that save in place, and a lower
        # one could never be loaded (the newest complete wins)
        raise ValueError(
            f"unique_id={sid} collides with or predates existing save ids "
            f"{sorted(existing)} at {path}; pass a strictly larger id or "
            "omit unique_id for auto-increment")
    return sid


def _agreed_save_id(path, unique_id, rank, group, coordinator_rank):
    """The coordinator's :func:`_save_id`, on every rank (a ValueError on
    the coordinator raises on every rank)."""
    sid, err = -1, None
    if rank == coordinator_rank:
        try:
            sid = _save_id(path, unique_id)
        except ValueError as e:
            err = e
    sid = broadcast_int(sid, group, coordinator_rank)
    if err is not None:
        raise err
    if sid < 0:
        raise ValueError(f"unique_id={unique_id} collides with or predates "
                         f"an existing save id at {path} (the "
                         "coordinator's check)")
    return sid


def save_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, unique_id=None, async_save=False):
    """Write ``state_dict`` (nested dicts of :class:`LocalShard`\\ s,
    :class:`ShardChunks`, tensors, ``Tensor``\\ s, numpy arrays and JSON
    scalars) as save ``unique_id`` (default: one past the newest) under
    ``path``; see the module docstring for the layout.  Every rank of
    ``process_group`` calls.  Older saves are removed once every rank's
    files of this one are on disk."""
    rank, world = rank_world(process_group)
    group = coord_group(process_group)
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
    sid = _agreed_save_id(path, unique_id, rank, group, coordinator_rank)
    shard_file = f"{rank}_0.{sid}.distcp.npz"
    arrays = {}
    meta = {"world_size": world, "save_id": sid, "tensors": {}}
    for k, v in _flatten(state_dict).items():
        if isinstance(v, LocalShard):
            v = ShardChunks.capture(v)
        if isinstance(v, ShardChunks):
            entry = {"shape": list(v.shape), "dtype": v.dtype, "chunks": []}
            for i, (offset, cshape, data) in enumerate(v.chunks):
                key = f"{k}##{i}"
                arrays[key] = (to_numpy(data) if isinstance(
                    data, torch.Tensor) else data)
                entry["chunks"].append({"offset": list(offset),
                                        "shape": list(cshape),
                                        "file": shard_file, "key": key})
            meta["tensors"][k] = entry
        elif isinstance(v, (Tensor, torch.Tensor, np.ndarray)):
            # whole and alike on every rank: the coordinator writes it
            entry = {"chunks": []}
            if rank == coordinator_rank:
                # async: own the bytes now; the caller may write the
                # tensor in place while the writer thread runs
                arr, dt = _host_array(v, copy=async_save)
                key = f"{k}##0"
                arrays[key] = arr
                entry["chunks"].append({"offset": [0] * arr.ndim,
                                        "shape": list(arr.shape),
                                        "file": shard_file, "key": key})
            else:
                t = v._data if isinstance(v, Tensor) else v
                dt = (dtype_name(t.dtype) if isinstance(t, torch.Tensor)
                      else _np_dtype_name(t))
            meta["tensors"][k] = {"shape": list(v.shape), "dtype": dt,
                                  **entry}
        else:
            meta["tensors"][k] = {"value": v.item() if isinstance(
                v, np.generic) else v}

    def _write():
        err = None
        try:
            for entry in meta["tensors"].values():
                for chunk in entry.get("chunks", ()):
                    chunk["crc32"] = _crc32(arrays[chunk["key"]])
            # stage to tmp names, then rename into place: versioned names
            # mean nothing of an older save id is touched
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
        except Exception as e:  # noqa: BLE001 - agreed on, then raised
            err = e
        # every rank learns whether every rank wrote (and waits for them)
        everyone = agree(err is None, group)
        if err is not None:
            raise err
        if not everyone:
            raise OSError(f"save {sid} under {path}: another rank failed to "
                          "write its files")
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
        self._decoded = {}   # an NpzFile reads a member again on each []

    def get(self, chunk):
        fname, key = chunk["file"], chunk["key"]
        if (fname, key) in self._decoded:
            return self._decoded[(fname, key)]
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
        self._decoded[(fname, key)] = arr
        return arr

    def clear_cache(self):
        self._decoded.clear()

    def close(self):
        for f in self._files.values():
            f.close()


def _assemble(dtype, chunks, reader, offset, shape):
    """The box at ``offset`` of ``shape`` of a saved tensor, filled from
    the chunk boxes that cover it (the reshard-on-load arithmetic)."""
    for chunk in chunks:
        if (tuple(chunk["offset"]) == tuple(offset)
                and tuple(chunk["shape"]) == tuple(shape)):
            return from_numpy(reader.get(chunk), dtype)
    out = torch.empty(shape, dtype=_TORCH_DTYPES[dtype])
    filled = torch.zeros(shape, dtype=torch.bool)
    for chunk in chunks:
        lo = [max(a, c) for a, c in zip(offset, chunk["offset"])]
        hi = [min(a + n, c + m) for a, n, c, m in zip(
            offset, shape, chunk["offset"], chunk["shape"])]
        if any(l >= h for l, h in zip(lo, hi)):
            continue
        dst = tuple(slice(l - a, h - a) for l, h, a in zip(lo, hi, offset))
        src = tuple(slice(l - c, h - c)
                    for l, h, c in zip(lo, hi, chunk["offset"]))
        out[dst] = from_numpy(reader.get(chunk), dtype)[src]
        filled[dst] = True
    if not bool(filled.all()):
        raise RuntimeError(
            "checkpoint is missing chunks of a tensor (multi-process "
            "checkpoint loaded with too few metadata files?)")
    return out


def load_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, unique_id=None, offload=False):
    """Fill the targets of ``state_dict`` (nested dicts of tensors,
    ``Tensor``\\ s and :class:`LocalShard`\\ s) in place from the newest
    complete save under ``path``, whatever mesh it was saved on, cast to
    each target's dtype: a tensor takes the whole saved tensor, a
    :class:`LocalShard` its boxes of it.  A shape mismatch (of the whole
    tensors) raises ``ValueError``, a corrupt chunk
    :class:`CheckpointCorrupt`.  No collective: each rank reads what it
    needs."""
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
            if isinstance(tgt, torch.Tensor):
                tgt = LocalShard(tgt)
            if not isinstance(tgt, LocalShard):
                continue
            shape = tuple(info["shape"])
            if tgt.shape != shape:
                raise ValueError(
                    f"checkpoint tensor {k!r} has shape {shape}, target "
                    f"has {tgt.shape}")
            with torch.no_grad():
                for off, shp, loc in tgt.load_boxes():
                    tgt.view(loc, shp).copy_(_assemble(
                        info["dtype"], info["chunks"], reader, off, shp))
            reader.clear_cache()   # host memory bound to one tensor's
    finally:
        reader.close()
    return state_dict


__all__ = ["CheckpointCorrupt", "LocalShard", "ShardChunks",
           "load_state_dict", "save_state_dict", "wait_async_save"]
