"""The port's one-process ``distributed.checkpoint`` against the JAX
package's files.

* A dict of fp32, int32 and bf16 arrays (and a JSON scalar) saved by the
  JAX ``save_state_dict`` loads into the port bit for bit; the port's
  save of the same dict is the same files: equal metadata (crc32s
  included) and equal chunk bytes, bf16 as numpy's ``|V2``.  The JAX
  loader reads the port's fp32 and int32 chunks bit for bit; it cannot
  read bf16 chunks at all, its own included (numpy has no cast from
  ``|V2`` to ``ml_dtypes.bfloat16``: ``ValueError``), a reference fault
  the port does not copy (ROADMAP.md C).
* A corrupt chunk raises ``CheckpointCorrupt`` naming it, whether the
  payload was rewritten in a valid archive (the crc32) or a byte was
  flipped in place (the archive's own CRC).
* An interrupted re-save keeps the previous save loadable; the newest
  complete save wins and older ones are collected; async saves, their
  errors and concurrent waiters.  Saves over several processes and onto
  other meshes are ``tests/test_torch_mesh_checkpoint.py``'s.

Every comparison is exact (bytes).
"""

import json
import os
import threading
import time
import zipfile

import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu_torch.distributed import checkpoint as tck

RNG = np.random.default_rng(7)
F32 = RNG.standard_normal((3, 5)).astype(np.float32)
I32 = RNG.integers(-1000, 1000, (7,), dtype=np.int32)
BF16 = torch.from_numpy(RNG.standard_normal((4, 6)).astype(np.float32)) \
    .bfloat16()


def _jax_dict(bf16=True):
    d = {"f": jp.to_tensor(F32), "nested": {"i": jp.to_tensor(I32)},
         "n": 3}
    if bf16:
        d["b"] = jp.to_tensor(BF16.float().numpy()).astype("bfloat16")
    return d


def _torch_dict(bf16=True):
    d = {"f": torch.from_numpy(F32.copy()),
         "nested": {"i": torch.from_numpy(I32.copy())}, "n": 3}
    if bf16:
        d["b"] = BF16.clone()
    return d


def _torch_targets(bf16=True):
    d = {"f": torch.zeros(3, 5), "nested": {"i": torch.zeros(
        7, dtype=torch.int32)}}
    if bf16:
        d["b"] = torch.zeros(4, 6, dtype=torch.bfloat16)
    return d


def _files(path):
    meta = json.load(open(os.path.join(path, "0.0.metadata.json")))
    with np.load(os.path.join(path, "0_0.0.distcp.npz")) as z:
        chunks = {k: (z[k].dtype.str, z[k].shape, z[k].tobytes())
                  for k in z.files}
    return meta, chunks


def _assert_loaded(t):
    assert torch.equal(t["f"], torch.from_numpy(F32))
    assert torch.equal(t["nested"]["i"], torch.from_numpy(I32))
    if "b" in t:
        assert torch.equal(t["b"].view(torch.int16), BF16.view(torch.int16))


def test_jax_save_loads_into_the_port_bit_for_bit(tmp_path):
    jck.save_state_dict(_jax_dict(), str(tmp_path))
    t = _torch_targets()
    tck.load_state_dict(t, str(tmp_path))
    _assert_loaded(t)


def test_port_save_is_the_jax_files(tmp_path):
    jck.save_state_dict(_jax_dict(), str(tmp_path / "jax"))
    tck.save_state_dict(_torch_dict(), str(tmp_path / "torch"))
    jm, jc = _files(tmp_path / "jax")
    tm, tc = _files(tmp_path / "torch")
    assert tm == jm
    assert tc == jc
    assert tc["b##0"][0] == "|V2"


def test_port_save_loads_into_jax(tmp_path):
    tck.save_state_dict(_torch_dict(bf16=False), str(tmp_path))
    tgt = {"f": jp.zeros([3, 5]), "nested": {"i": jp.zeros([7],
                                                           dtype="int32")}}
    jck.load_state_dict(tgt, str(tmp_path))
    np.testing.assert_array_equal(np.asarray(tgt["f"].numpy()), F32)
    np.testing.assert_array_equal(np.asarray(tgt["nested"]["i"].numpy()),
                                  I32)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_jax_loader_cannot_read_bf16_chunks_the_port_can(tmp_path, writer):
    if writer == "jax":
        jck.save_state_dict(_jax_dict(), str(tmp_path))
    else:
        tck.save_state_dict(_torch_dict(), str(tmp_path))
    with pytest.raises(ValueError, match="No cast function"):
        jck.load_state_dict({"b": jp.zeros([4, 6], dtype="bfloat16")},
                            str(tmp_path))
    t = _torch_targets()
    tck.load_state_dict(t, str(tmp_path))
    _assert_loaded(t)


def test_load_casts_to_the_target_dtype_and_checks_shapes(tmp_path):
    tck.save_state_dict(_torch_dict(), str(tmp_path))
    wide = {"b": torch.zeros(4, 6), "f": torch.zeros(3, 5,
                                                     dtype=torch.float64)}
    tck.load_state_dict(wide, str(tmp_path))
    assert torch.equal(wide["b"], BF16.float())
    assert torch.equal(wide["f"], torch.from_numpy(F32).double())
    with pytest.raises(ValueError, match="shape"):
        tck.load_state_dict({"f": torch.zeros(5, 3)}, str(tmp_path))


def _rewrite_chunk(path, key):
    """Rewrite one chunk with a flipped byte in a valid archive."""
    fpath = os.path.join(path, "0_0.0.distcp.npz")
    with np.load(fpath) as z:
        arrays = {k: np.array(z[k]) for k in z.files}
    raw = arrays[key].view(np.uint8).copy()
    raw.reshape(-1)[0] ^= 0xFF
    arrays[key] = raw.view(arrays[key].dtype).reshape(arrays[key].shape)
    with open(fpath, "wb") as f:
        np.savez(f, **arrays)


def _flip_in_place(path, key):
    """Flip a payload byte inside the archive, leaving its CRC stale."""
    fpath = os.path.join(path, "0_0.0.distcp.npz")
    with zipfile.ZipFile(fpath) as z:
        info = z.getinfo(key + ".npy")
    with open(fpath, "r+b") as f:
        f.seek(info.header_offset + 26)
        name_len, extra_len = np.frombuffer(f.read(4), "<u2")
        at = info.header_offset + 30 + name_len + extra_len + \
            info.file_size - 1
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("corrupt", [_rewrite_chunk, _flip_in_place])
def test_corrupt_chunk_raises_naming_it(tmp_path, corrupt):
    tck.save_state_dict(_torch_dict(), str(tmp_path))
    corrupt(str(tmp_path), "f##0")
    with pytest.raises(tck.CheckpointCorrupt, match="'f##0'"):
        tck.load_state_dict(_torch_targets(), str(tmp_path))
    t = {"b": torch.zeros(4, 6, dtype=torch.bfloat16)}
    tck.load_state_dict(t, str(tmp_path))     # the other chunks still load
    assert torch.equal(t["b"], BF16)


def test_interrupted_resave_keeps_previous_loadable(tmp_path):
    tck.save_state_dict(_torch_dict(), str(tmp_path))
    # an interrupted save: metadata for sid 5 claims world 2, one file
    with open(os.path.join(tmp_path, "0.5.metadata.json"), "w") as f:
        json.dump({"world_size": 2, "save_id": 5,
                   "tensors": {"f": {"shape": [3, 5], "dtype": "float32",
                                     "chunks": []}}}, f)
    t = _torch_targets()
    tck.load_state_dict(t, str(tmp_path))
    _assert_loaded(t)


def test_resave_newest_wins_and_gc(tmp_path):
    tck.save_state_dict({"t": torch.zeros(4)}, str(tmp_path))
    tck.save_state_dict({"t": torch.full((4,), 3.0)}, str(tmp_path))
    t = {"t": torch.zeros(4)}
    tck.load_state_dict(t, str(tmp_path))
    assert torch.equal(t["t"], torch.full((4,), 3.0))
    assert sorted(os.listdir(tmp_path)) == ["0.1.metadata.json",
                                            "0_0.1.distcp.npz"]
    with pytest.raises(ValueError, match="unique_id"):
        tck.save_state_dict({"t": torch.zeros(4)}, str(tmp_path),
                            unique_id=1)


def test_async_save_owns_its_bytes_and_is_readable_after_wait(tmp_path):
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    tck.save_state_dict({"w": w}, str(tmp_path), async_save=True)
    w.add_(100)                # the caller goes on writing in place
    tck.wait_async_save()
    t = {"w": torch.zeros(2, 3)}
    tck.load_state_dict(t, str(tmp_path))
    assert torch.equal(t["w"], torch.arange(6.0).reshape(2, 3))


def test_async_failure_surfaced_with_cause(tmp_path, monkeypatch):
    boom = OSError("disk gone")

    def bad_savez(f, **kw):
        raise boom
    monkeypatch.setattr(tck.np, "savez", bad_savez)
    tck.save_state_dict({"w": torch.ones(2)}, str(tmp_path),
                        async_save=True)
    with pytest.raises(RuntimeError, match="async checkpoint save") as ei:
        tck.wait_async_save()
    assert ei.value.__cause__ is boom
    tck.wait_async_save()      # drained


def test_all_async_errors_surfaced():
    with tck._ASYNC_LOCK:
        tck._ASYNC_ERRORS.extend([OSError("first failure"),
                                  OSError("second failure")])
    with pytest.raises(RuntimeError) as ei:
        tck.wait_async_save()
    msg = str(ei.value)
    assert "2 async checkpoint saves failed" in msg
    assert "first failure" in msg and "second failure" in msg
    tck.wait_async_save()


def test_concurrent_waiters_all_complete():
    release = threading.Event()
    writer = threading.Thread(target=release.wait, daemon=True)
    with tck._ASYNC_LOCK:
        tck._ASYNC_THREADS.append(writer)
    writer.start()
    results = []

    def waiter():
        try:
            tck.wait_async_save()
            results.append("ok")
        except BaseException as e:  # pragma: no cover - fail loudly
            results.append(e)
    waiters = [threading.Thread(target=waiter) for _ in range(4)]
    for t in waiters:
        t.start()
    time.sleep(0.05)
    release.set()
    for t in waiters:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in waiters)
    assert results == ["ok"] * 4
    assert not tck._ASYNC_THREADS


def test_jax_save_of_a_sharded_array_assembles_in_the_port(tmp_path):
    """A JAX array sharded over 4 of the virtual CPU devices is saved as
    4 chunk boxes; the port assembles the whole tensor from them."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("a", "b"))
    w = jp.to_tensor(F32.repeat(2, 0)[:6, :4].copy())
    w._data = jax.device_put(w._data, NamedSharding(mesh,
                                                    PartitionSpec("a", "b")))
    jck.save_state_dict({"w": w}, str(tmp_path))
    meta = json.load(open(os.path.join(tmp_path, "0.0.metadata.json")))
    assert len(meta["tensors"]["w"]["chunks"]) == 4
    t = {"w": torch.zeros(6, 4)}
    tck.load_state_dict(t, str(tmp_path))
    assert torch.equal(t["w"], torch.from_numpy(F32.repeat(2, 0)[:6, :4]))
