"""The port's ``CheckpointManager`` and ``FaultTolerantTrainer``: the
counterparts of ``tests/test_resilience.py``'s classes, on the CPU, on
its tiny net (``Linear(6, 12)``, ``GELU``, ``Linear(12, 3)`` in a
``torch.nn.Sequential``, AdamW, MSE), and against the JAX package.

* Round trip, keep-last GC, async saves, one ``jit.syncs`` a save and no
  CUDA-graph recapture; atomicity under ``ckpt_crash``; the checksum
  fallback and a torn manifest; write retry and exhaustion; the
  GradScaler and scheduler state riding the checkpoint.
* Preemption, loader and ``nan_loss`` recovery, single steps and fused
  windows of 2, restart from disk: the port's losses, parameters,
  generator state and lr bit-equal to the port's own uninterrupted run.
* Against JAX, from the same weights on the same data: the port's
  uninterrupted trainer losses equal the JAX trainer's within 5e-6
  relative, about 40 fp32 ulps (XLA and torch sum a layer's products in
  other orders, and AdamW at lr 5e-2 carries the difference from step to
  step; the largest gap seen was 9.1e-7 after 10 steps and 1.1e-7 after
  3); a JAX ``CheckpointManager`` save of
  the net restores into the port (parameters and AdamW state bit for
  bit) and the port's continuation equals JAX's within the same bound.

The JAX histograms and flight events these runs fill are removed at the
end of the module.
"""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.jit as jjit
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tp
from paddle_tpu.io import DataLoader as JLoader
from paddle_tpu.io import TensorDataset as JDataset
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.profiler import flight as jflight
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu.resilience import CheckpointManager as JManager
from paddle_tpu.resilience import FaultTolerantTrainer as JTrainer
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.core.tensor import unwrap
from paddle_tpu_torch.io import (DataLoader, DevicePrefetcher,
                                  StackingPrefetcher, TensorDataset)
from paddle_tpu_torch.optimizer import lr as lrsched
from paddle_tpu_torch.profiler import counters
from paddle_tpu_torch.profiler import flight as tflight
from paddle_tpu_torch.resilience import (CheckpointCorrupt,
                                         CheckpointLayoutError,
                                         CheckpointManager,
                                         CheckpointWriteError,
                                         FaultTolerantTrainer, faultinject)
from paddle_tpu_torch.resilience.manager import model_state
from paddle_tpu_torch.tensor.random import default_generator

RTOL = 5e-6


@pytest.fixture(autouse=True)
def cpu_device(tmp_path):
    prev = tdevice._CURRENT[0]
    tp.set_device("cpu")
    tflight.configure(directory=str(tmp_path / "flight"))
    yield
    tdevice._CURRENT[0] = prev
    tflight.clear()


@pytest.fixture(scope="module", autouse=True)
def _jax_registries():
    yield
    with jmetrics._HLOCK:
        for name in ("resilience.save_ms", "resilience.restore_ms",
                     "io.queue_wait_ns", "io.prefetch_stall_ns"):
            jmetrics._HISTS.pop(name, None)
    jflight.clear()


def _mse(m, x, y):
    return ((unwrap(m(x)) - y) ** 2).mean()


def _net():
    return torch.nn.Sequential(nn.Linear(6, 12), nn.GELU(),
                               nn.Linear(12, 3))


def _build(seed=7, fused_steps=1, use_sched=False, weights=None):
    tp.seed(seed)
    net = _net()
    if weights is not None:
        for k, t in model_state(net).items():
            t.data.copy_(torch.from_numpy(weights[k]))
    sched = lrsched.StepDecay(learning_rate=5e-2, step_size=3,
                              gamma=0.5) if use_sched else None
    opt = tp.AdamW(sched if sched is not None else 5e-2,
                   parameters=net.parameters())
    step = tp.CompiledTrainStep(net, _mse, opt, fused_steps=fused_steps)
    return net, opt, step, sched


def _arrays(n_batches, batch=4, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(n_batches * batch, 6).astype("float32"),
            rng.randn(n_batches * batch, 3).astype("float32"))


def _dataset(n_batches, batch=4, seed=3):
    return TensorDataset([tp.to_tensor(a)
                          for a in _arrays(n_batches, batch, seed)])


def _factory(ds, batch=4):
    return lambda epoch: DataLoader(ds, batch_size=batch, shuffle=False)


def _params(net):
    return {k: v.detach().clone() for k, v in model_state(net).items()}


def _same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _run_steps(step, ds, n, batch=4, start=0):
    """Steps ``start .. start + n - 1`` of the epoch: single steps, or
    windows of ``fused_steps`` (``n`` a multiple of it)."""
    k = step.fused_steps
    loader = DataLoader(ds, batch_size=batch)
    items = (DevicePrefetcher(loader, start_offset=start) if k == 1
             else StackingPrefetcher(loader, k, start_offset=start))
    losses = []
    for item in items:
        if len(losses) >= n:
            break
        out = step(*item) if k == 1 else step(item)
        losses += torch.atleast_1d(out).tolist()
    return losses


class TestCheckpointManagerRoundtrip:
    def test_roundtrip_restores_exact_state(self, tmp_path):
        net, opt, step, _ = _build()
        ds = _dataset(8)
        _run_steps(step, ds, 3)
        mgr = CheckpointManager(tmp_path, keep_last=3)
        mgr.save(step, 3, cursor={"epoch": 0, "offset": 3})
        saved = _params(net)
        saved_opt = opt.state_dict()
        saved_rng = default_generator().get_state()
        _run_steps(step, ds, 2)
        assert not any(torch.equal(v, saved[k])
                       for k, v in _params(net).items())
        default_generator().manual_seed(123)
        info = mgr.restore(step)
        assert info["step"] == 3
        assert info["cursor"] == {"epoch": 0, "offset": 3}
        assert _same(_params(net), saved)
        now = opt.state_dict()
        assert now["step"] == saved_opt["step"] == 3
        for acc, store in saved_opt["accumulators"].items():
            for name, t in store.items():
                assert torch.equal(now["accumulators"][acc][name], t)
        assert torch.equal(default_generator().get_state(), saved_rng)

    def test_restore_returns_none_when_empty(self, tmp_path):
        _, _, step, _ = _build()
        assert CheckpointManager(tmp_path).restore(step) is None
        assert CheckpointManager(tmp_path).latest() is None

    @pytest.mark.parametrize("fused_steps", [1, 2])
    def test_restored_continuation_matches_uninterrupted(self, tmp_path,
                                                         fused_steps):
        ds = _dataset(8)
        _, _, ref_step, _ = _build(seed=11, fused_steps=fused_steps)
        ref = _run_steps(ref_step, ds, 6)
        net, opt, step, _ = _build(seed=11, fused_steps=fused_steps)
        got = _run_steps(step, ds, 4)
        mgr = CheckpointManager(tmp_path)
        mgr.save(step, 4)
        _run_steps(step, ds, 1)      # wander off; the restore undoes it
        mgr.restore(step)
        got += _run_steps(step, ds, 2, start=4)
        assert got == ref

    def test_keep_last_gc(self, tmp_path):
        _, _, step, _ = _build()
        _run_steps(step, _dataset(2), 1)
        mgr = CheckpointManager(tmp_path, keep_last=2)
        before = counters.snapshot()
        for s in range(1, 6):
            mgr.save(step, s)
        kept = sorted(d for d in os.listdir(tmp_path)
                      if d.startswith("step-"))
        assert kept == ["step-00000004", "step-00000005"]
        assert mgr.latest() == 5
        assert counters.delta(before).get("resilience.gc_removed", 0) == 3

    def test_async_save_overlaps_and_restores(self, tmp_path):
        net, _, step, _ = _build()
        ds = _dataset(8)
        _run_steps(step, ds, 2)
        mgr = CheckpointManager(tmp_path, async_save=True)
        mgr.save(step, 2)            # the write runs on a daemon thread
        saved = _params(net)
        _run_steps(step, ds, 2)      # training goes on, in place
        mgr.wait()
        mgr.restore(step)
        assert _same(_params(net), saved)

    def test_save_costs_exactly_one_sync_and_no_capture(self, tmp_path):
        _, _, step, _ = _build(fused_steps=2)
        ds = _dataset(8)
        _run_steps(step, ds, 6)     # a priming window, then steady ones
        mgr = CheckpointManager(tmp_path)
        before = counters.snapshot()
        mgr.save(step, 6)
        d = counters.delta(before)
        assert d.get("jit.syncs", 0) == 1
        assert d.get("jit.captures", 0) == 0
        before = counters.snapshot()
        mgr.save(step, 7)            # nothing dispatched since: no sync
        assert counters.delta(before).get("jit.syncs", 0) == 0

    def test_layout_mismatch_raises_at_once(self, tmp_path):
        _, _, step, _ = _build()
        _run_steps(step, _dataset(2), 1)
        CheckpointManager(tmp_path).save(step, 1)
        other = torch.nn.Sequential(nn.Linear(6, 5), nn.GELU(),
                                    nn.Linear(5, 3))
        opt = tp.AdamW(5e-2, parameters=other.parameters())
        with pytest.raises(CheckpointLayoutError):
            CheckpointManager(tmp_path).restore(
                tp.CompiledTrainStep(other, _mse, opt))


class TestAtomicity:
    def test_crash_mid_save_leaves_previous_loadable(self, tmp_path):
        net, _, step, _ = _build()
        ds = _dataset(8)
        _run_steps(step, ds, 2)
        mgr = CheckpointManager(tmp_path)
        mgr.save(step, 2)
        saved = _params(net)
        _run_steps(step, ds, 2)
        with faultinject.fault_schedule("ckpt_crash@1"):
            with pytest.raises(faultinject.SimulatedCrash):
                mgr.save(step, 4)
            assert faultinject.fired == [("ckpt_crash", 1)]
        names = os.listdir(tmp_path)
        assert "step-00000004" not in names
        assert any(n.startswith(".tmp-") for n in names)
        assert mgr.latest() == 2
        assert mgr.restore(step)["step"] == 2
        assert _same(_params(net), saved)

    def test_crash_is_not_swallowed_by_retry(self, tmp_path):
        assert not issubclass(faultinject.SimulatedCrash, Exception)
        _, _, step, _ = _build()
        _run_steps(step, _dataset(2), 1)
        mgr = CheckpointManager(tmp_path, retries=5)
        with faultinject.fault_schedule("ckpt_crash@0*5"):
            with pytest.raises(faultinject.SimulatedCrash):
                mgr.save(step, 1)
            assert faultinject.fired == [("ckpt_crash", 0)]

    def test_next_successful_save_cleans_stale_tmp(self, tmp_path):
        _, _, step, _ = _build()
        _run_steps(step, _dataset(4), 2)
        mgr = CheckpointManager(tmp_path)
        with faultinject.fault_schedule("ckpt_crash@0"):
            with pytest.raises(faultinject.SimulatedCrash):
                mgr.save(step, 2)
        assert any(n.startswith(".tmp-") for n in os.listdir(tmp_path))
        mgr.save(step, 3)
        assert not any(n.startswith(".tmp-") for n in os.listdir(tmp_path))
        assert mgr.latest() == 3


def _corrupt_one_chunk(step_dir, key_prefix="model/"):
    """Rewrite one chunk with flipped bytes in a valid archive."""
    fname = next(n for n in os.listdir(step_dir)
                 if n.endswith(".distcp.npz"))
    fpath = os.path.join(step_dir, fname)
    with np.load(fpath) as z:
        arrays = {k: np.array(z[k]) for k in z.files}
    victim = next(k for k in arrays if k.startswith(key_prefix))
    raw = arrays[victim].view(np.uint8).copy()
    raw.reshape(-1)[0] ^= 0xFF
    arrays[victim] = raw.view(arrays[victim].dtype).reshape(
        arrays[victim].shape)
    with open(fpath, "wb") as f:
        np.savez(f, **arrays)
    return victim


class TestChecksum:
    def test_corrupt_chunk_raises_naming_it(self, tmp_path):
        _, _, step, _ = _build()
        _run_steps(step, _dataset(4), 2)
        mgr = CheckpointManager(tmp_path)
        mgr.save(step, 2)
        victim = _corrupt_one_chunk(mgr._dir(2))
        before = counters.snapshot()
        with pytest.raises(CheckpointCorrupt) as ei:
            mgr.restore(step)
        chain = str(ei.value) + str(ei.value.__cause__ or "")
        assert "checksum mismatch" in chain and victim in chain
        assert counters.delta(before).get(
            "resilience.corrupt_detected", 0) >= 1

    @pytest.mark.parametrize("prefix", ["model/", "opt/"])
    def test_corruption_falls_back_to_older_checkpoint(self, tmp_path,
                                                       prefix):
        net, _, step, _ = _build()
        ds = _dataset(8)
        _run_steps(step, ds, 2)
        mgr = CheckpointManager(tmp_path)
        mgr.save(step, 2)
        older = _params(net)
        _run_steps(step, ds, 2)
        mgr.save(step, 4)
        _corrupt_one_chunk(mgr._dir(4), prefix)
        before = counters.snapshot()
        assert mgr.restore(step)["step"] == 2
        assert _same(_params(net), older)
        d = counters.delta(before)
        assert d.get("resilience.corrupt_detected", 0) >= 1
        assert d.get("resilience.restores", 0) == 1

    def test_truncated_manifest_falls_back(self, tmp_path):
        _, _, step, _ = _build()
        ds = _dataset(8)
        _run_steps(step, ds, 2)
        mgr = CheckpointManager(tmp_path)
        mgr.save(step, 2)
        _run_steps(step, ds, 2)
        mgr.save(step, 4)
        with open(os.path.join(mgr._dir(4), "MANIFEST.json"), "w") as f:
            f.write('{"format": 1, "step":')     # a torn write
        assert mgr.restore(step)["step"] == 2


class TestWriteRetry:
    def test_transient_write_error_retried(self, tmp_path):
        _, _, step, _ = _build()
        _run_steps(step, _dataset(4), 2)
        mgr = CheckpointManager(tmp_path, retries=3, backoff_s=0.001)
        before = counters.snapshot()
        with faultinject.fault_schedule("ckpt_write@0*2"):
            mgr.save(step, 2)
            assert faultinject.fired == [("ckpt_write", 0)] * 2
        d = counters.delta(before)
        assert d.get("resilience.retries", 0) == 2
        assert d.get("resilience.saves", 0) == 1
        assert d.get("resilience.save_failures", 0) == 0
        assert mgr.restore(step)["step"] == 2

    @pytest.mark.parametrize("async_save", [False, True])
    def test_retries_exhausted_raises_write_error(self, tmp_path,
                                                  async_save):
        _, _, step, _ = _build()
        _run_steps(step, _dataset(4), 2)
        mgr = CheckpointManager(tmp_path, retries=2, backoff_s=0.001,
                                async_save=async_save)
        before = counters.snapshot()
        with faultinject.fault_schedule("ckpt_write@0*5"):
            with pytest.raises(CheckpointWriteError):
                mgr.save(step, 2)
                mgr.wait()           # an async failure surfaces here
        d = counters.delta(before)
        assert d.get("resilience.save_failures", 0) == 1
        assert d.get("resilience.retries", 0) == 2
        assert d.get("resilience.saves", 0) == 0
        assert mgr.latest() is None


class _Baseline:
    """An uninterrupted trainer run: the bit-identity reference."""

    def __init__(self, tmp_path, steps=10, save_every=4, fused_steps=1,
                 use_sched=False, n_batches=12, seed=7):
        net, opt, step, sched = _build(seed=seed, fused_steps=fused_steps,
                                       use_sched=use_sched)
        ds = _dataset(n_batches)
        trainer = FaultTolerantTrainer(
            step, _factory(ds), CheckpointManager(tmp_path, keep_last=2),
            scheduler=sched, epochs=2, max_steps=steps,
            save_every=save_every)
        self.losses = trainer.run()
        self.goodput = trainer.goodput.report(publish=False)
        self.params = _params(net)
        self.rng = default_generator().get_state()
        self.lr = opt.get_lr()
        self.ds, self.seed = ds, seed
        self.fused_steps, self.use_sched = fused_steps, use_sched
        self.steps, self.save_every = steps, save_every

    def faulted_run(self, tmp_path, schedule, expect_recoveries=1):
        net, opt, step, sched = _build(seed=self.seed,
                                       fused_steps=self.fused_steps,
                                       use_sched=self.use_sched)
        before = counters.snapshot()
        with faultinject.fault_schedule(schedule):
            trainer = FaultTolerantTrainer(
                step, _factory(self.ds),
                CheckpointManager(tmp_path, keep_last=2),
                scheduler=sched, epochs=2, max_steps=self.steps,
                save_every=self.save_every)
            losses = trainer.run()
        assert trainer.recoveries == expect_recoveries
        d = counters.delta(before)
        assert d.get("resilience.recoveries", 0) == expect_recoveries
        assert d.get("resilience.restores", 0) == expect_recoveries
        assert trainer.goodput.report(publish=False)["accounted"] >= 0.99
        self.faulted = trainer
        return net, opt, losses, d


class TestBitIdenticalResume:
    @pytest.mark.parametrize("fused_steps", [1, 2])
    def test_preempt_resume_bit_identity(self, tmp_path, fused_steps):
        """Straight steps against preempt + restore + the rest: equal
        losses, parameters, generator state and lr."""
        base = _Baseline(tmp_path / "base", use_sched=True,
                         fused_steps=fused_steps,
                         steps=10 if fused_steps == 1 else 8)
        net, opt, losses, d = base.faulted_run(tmp_path / "faulted",
                                               "preempt@4")
        assert d.get("resilience.recovered.SimulatedPreemption", 0) == 1
        assert losses == base.losses
        assert _same(_params(net), base.params)
        assert torch.equal(default_generator().get_state(), base.rng)
        assert opt.get_lr() == base.lr
        assert base.goodput["accounted"] >= 0.99

    def test_preempt_mid_save_interval(self, tmp_path):
        base = _Baseline(tmp_path / "base")
        _, _, losses, d = base.faulted_run(tmp_path / "faulted", "preempt@6")
        assert losses == base.losses
        # replay from offset 4: the batches this run's prefetchers skipped
        # (the process-wide io.skipped_batches adds any other run's)
        assert base.faulted.replayed_batches == 4

    @pytest.mark.parametrize("fused_steps", [1, 2])
    def test_loader_fault_recovery(self, tmp_path, fused_steps):
        base = _Baseline(tmp_path / "base", fused_steps=fused_steps)
        _, _, losses, d = base.faulted_run(tmp_path / "faulted", "loader@5")
        assert d.get("resilience.recovered.InjectedLoaderError", 0) == 1
        assert losses == base.losses

    @pytest.mark.parametrize("fused_steps", [1, 2])
    def test_nan_loss_recovery(self, tmp_path, fused_steps):
        base = _Baseline(tmp_path / "base", fused_steps=fused_steps)
        net, _, losses, d = base.faulted_run(tmp_path / "faulted",
                                             "nan_loss@5")
        assert d.get("resilience.recovered.NonFiniteLossError", 0) == 1
        assert all(np.isfinite(v) for v in losses.values())
        assert losses == base.losses
        assert _same(_params(net), base.params)

    def test_multiple_faults_one_run(self, tmp_path):
        base = _Baseline(tmp_path / "base")
        _, _, losses, d = base.faulted_run(
            tmp_path / "faulted", "preempt@3;nan_loss@7",
            expect_recoveries=2)
        assert losses == base.losses
        assert d.get("resilience.faults_injected", 0) == 2

    def test_restart_from_disk_resumes(self, tmp_path):
        """A new trainer over the same directory, its net from another
        seed: it resumes from the last save, replays nothing committed
        and ends on the uninterrupted trajectory."""
        base = _Baseline(tmp_path / "base", steps=8)
        ck = tmp_path / "faulted"
        _, _, step1, _ = _build(seed=7)
        first = FaultTolerantTrainer(step1, _factory(base.ds),
                                     CheckpointManager(ck, keep_last=2),
                                     epochs=2, max_steps=4,
                                     save_every=4).run()
        assert sorted(first) == [1, 2, 3, 4]
        net2, _, step2, _ = _build(seed=99)
        second = FaultTolerantTrainer(step2, _factory(base.ds),
                                      CheckpointManager(ck, keep_last=2),
                                      epochs=2, max_steps=8,
                                      save_every=4).run()
        assert sorted(second) == [5, 6, 7, 8]
        assert {**first, **second} == base.losses
        assert _same(_params(net2), base.params)

    def test_max_recoveries_exhausted_reraises(self, tmp_path):
        _, _, step, _ = _build()
        with faultinject.fault_schedule("preempt@2*10"):
            trainer = FaultTolerantTrainer(
                step, _factory(_dataset(6)), CheckpointManager(tmp_path),
                epochs=1, max_steps=6, save_every=100, max_recoveries=2)
            with pytest.raises(faultinject.SimulatedPreemption):
                trainer.run()
        assert trainer.recoveries == 3


class TestScalerAndSchedulerState:
    def test_grad_scaler_state_rides_the_checkpoint(self, tmp_path):
        tp.seed(13)
        net = nn.Linear(6, 3)
        opt = tp.AdamW(5e-2, parameters=net.parameters())
        step = tp.CompiledTrainStep(
            net, _mse, opt, scaler=GradScaler(init_loss_scaling=1024.0,
                                              incr_every_n_steps=2))
        ds = _dataset(8)
        _run_steps(step, ds, 3)
        mgr = CheckpointManager(tmp_path)
        mgr.save(step, 3)
        saved = step.scaler.state_dict()
        assert saved["scale"] != 1024.0
        _run_steps(step, ds, 2)
        assert step.scaler.state_dict() != saved
        mgr.restore(step)
        assert step.scaler.state_dict() == saved

    def test_scheduler_and_lr_tensors_restored(self, tmp_path):
        net, opt, step, sched = _build(use_sched=True)
        ds = _dataset(8)
        for i, item in enumerate(DataLoader(ds, batch_size=4)):
            if i == 4:
                break
            step(*item)
            sched.step()
        mgr = CheckpointManager(tmp_path)
        mgr.save(step, 4, scheduler=sched)
        want = (sched.state_dict(), [t.clone() for t in opt._lr_tensors])
        for _ in range(3):
            sched.step()
        step(*next(iter(DataLoader(ds, batch_size=4))))
        mgr.restore(step, scheduler=sched)
        assert sched.state_dict() == want[0]
        assert all(torch.equal(a, b)
                   for a, b in zip(opt._lr_tensors, want[1]))


# -- against the JAX package -------------------------------------------------
def _jax_build(seed=7, use_sched=True):
    jp.seed(seed)
    net = jnn.Sequential(jnn.Linear(6, 12), jnn.GELU(), jnn.Linear(12, 3))
    sched = jlr.StepDecay(learning_rate=5e-2, step_size=3,
                          gamma=0.5) if use_sched else None
    opt = jp.optimizer.AdamW(sched if sched is not None else 5e-2,
                             parameters=net.parameters())
    step = jjit.CompiledTrainStep(
        net, lambda m, x, y: ((m(x) - y) ** 2).mean(), opt)
    weights = {k: np.array(np.asarray(v.numpy()), copy=True)
               for k, v in net.state_dict().items()}
    return net, opt, step, sched, weights


def _jax_dataset(n_batches):
    return JDataset([jp.to_tensor(a) for a in _arrays(n_batches)])


def _close(a, b):
    assert sorted(a) == sorted(b)
    np.testing.assert_allclose([a[k] for k in sorted(a)],
                               [b[k] for k in sorted(b)], rtol=RTOL,
                               atol=0)


def test_uninterrupted_trainer_equals_jax(tmp_path):
    _, _, jstep, jsched, weights = _jax_build()
    jlosses = JTrainer(jstep, lambda e: JLoader(_jax_dataset(12),
                                                batch_size=4),
                       JManager(tmp_path / "jax", keep_last=2),
                       scheduler=jsched, epochs=2, max_steps=10,
                       save_every=4).run()
    _, _, step, sched = _build(use_sched=True, weights=weights)
    losses = FaultTolerantTrainer(step, _factory(_dataset(12)),
                                  CheckpointManager(tmp_path / "torch",
                                                    keep_last=2),
                                  scheduler=sched, epochs=2, max_steps=10,
                                  save_every=4).run()
    _close(losses, jlosses)


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """JAX trains 3 steps, saves, trains 3 more; the port restores the
    JAX save into a net of other weights and trains the same 3."""
    jnet, jopt, jstep, _, _ = _jax_build(use_sched=False)
    jds = _jax_dataset(6)
    jbatches = list(JLoader(jds, batch_size=4))
    for x, y in jbatches[:3]:
        jstep(x, y)
    JManager(tmp_path).save(jstep, 3, cursor={"epoch": 0, "offset": 3})
    saved = {k: np.array(np.asarray(v.numpy()), copy=True)
             for k, v in jnet.state_dict().items()}
    jopt_sd = jopt.state_dict()
    jcont = [float(np.asarray(jstep(x, y).numpy())) for x, y in
             jbatches[3:6]]

    net, opt, step, _ = _build(seed=99)
    info = CheckpointManager(tmp_path).restore(step)
    assert info["step"] == 3 and info["cursor"] == {"epoch": 0, "offset": 3}
    for k, v in _params(net).items():
        np.testing.assert_array_equal(v.numpy(), saved[k])
    assert opt._step_count == 3
    names = {p.name: i for i, p in enumerate(jopt._parameter_list)}
    for acc, store in jopt_sd["accumulators"].items():
        for jname, v in store.items():
            got = opt._accumulators[acc][id(opt._parameter_list[
                names[jname]])]
            np.testing.assert_array_equal(got.numpy(), np.asarray(v))
    batches = list(DataLoader(_dataset(6), batch_size=4))
    cont = [float(step(*b)) for b in batches[3:6]]
    _close(dict(enumerate(cont)), dict(enumerate(jcont)))


def test_manifest_names_the_state_as_jax_does(tmp_path):
    """The port's manifest keeps the JAX layout: model/<name>,
    opt/acc/<acc>/p<i>, opt/master/p<i> (none in fp32), the JAX random
    keys rng/carry and rng/host (uint32 [2]), the host block; the port
    adds its lr tensors and this rank's generators."""
    _, _, jstep, _, weights = _jax_build(use_sched=False)
    for x, y in list(JLoader(_jax_dataset(2), batch_size=4))[:1]:
        jstep(x, y)
    JManager(tmp_path / "jax").save(jstep, 1)
    _, _, step, _ = _build(weights=weights)
    _run_steps(step, _dataset(2), 1)
    CheckpointManager(tmp_path / "torch").save(step, 1)

    def manifest(root):
        with open(os.path.join(root, "step-00000001", "MANIFEST.json")) as f:
            return json.load(f)
    jm, tm = manifest(tmp_path / "jax"), manifest(tmp_path / "torch")
    shared = jm["arrays"]
    assert {k: tm["arrays"][k] for k in shared} == shared
    assert {k for k in tm["arrays"] if k not in shared} == {
        "opt/lr/0", "rng/rank0/device/cpu"}
    for k in ("global_step", "cursor", "opt_step", "scheduler", "scaler",
              "fused_steps"):
        assert tm["host"][k] == jm["host"][k], k
