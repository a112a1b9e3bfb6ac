"""Runtime flags (the subset of ``paddle_tpu/core/flags.py`` the port
reads).

* ``FLAGS_fused_steps`` — the default window of
  ``jit.CompiledTrainStep`` (1: one step a call).
* ``FLAGS_check_nan_inf`` — ``CompiledTrainStep`` checks the loss and
  every gradient (and, under a GradScaler, the updated parameters) for
  NaN/Inf and raises ``FloatingPointError`` naming the step.
* ``FLAGS_peak_tflops`` — the device's peak, for the MFU of the train
  metrics (0: no MFU).
* ``FLAGS_fault_schedule`` — the fault-injection schedule
  (``resilience.faultinject``; empty: none).
* ``FLAGS_host_trace_level`` — the host tracer's span level
  (``profiler.host_tracer``; spans record only inside a session).
* ``FLAGS_flight_dir`` / ``FLAGS_flight_capacity`` — where the flight
  recorder writes postmortem bundles (empty: a per-process directory
  under the temp dir) and how many events its ring keeps.
* ``FLAGS_request_trace_sample`` — per-request trace head-sampling
  probability (``profiler.trace``; 0: tracing off).
* ``FLAGS_device_time_sample`` — fence every Nth noted dispatch into the
  device-time ledger (``profiler.devicetime``; 0: off).
* ``FLAGS_health`` / ``FLAGS_health_interval_s`` — the health plane
  (``profiler.health``) and the least seconds between its ticks.

``register_flag_observer(name, fn)`` calls ``fn(value)`` whenever
``set_flags`` sets ``name`` (and once at once with ``call_now=True``).
"""

from __future__ import annotations

_REGISTRY: dict[str, object] = {
    "FLAGS_fused_steps": 1,
    "FLAGS_check_nan_inf": False,
    "FLAGS_peak_tflops": 0.0,
    "FLAGS_fault_schedule": "",
    "FLAGS_host_trace_level": 1,
    "FLAGS_flight_dir": "",
    "FLAGS_flight_capacity": 2048,
    "FLAGS_request_trace_sample": 0.0,
    "FLAGS_device_time_sample": 0,
    "FLAGS_health": False,
    "FLAGS_health_interval_s": 1.0,
}
_OBSERVERS: dict[str, list] = {}


def flag(name: str):
    return _REGISTRY[name]


def set_flags(flags: dict):
    """Set flags by name; an unknown name raises ``KeyError``."""
    unknown = sorted(set(flags) - set(_REGISTRY))
    if unknown:
        raise KeyError(f"unknown flags {unknown}; the port reads "
                       f"{sorted(_REGISTRY)}")
    _REGISTRY.update(flags)
    for name, value in flags.items():
        for fn in _OBSERVERS.get(name, ()):
            fn(value)


def register_flag_observer(name: str, fn, call_now=False):
    """Call ``fn(value)`` each time ``set_flags`` sets ``name`` (and once
    now with ``call_now=True``)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown flag {name!r}")
    _OBSERVERS.setdefault(name, []).append(fn)
    if call_now:
        fn(_REGISTRY[name])


__all__ = ["flag", "register_flag_observer", "set_flags"]
