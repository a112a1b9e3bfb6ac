"""Parallel-config auto-tuner: search dp/mp/pp/sharding/microbatches
(port of ``paddle_tpu/distributed/auto_tuner``).

Reference analogue: python/paddle/distributed/auto_tuner/tuner.py:21
(AutoTuner, the candidate space), search.py:31-144 (GridSearch: prune by
divisibility and memory, rank, run trials), prune.py (the rules).

Candidates are hybrid-mesh shapes over the mesh axes; pruning uses exact
divisibility and a device-memory model (parameter and optimizer state
split by the axes that split it, activations scaled by microbatching
and recompute); ranking uses an analytic step-time model with three
costs: the tensor cores' compute, the collectives' bytes over the
interconnect (tensor-parallel all-reduces, the data-parallel gradient
reduce) and the pipeline bubble.  An optional ``trial_fn`` measures the
top survivors for the final pick.  The model and its formulas are the
JAX package's; the defaults of :class:`TuneSpace` are an H100 SXM's
where the JAX package's are a TPU v5e's.
"""

from __future__ import annotations

import dataclasses
import itertools
import math


def _card_memory():
    """The card's memory in bytes: ``total_memory`` of card 0 where
    CUDA is available, else an H100 SXM's 80 GB."""
    import torch
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return 80e9


@dataclasses.dataclass
class TuneSpace:
    """Model + cluster description (the tuner's input config —
    reference: auto_tuner config dict, tuner.py:21).  The per-card
    peaks default to an H100 SXM's."""

    n_devices: int
    num_layers: int
    hidden_size: int
    num_heads: int
    vocab_size: int
    seq_len: int
    global_batch: int
    ffn_hidden_size: int = 0
    bytes_per_param: int = 2           # bf16
    optimizer_bytes_per_param: int = 12  # fp32 master + 2 moments
    #: device memory a card (the card's own, :func:`_card_memory`)
    hbm_bytes: float = dataclasses.field(default_factory=_card_memory)
    #: dense bf16 tensor-core peak of an H100 SXM (NVIDIA data sheet)
    flops_peak: float = 989e12
    #: bytes/s a direction between two cards: NVLink 4, 18 links of
    #: 25 GB/s a direction (the data sheet's 900 GB/s is both directions)
    ici_bw: float = 4.5e11
    #: the share of flops_peak a step reaches: an assumption (the JAX
    #: package's), not measured on the card for this model
    mfu_assumed: float = 0.45

    def __post_init__(self):
        if not self.ffn_hidden_size:
            self.ffn_hidden_size = 4 * self.hidden_size

    @property
    def n_params(self):
        H, L, F, V = (self.hidden_size, self.num_layers,
                      self.ffn_hidden_size, self.vocab_size)
        return L * (4 * H * H + 2 * H * F) + V * H


@dataclasses.dataclass
class Candidate:
    dp: int
    mp: int
    pp: int
    sharding: int
    micro_batches: int
    est_step_time: float = 0.0
    est_hbm: float = 0.0
    measured: float | None = None

    @property
    def degrees(self):
        return {"dp": self.dp, "mp": self.mp, "pp": self.pp,
                "sharding": self.sharding}

    def __str__(self):
        t = (f"{self.measured * 1e3:.1f}ms measured" if self.measured
             else f"{self.est_step_time * 1e3:.1f}ms est")
        return (f"dp{self.dp} mp{self.mp} pp{self.pp} sh{self.sharding} "
                f"mb{self.micro_batches}: {t}, "
                f"{self.est_hbm / 1e9:.1f}G HBM")


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


class AutoTuner:
    """reference: tuner.py AutoTuner + search.py GridSearch."""

    def __init__(self, space: TuneSpace):
        self.space = space
        self.history = []  # pruned/scored candidates for reporting

    # -- candidate enumeration (search.py:31 all_cfgs) ----------------------
    def candidates(self):
        s = self.space
        n = s.n_devices
        for mp, pp in itertools.product(_divisors(n), repeat=2):
            if mp * pp > n:
                continue
            rest = n // (mp * pp)
            if mp * pp * rest != n:
                continue
            for sharding in _divisors(rest):
                dp = rest // sharding
                for mb in (1, 2, 4, 8, 16, 32):
                    yield Candidate(dp, mp, pp, sharding, mb)

    # -- pruning (prune.py rules) -------------------------------------------
    def prune_reason(self, c: Candidate):
        s = self.space
        if s.num_layers % c.pp:
            return f"num_layers {s.num_layers} % pp {c.pp}"
        if s.num_heads % c.mp:
            return f"num_heads {s.num_heads} % mp {c.mp}"
        if s.vocab_size % c.mp:
            return f"vocab {s.vocab_size} % mp {c.mp}"
        if s.ffn_hidden_size % c.mp:
            return f"ffn {s.ffn_hidden_size} % mp {c.mp}"
        data_ways = c.dp * c.sharding
        if s.global_batch % (data_ways * c.micro_batches):
            return (f"global_batch {s.global_batch} % "
                    f"(dp*sharding*mb = {data_ways * c.micro_batches})")
        if c.pp > 1 and c.micro_batches < c.pp:
            return f"mb {c.micro_batches} < pp {c.pp} (bubble-dominated)"
        hbm = self.est_hbm(c)
        c.est_hbm = hbm
        if hbm > s.hbm_bytes:
            return f"HBM {hbm / 1e9:.1f}G > {s.hbm_bytes / 1e9:.2f}G"
        return None

    def est_hbm(self, c: Candidate):
        """Param + optimizer state sharded by (mp, pp, sharding); live
        activations for one microbatch with selective remat."""
        s = self.space
        shard_ways = c.mp * c.pp * max(c.sharding, 1)
        state = s.n_params * (s.bytes_per_param
                              + s.optimizer_bytes_per_param) / shard_ways
        mb_tokens = (s.global_batch // max(c.dp * c.sharding, 1)
                     // max(c.micro_batches, 1)) * s.seq_len
        # selective remat keeps ~4H bytes/token/layer (bf16) per local stage
        acts = (mb_tokens * 4 * s.hidden_size * 2
                * (s.num_layers // max(c.pp, 1)) / max(c.mp, 1))
        # 1F1B holds up to pp microbatches of stage-boundary activations
        acts *= min(c.pp, c.micro_batches) if c.pp > 1 else 1
        return state + acts

    # -- analytic step-time model -------------------------------------------
    def est_step_time(self, c: Candidate):
        s = self.space
        tokens_per_card = s.global_batch * s.seq_len / s.n_devices
        compute = tokens_per_card * 6 * s.n_params / (
            s.flops_peak * s.mfu_assumed)
        # TP: 2 all-reduces a layer of [tokens_local, H] bf16, ring cost
        local_tokens = (s.global_batch // max(c.dp * c.sharding, 1)
                        * s.seq_len)
        tp_bytes = (0 if c.mp == 1 else
                    2 * (s.num_layers // max(c.pp, 1)) * local_tokens
                    * s.hidden_size * 2 * 2 * (c.mp - 1) / c.mp)
        # DP/sharding gradient reduce-scatter + all-gather of the local
        # parameters: mostly overlapped with the backward's compute; only
        # the tail is exposed
        data_ways = c.dp * c.sharding
        dp_bytes = (0 if data_ways == 1 else
                    2 * (s.n_params / (c.mp * c.pp)) * 2
                    * (data_ways - 1) / data_ways)
        dp_exposed = 0.2
        # pipeline boundary shifts: every microbatch crosses this card's
        # stage boundary once forward and once backward
        pp_bytes = (0 if c.pp == 1 else
                    2 * local_tokens * s.hidden_size * 2)
        comm = (tp_bytes + dp_bytes * dp_exposed + pp_bytes) / s.ici_bw
        # pipeline bubble stretches the compute fraction
        bubble = ((c.pp - 1) / max(c.micro_batches, 1)) if c.pp > 1 else 0.0
        return compute * (1 + bubble) + comm

    # -- search (search.py:105 search loop) ---------------------------------
    def tune(self, trial_fn=None, top_n=3, verbose=False):
        """Returns the best Candidate.  trial_fn(candidate) -> measured step
        seconds (or raises/returns None to reject); without one, the
        analytic ranking decides."""
        survivors = []
        for c in self.candidates():
            reason = self.prune_reason(c)
            if reason is not None:
                self.history.append((c, f"pruned: {reason}"))
                continue
            c.est_step_time = self.est_step_time(c)
            survivors.append(c)
        if not survivors:
            raise ValueError(
                "auto-tuner: every candidate pruned — model too large for "
                f"{self.space.n_devices} devices? "
                f"(last reasons: {[h[1] for h in self.history[-5:]]})")
        # tiebreak toward the operationally simpler config (fewer model-
        # sharding axes, fewer microbatches)
        survivors.sort(key=lambda c: (round(c.est_step_time, 4), c.pp,
                                      c.mp, c.sharding, c.micro_batches))
        self.history.extend((c, "ranked") for c in survivors)
        if trial_fn is None:
            best = survivors[0]
        else:
            best, best_t = None, float("inf")
            for c in survivors[:top_n]:
                try:
                    t = trial_fn(c)
                except Exception as e:  # trial crashed: reject candidate
                    self.history.append((c, f"trial failed: {e}"))
                    continue
                if t is not None and t < best_t:
                    best, best_t = c, t
                    c.measured = t
            best = best or survivors[0]
        if verbose:
            for c in survivors[:10]:
                print(c)
        return best


def tune(space=None, trial_fn=None, **kw):
    """Convenience entry (reference: auto_tuner.tuner entry)."""
    if space is None:
        space = TuneSpace(**kw)
    return AutoTuner(space).tune(trial_fn=trial_fn)


__all__ = ["AutoTuner", "Candidate", "TuneSpace", "tune"]
