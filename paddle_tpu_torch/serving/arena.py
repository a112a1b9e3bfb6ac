"""StateArena: the spec layer under the serving engines (port of
``paddle_tpu/serving/arena.py``).

The arena owns the engine's device state — the weight tree and the KV
pools (and their scale pools) — and decides, leaf by leaf, what this
rank holds:

* **placement** — with a mesh, every declared leaf gets a spec from
  :data:`DEFAULT_SHARD_RULES` (an MoE model's expert stacks from
  :data:`EXPERT_SHARD_RULES`; the caller's rules in front of either)
  through ``distributed.sharding_utils.infer_partition_specs`` /
  ``validate_spec``, and the arena keeps **this rank's local shard**;
  the model's ``TensorParallel`` then runs the Megatron forward over
  them.  With ``mesh=None`` the arena is a pass-through: the weights
  are the model's own tensors and the engines behave bit for bit as
  without an arena.  A model built under a mesh already holds its
  shards (its training placements); the arena keeps them as they are.
* **accounting** — :meth:`StateArena.device_bytes` and
  :meth:`StateArena.shard_shape` read what this rank holds, by name:
  ``weights``, ``pool_k``/``pool_v`` (``cache_k``/``cache_v`` in the
  slot layout), ``scale_k``/``scale_v``; the speculative engine's
  ``draft_weights``, ``draft_pool_k``/``draft_pool_v`` and
  ``draft_scale_k``/``draft_scale_v``; the LoRA arena's ``adapters``.

The draft model's tree and pools take the same rules as the target's:
they split over ``mp`` when the draft's heads divide it and degrade to
replicated otherwise (``serving.mesh.spec_degraded``).  The LoRA arena
holds each rank's cut of the slabs, the columns or rows its shard of a
matmul meets, cut once when a tenant registers
(``models.gpt.TensorParallel.lora_local``); the JAX arena keeps them
replicated and lets GSPMD cut them at each call.

On a mesh of more than one rank the arena also holds the mesh's
:class:`RankZero` channel (:attr:`StateArena.rank_zero`): the decisions
that read a clock, a thread's timing or a rank's own state (a fleet's
picks, faults, crash verdicts and autoscaler actions; the deadline
verdicts of an engine serving alone) are taken on mesh rank 0 and
applied on every rank, over one gloo group built once per mesh and
shared by a fleet and its replicas' engines.  The JAX package runs in
one process with one clock and has no counterpart.

The JAX arena also fronts a compile cache (``program``), rebinds donated
pools (``bind``/``get``), wraps per-step operands (``operand``) and names
the in-graph collectives its auditor allows (``expected_collectives``).
The port compiles nothing, donates nothing, passes operands as they are
and issues its collectives from the host, so it has none of these.

Sharding contract (the PagedAttention trick): block tables, positions
and sampling knobs stay replicated host operands; only the KV pools
``[L, n_blocks, bs, nh/mp, hd]`` and the weight matrices split over
``mp``.  Each rank decodes its heads through K4/K4q and the row-parallel
projections all-reduce; the ranks' collectives are issued by the host
(``dist.collective_launches`` > 0, unlike the JAX package's in-graph
ones).  Heads that do not divide by ``mp`` degrade the attention and
the pools to replicated (``serving.mesh.spec_degraded``) instead of
failing.
"""

from __future__ import annotations

import weakref

import torch

from ..distributed.sharding_utils import (P, infer_partition_specs,
                                          local_shard, validate_spec)
from ..profiler import counters

#: Megatron-style rules for the GPT ``decode_state`` tree, matched
#: against ``/``-joined leaf paths; first match wins, unmatched leaves
#: replicate.  The JAX rules, with the int8 weights' per-output-channel
#: scales of the column-parallel matmuls in front: a local shard of
#: ``qkv_w``/``fc1_w`` needs the scales of its own columns (GSPMD
#: reshards a replicated scale by itself; local shards cannot).
DEFAULT_SHARD_RULES = (
    (r"qkv_w__scale$", P(None, None, "mp")),
    (r"fc1_w__scale$", P(None, None, "mp")),
    (r"qkv_w$", P(None, None, "mp")),
    (r"qkv_b$", P(None, "mp")),
    (r"proj_w$", P(None, "mp", None)),
    (r"fc1_w$", P(None, None, "mp")),
    (r"fc1_b$", P(None, "mp")),
    (r"fc2_w$", P(None, "mp", None)),
    (r"wte$", P(None, "mp")),
    (r"wpe$", P(None, "mp")),
    (r"head$", P("mp", None)),
)

#: The defaults of an MoE model's expert stacks ``fc1_w [L, E, H, F]``,
#: ``fc1_b [L, E, F]`` and ``fc2_w [L, E, F, H]``, which take them in
#: place of the dense rules of the same names: their hidden units ``F``
#: split over ``mp`` (a local shard computes what it cuts); the router
#: ``gate_w`` and ``fc2_b`` replicate.  The JAX rules, written for 3-D
#: stacks, name other dimensions of a 4-D one; GSPMD keeps the math
#: whatever the placement, local shards do not.  A caller's rules stand
#: in front of these as of the dense ones.
EXPERT_SHARD_RULES = (
    (r"fc1_w$", P(None, None, None, "mp")),
    (r"fc1_b$", P(None, None, "mp")),
    (r"fc2_w$", P(None, None, "mp", None)),
)

#: the rank of each expert stack (a dense model's stacks have one less)
_EXPERT_DIMS = {"fc1_w": 4, "fc1_b": 3, "fc2_w": 4}

#: KV pools ``[L, n_blocks, bs, nh, hd]`` (and the slot arena ``[L, B,
#: S, nh, hd]``) split their head axis
KV_POOL_SPEC = P(None, None, None, "mp", None)

#: the KV storage whose head axis :attr:`StateArena.kv_head_axis` reports
_KV_POOLS = ("pool_k", "pool_v", "cache_k", "cache_v", "draft_pool_k",
             "draft_pool_v")


class RankZero:
    """Decisions taken on mesh rank 0 and applied on every rank, over a
    gloo group of the mesh's ranks (:meth:`of`: one a mesh).  Every rank
    calls the same methods in the same order, from the one thread that
    drives its engines, so the object collectives of the ranks meet.
    Each call counts one ``dist.collective_launches``."""

    _BY_MESH = weakref.WeakKeyDictionary()

    def __init__(self, mesh):
        import torch.distributed as dist
        self._dist = dist
        ranks = mesh.group_ranks(mesh.axis_names)
        self.src = ranks[0]
        self.is_src = mesh.rank == self.src
        self.group = dist.new_group(ranks, backend="gloo")

    @classmethod
    def of(cls, mesh):
        """The channel of ``mesh``, built on first use (every rank of the
        mesh builds it at the same point: ``new_group`` is collective)."""
        rz = cls._BY_MESH.get(mesh)
        if rz is None:
            rz = cls._BY_MESH[mesh] = cls(mesh)
        return rz

    @staticmethod
    def _run(fn):
        try:
            return ("ok", fn())
        except Exception as e:  # noqa: BLE001 - every rank raises it
            return ("raise", e)

    @staticmethod
    def _unbox(val):
        kind, v = val
        if kind == "raise":
            raise v
        return v

    def decide(self, fn):
        """``fn()`` on rank 0, broadcast: every rank returns its value,
        or raises the exception it raised there."""
        box = [self._run(fn) if self.is_src else None]
        counters.inc("dist.collective_launches")
        self._dist.broadcast_object_list(box, src=self.src, group=self.group)
        return self._unbox(box[0])

    def gather(self, mine, fn):
        """``(fn() on rank 0, [mine of every rank])`` in one collective:
        every rank contributes ``mine`` and gets every rank's, and rank
        0's value of ``fn()`` (or raises the exception it raised)."""
        box = (mine, self._run(fn) if self.is_src else None)
        got = [None] * self._dist.get_world_size(self.group)
        counters.inc("dist.collective_launches")
        self._dist.all_gather_object(got, box, group=self.group)
        return (self._unbox(got[self._dist.get_group_rank(
            self.group, self.src)][1]), [g[0] for g in got])


def _flatten(tree):
    """``{leaf name: leaf}`` of the decode-state tree (layer leaves by
    their own names)."""
    out = {k: v for k, v in tree.items() if k not in ("lws", "tp")}
    out.update(tree["lws"])
    return out


class StateArena:
    """Declared serving state with resolved specs (see the module
    docstring).  ``tag`` names a mesh of more than one rank
    (``[mp2]``)."""

    def __init__(self, mesh=None, shard_rules=None):
        self.mesh = mesh
        self.user_rules = tuple(shard_rules or ())
        self.shard_rules = self.user_rules + DEFAULT_SHARD_RULES
        self._state = {}
        #: True once a declared KV pool's head axis actually split
        self.kv_head_axis = False

    # -- mesh introspection ----------------------------------------------
    @property
    def multi_device(self):
        return self.mesh is not None and self.mesh.size > 1

    @property
    def tag(self):
        """``"[mp2]"``-style decoration; empty without a mesh or on a
        mesh of one rank, so those engines name everything as unsharded
        ones do."""
        if not self.multi_device:
            return ""
        inner = "".join(f"{a}{n}" for a, n in self.mesh.shape.items()
                        if n > 1)
        return f"[{inner}]"

    @property
    def rank_zero(self):
        """The mesh's :class:`RankZero` on a mesh of more than one rank,
        else None."""
        return RankZero.of(self.mesh) if self.multi_device else None

    # -- spec resolution --------------------------------------------------
    def _degraded(self, msg):
        counters.inc("serving.mesh.spec_degraded")

    def resolve_spec(self, name, spec, shape):
        """``spec`` checked against ``shape`` on the mesh: an indivisible
        dimension or an unknown axis degrades it to replicated and ticks
        ``serving.mesh.spec_degraded``.  None without a mesh."""
        if self.mesh is None:
            return None
        return validate_spec(spec, tuple(shape), self.mesh, name=name,
                             on_fallback=self._degraded)

    # -- declaration ------------------------------------------------------
    def declare(self, name, value, spec=None):
        """Take ``value`` under ``name``: its local shard under the
        resolved ``spec`` with a mesh, the value itself without."""
        if value is not None and self.mesh is not None and spec is not None:
            rspec = self.resolve_spec(name, spec, value.shape)
            value = local_shard(value, rspec, self.mesh)
            self._note_pool(name, rspec)
        self._state[name] = value
        return value

    def declare_zeros(self, name, shape, dtype, device, spec=None,
                      split=True):
        """A zero tensor of this rank's shard of ``shape`` (made at the
        local size, never in full).  ``split=False`` keeps it whole (the
        spec still counts a degrade)."""
        rspec = P()
        if self.mesh is not None and spec is not None:
            rspec = self.resolve_spec(name, spec, shape)
            if not split:
                rspec = P()
        local = local_shard(torch.empty(shape, device="meta"), rspec,
                            self.mesh).shape if self.mesh else shape
        self._note_pool(name, rspec)
        value = torch.zeros(tuple(local), dtype=dtype, device=device)
        self._state[name] = value
        return value

    def _note_pool(self, name, rspec):
        if name in _KV_POOLS and any(e is not None for e in (rspec or ())):
            self.kv_head_axis = True

    def declare_tree(self, name, tree, num_heads):
        """Take a GPT decode-state tree.  Without a mesh it is kept as it
        is.  With one, a tree whose model is already split (``tree["tp"]``
        set) is kept as it is; otherwise each leaf gets its spec from the
        rules, the attention and FFN groups are made whole
        (``models.gpt.resolve_tp_specs``: heads must divide) and the
        tree's leaves become this rank's shards, with ``tree["tp"]`` the
        ``TensorParallel`` that runs them."""
        if self.mesh is None or tree.get("tp") is not None:
            self._state[name] = tree
            return tree
        from ..models.gpt import TensorParallel, resolve_tp_specs
        lws = tree["lws"]
        experts = {k: v for k, v in lws.items() if v is not None
                   and v.dim() == _EXPERT_DIMS.get(k)}
        rest = {k: v for k, v in tree.items() if k != "tp"}
        rest["lws"] = {k: v for k, v in lws.items() if k not in experts}
        specs = _flatten(infer_partition_specs(
            rest, self.mesh, self.shard_rules, on_fallback=self._degraded))
        specs.update(infer_partition_specs(
            experts, self.mesh, self.user_rules + EXPERT_SHARD_RULES,
            on_fallback=self._degraded))
        specs = resolve_tp_specs(specs, num_heads, self.mesh,
                                 on_fallback=self._degraded)
        tp = TensorParallel(self.mesh, specs)

        def cut(k, v):
            return None if v is None else tp.local(k, v)

        placed = {k: cut(k, v) for k, v in tree.items()
                  if k not in ("lws", "tp")}
        placed["lws"] = {k: cut(k, v) for k, v in tree["lws"].items()}
        placed["tp"] = tp
        self._state[name] = placed
        return placed

    def release(self, *names):
        """Forget the named entries (a dead replica's pools), so nothing
        here keeps their memory."""
        for name in names:
            self._state.pop(name, None)

    # -- accounting -------------------------------------------------------
    def _tensors(self, entry):
        if isinstance(entry, dict):
            for v in entry.values():
                yield from self._tensors(v)
        elif isinstance(entry, torch.Tensor):
            yield entry

    def device_bytes(self, *names):
        """Bytes this rank holds of the named entries."""
        return sum(t.nbytes for n in names
                   for t in self._tensors(self._state.get(n)))

    def shard_shape(self, name):
        """Shape of this rank's ``name``."""
        entry = self._state.get(name)
        return None if entry is None else tuple(entry.shape)


__all__ = ["DEFAULT_SHARD_RULES", "EXPERT_SHARD_RULES", "KV_POOL_SPEC",
           "RankZero", "StateArena"]
