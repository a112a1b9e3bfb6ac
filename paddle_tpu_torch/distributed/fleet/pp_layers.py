"""Pipeline-parallel layer descriptions (port of
``paddle_tpu/distributed/fleet/pp_layers.py``; reference:
fleet/meta_parallel/parallel_layers/pp_layers.py — LayerDesc:56,
SharedLayerDesc:76, SegmentLayers:92, PipelineLayer:257).

The JAX package's semantics, with no more features: a
:class:`PipelineLayer` builds every stage in one process, records the
partition (``segment_bounds``, :meth:`PipelineLayer.get_stage_layers`)
and runs the layers in sequence.  The pipeline schedules over ``pp``
are ``distributed.pipeline``'s, which the GPT runs."""

from __future__ import annotations

from ...nn.layer.layers import Layer, LayerList


class LayerDesc:
    """reference: pp_layers.py:56 — a layer class and its arguments,
    built by :meth:`build_layer`."""

    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs
        if not issubclass(layer_func, Layer):
            raise TypeError("LayerDesc expects a Layer subclass")

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    """reference: pp_layers.py:76 — a layer shared by every place its
    ``key`` appears (a tied embedding); a later place may run it through
    ``forward_func(layer, x)``."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """reference: pp_layers.py:92 — stage bounds over the descriptions,
    ``"uniform"`` or ``"layer:<ClassName>"`` (each stage starts at an
    equal share of that class's layers)."""

    def __init__(self, layers_desc, num_parts, method="uniform"):
        self.descs = layers_desc
        self.num_parts = num_parts
        self.method = method

    def do_segment(self):
        n = len(self.descs)
        if self.method == "uniform":
            return self.uniform(n, self.num_parts)
        if self.method.startswith("layer:"):
            cls_name = self.method.split(":", 1)[1]
            marks = [i for i, d in enumerate(self.descs)
                     if self._name_of(d) == cls_name]
            if len(marks) % self.num_parts != 0:
                raise ValueError(
                    f"{len(marks)} '{cls_name}' layers not divisible into "
                    f"{self.num_parts} stages")
            per = len(marks) // self.num_parts
            return [0] + [marks[p * per] for p in range(1, self.num_parts)] \
                + [n]
        raise ValueError(self.method)

    @staticmethod
    def _name_of(desc):
        if isinstance(desc, LayerDesc):
            return desc.layer_func.__name__
        return type(desc).__name__

    @staticmethod
    def uniform(num_items, num_parts):
        base, extra = divmod(num_items, num_parts)
        bounds = [0]
        for i in range(num_parts):
            bounds.append(bounds[-1] + base + (1 if i < extra else 0))
        return bounds


class PipelineLayer(Layer):
    """reference: pp_layers.py:257.  Builds every stage (a
    :class:`SharedLayerDesc` key once, its later places reusing that
    layer), splits them by ``seg_method`` into ``num_stages`` (default:
    the mesh's ``pp`` degree) and runs them in sequence;
    ``recompute_interval=k`` recomputes every k-th layer in training
    (``fleet.recompute``).  ``loss_fn(output, label)`` is :meth:`loss`.
    ``topology``, ``recompute_ctx`` and ``num_virtual_pipeline_stages``
    are accepted and not read, as in the JAX package."""

    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        from ..env import hybrid_degrees
        self._loss_fn = loss_fn
        self.descs = list(layers)
        self.num_stages = num_stages or max(hybrid_degrees().get("pp", 1), 1)
        self.seg_method = seg_method
        self._recompute_interval = recompute_interval
        self.segment_bounds = SegmentLayers(self.descs, self.num_stages,
                                            seg_method).do_segment()
        shared, run_layers, self._exec = {}, [], []
        for d in self.descs:
            if isinstance(d, SharedLayerDesc) and d.layer_name in shared:
                layer, fwd = shared[d.layer_name], d.forward_func
                self._exec.append(layer if fwd is None else
                                  (lambda x, _l=layer, _f=fwd: _f(_l, x)))
                continue
            if isinstance(d, LayerDesc):
                layer = d.build_layer()
                if isinstance(d, SharedLayerDesc):
                    shared[d.layer_name] = layer
            elif isinstance(d, Layer):
                layer = d
            elif callable(d):
                self._exec.append(d)
                continue
            else:
                raise TypeError(f"bad pipeline item {d}")
            run_layers.append(layer)
            self._exec.append(layer)
        self._shared = shared
        self.run_functions = LayerList(run_layers)

    def get_stage_layers(self, stage_id):
        lo, hi = (self.segment_bounds[stage_id],
                  self.segment_bounds[stage_id + 1])
        return self._exec[lo:hi]

    def forward(self, x):
        from .recompute import recompute
        for i, f in enumerate(self._exec):
            if (self._recompute_interval > 0 and self.training
                    and i % self._recompute_interval == 0):
                x = recompute(f, x)
            else:
                x = f(x)
        return x

    def loss(self, output, label):
        if self._loss_fn is None:
            raise RuntimeError("no loss_fn configured")
        return self._loss_fn(output, label)


__all__ = ["LayerDesc", "PipelineLayer", "SegmentLayers", "SharedLayerDesc"]
