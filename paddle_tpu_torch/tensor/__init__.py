"""The ``tensor/`` ops this slice needs (port of ``paddle_tpu/tensor``):
creation, the manipulation and math ops ``Tensor``'s methods and the
layers call, and random sampling.  The rest is ROADMAP.md A10."""
