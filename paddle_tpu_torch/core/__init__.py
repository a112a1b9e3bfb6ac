"""The paddle-style eager core of the port: dtypes, grad and AMP state,
op dispatch, autograd and the ``Tensor`` wrapper (port of
``paddle_tpu/core``)."""
