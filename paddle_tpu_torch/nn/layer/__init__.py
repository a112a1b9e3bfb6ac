"""Paddle-style layers of the port (port of ``paddle_tpu/nn/layer``)."""
