"""``python -m paddle_tpu_torch.distributed.launch`` (reference:
launch/__main__.py)."""

from .main import launch

if __name__ == "__main__":
    launch()
