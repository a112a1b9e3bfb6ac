"""The launcher (port of ``paddle_tpu/distributed/launch``; reference:
python/paddle/distributed/launch/ — the ``fleetrun`` console script,
``CollectiveController`` starting one process a rank with the
``PADDLE_TRAINER_*`` environment).

``python -m paddle_tpu_torch.distributed.launch --nproc_per_node N
train.py args`` starts N processes on this host, one a rank, each
given its rank, the world size, the rendezvous (``PADDLE_MASTER``) and
its card (``FLAGS_selected_gpus``, from ``--devices``);
``--elastic`` puts them under :class:`~..elastic.ElasticAgent`."""

from . import main  # noqa: F401
