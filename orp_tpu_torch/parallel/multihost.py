"""Multi-process initialisation (counterpart of ``orp_tpu/parallel/multihost.py``).

The JAX package stitches every host's chips into one runtime with
``jax.distributed.initialize``. The port runs one process per device, SPMD by
hand, and stitches the processes into one ``torch.distributed`` group: NCCL
between cards, ``gloo`` on the CPU (or where the caller names it). After this
call ``parallel.mesh.make_mesh()`` spans every rank of the group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _init_method(address: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL (``tcp://``, ``file://``) as given."""
    return address if "://" in address else f"tcp://{address}"


def initialize_multihost(*, auto: bool = False, coordinator_address: str | None = None,
                         num_processes: int | None = None, process_id: int | None = None,
                         backend: str | None = None) -> dict:
    """Form the process group; returns a topology summary.

    - default (``auto=False``, no coordinator args): a no-op, one process;
    - ``auto=True``: ``init_process_group(init_method="env://")``, the
      variables ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
      ``WORLD_SIZE``);
    - manual: ``coordinator_address`` (``host:port``, or a ``file://`` store
      every process can reach), ``num_processes`` and ``process_id``.

    ``backend``: ``"nccl"`` when a card is present, else ``"gloo"``, unless
    the caller names one. Each process drives one device, so
    ``local_device_count`` is 1 and ``global_device_count`` the process count."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if auto:
        dist.init_process_group(backend, init_method="env://")
    elif num_processes is not None and num_processes > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError("initialize_multihost: num_processes > 1 needs "
                             "coordinator_address and process_id")
        dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                                world_size=num_processes, rank=process_id)
    on = dist.is_initialized()
    count = dist.get_world_size() if on else 1
    return {
        "process_index": dist.get_rank() if on else 0,
        "process_count": count,
        "local_device_count": 1,
        "global_device_count": count,
    }
