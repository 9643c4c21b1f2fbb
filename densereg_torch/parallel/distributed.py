"""Multi-process initialization, the port of
``densereg_tpu/parallel/distributed.py``.

Every process of a data-parallel run calls :func:`initialize_distributed`,
which joins ``torch.distributed``'s default process group: NCCL between
cards, gloo on the CPU. Nothing on a machine tells a program of its cluster,
so the coordinator's address, the world size and the rank come from the
arguments or from the environment.

Environment variables honoured:
  DENSEREG_NUM_PROCESSES  the world size
  DENSEREG_PROCESS_ID     this process's rank
  DENSEREG_COORDINATOR    ``host:port`` of rank 0's rendezvous
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join the default process group if asked to by the arguments or the
    environment. Returns True when the run has more than one process.

    Without a coordinator address and without ``DENSEREG_NUM_PROCESSES``
    it does nothing and returns False, so the same entry points run in one
    process and in many. ``backend`` defaults to ``"nccl"`` where CUDA is
    available and ``"gloo"`` elsewhere; under NCCL each rank takes the card
    of its rank modulo the cards it sees. Calling it again once the group
    exists changes nothing.
    """
    env_np = os.environ.get("DENSEREG_NUM_PROCESSES")
    if coordinator_address is None and env_np is None:
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = num_processes or (int(env_np) if env_np else 1)
    if process_id is None:
        process_id = int(os.environ.get("DENSEREG_PROCESS_ID", "0"))
    address = (coordinator_address
               or os.environ.get("DENSEREG_COORDINATOR"))
    if address is None:
        raise ValueError("initialize_distributed: DENSEREG_NUM_PROCESSES is "
                         "set but no coordinator address was given "
                         "(argument or DENSEREG_COORDINATOR)")
    if "://" not in address:
        address = f"tcp://{address}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=address, world_size=world,
                            rank=process_id)
    return world > 1

