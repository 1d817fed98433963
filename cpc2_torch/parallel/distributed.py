"""The rank layout and `torch.distributed`'s start (counterpart of
`cpc2_tpu/parallel/distributed.py`, reference `cpc/distributed_training/
distributed_mode.py`).

`init_distributed_mode` fills the reference's fields on `args` from a
SLURM job's variables or a torchrun-style environment (`WORLD_SIZE`,
`RANK`, `LOCAL_RANK`, `N_NODES`, `NODE_ID`); `init_process_group` starts
the process group of one rank: NCCL for a CUDA device, `gloo` for the CPU.
`CPC2_DIST_BACKEND=gloo` takes `gloo` on a CUDA device too, where NCCL
cannot run (two ranks sharing one card); every collective of the port is
an `all_reduce` or a `broadcast`, which `gloo` takes on CUDA tensors.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist


def init_distributed_mode(params: Any) -> None:
    """Set is_slurm_job, n_nodes, node_id, local_rank, global_rank,
    world_size, n_gpu_per_node, is_master, multi_node and multi_gpu on
    `params` (`distributed_mode.py:11-142`): from SLURM's variables in a
    SLURM job that is not also a torchrun one, from `WORLD_SIZE` and its
    companions where it is set, else one process."""
    params.is_slurm_job = ('SLURM_JOB_ID' in os.environ
                           and 'WORLD_SIZE' not in os.environ)
    if params.is_slurm_job:
        params.n_nodes = int(os.environ.get('SLURM_JOB_NUM_NODES', 1))
        params.node_id = int(os.environ.get('SLURM_NODEID', 0))
        params.local_rank = int(os.environ.get('SLURM_LOCALID', 0))
        params.global_rank = int(os.environ.get('SLURM_PROCID', 0))
        params.world_size = int(os.environ.get('SLURM_NTASKS', 1))
    elif 'WORLD_SIZE' in os.environ:
        params.local_rank = int(os.environ.get('LOCAL_RANK', 0))
        params.global_rank = int(os.environ.get('RANK', 0))
        params.world_size = int(os.environ['WORLD_SIZE'])
        params.n_nodes = int(os.environ.get('N_NODES', 1))
        params.node_id = int(os.environ.get('NODE_ID', 0))
    else:
        params.n_nodes, params.node_id = 1, 0
        params.local_rank, params.global_rank, params.world_size = 0, 0, 1
    params.n_gpu_per_node = max(1, params.world_size // params.n_nodes)
    params.is_master = params.node_id == 0 and params.local_rank == 0
    params.multi_node = params.n_nodes > 1
    params.multi_gpu = params.world_size > 1
    print("Initialized distributed mode:")
    for name in ('n_nodes', 'node_id', 'local_rank', 'global_rank',
                 'world_size', 'is_master'):
        print(f"  {name}: {getattr(params, name)}")


def peek_distributed(argv: Sequence[str]) -> bool:
    """Whether a trainer command line runs distributed: `--distributed`,
    or a resume (`--pathCheckpoint <dir>` without `--restart`) whose saved
    flags say so (`cpc2_tpu/train.py:_peek_distributed`). Reads files
    only."""
    from ..io.checkpoint import get_checkpoint_data
    if '--distributed' in argv:
        return True
    if '--restart' in argv:
        return False
    path = None
    for i, a in enumerate(argv):
        if a == '--pathCheckpoint' and i + 1 < len(argv):
            path = argv[i + 1]
        elif a.startswith('--pathCheckpoint='):
            path = a.split('=', 1)[1]
    if path is None:
        return False
    cdata = get_checkpoint_data(path)
    return cdata is not None and bool(getattr(cdata[2], 'distributed',
                                              False))


def backend(device: torch.device) -> str:
    """NCCL for a CUDA device, `gloo` for the CPU, or `CPC2_DIST_BACKEND`
    where it is set."""
    return os.environ.get("CPC2_DIST_BACKEND") or (
        "nccl" if device.type == "cuda" else "gloo")


def rank_device(name: str, local_rank: int) -> torch.device:
    """The device of a rank: `cuda:<local_rank>`, which must be visible,
    or the CPU."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run the plain versions)")
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {local_rank} needs cuda:{local_rank}"
                           f", but {torch.cuda.device_count()} CUDA "
                           f"device(s) are visible")
    return torch.device("cuda", local_rank)


def free_port() -> int:
    """A TCP port of this host that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_process_group(rank: int, world_size: int, device: torch.device,
                       init_method: Optional[str] = None,
                       timeout_s: float = 1800.0) -> str:
    """Start this rank's default process group on `device`'s backend and
    return the backend. `init_method` defaults to the environment's
    `MASTER_ADDR` (127.0.0.1 if unset) and `MASTER_PORT`."""
    if init_method is None:
        port = os.environ.get("MASTER_PORT")
        if port is None:
            raise RuntimeError("distributed training needs MASTER_PORT (and "
                               "MASTER_ADDR, else 127.0.0.1) in the "
                               "environment")
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        init_method = f"tcp://{addr}:{port}"
    name = backend(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(name, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    return name
