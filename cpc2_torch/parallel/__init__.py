"""Data-parallel training of the port (counterpart of `cpc2_tpu/parallel/`):
one process a rank, each on its own device, gradients, metrics and
BatchNorm statistics reduced explicitly with `torch.distributed`
(`data_parallel.py`), and the rank layout from a SLURM or torchrun-style
environment (`distributed.py`)."""

from .data_parallel import (DataParallel, gather_pool, rank_layout,
                            rank_rows, rank_seed)
from .distributed import (free_port, init_distributed_mode,
                          init_process_group, peek_distributed, rank_device)

__all__ = ["DataParallel", "free_port", "gather_pool",
           "init_distributed_mode", "init_process_group",
           "peek_distributed", "rank_device", "rank_layout", "rank_rows",
           "rank_seed"]
