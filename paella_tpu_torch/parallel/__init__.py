from .distributed import initialize_distributed, is_main_process, process_count, process_index
from .mesh import (FSDP_MIN_SIZE, data_parallel, fsdp_param_spec, fsdp_placement, fsdp_units, make_mesh,
                   shard_model)

__all__ = [
    "FSDP_MIN_SIZE",
    "data_parallel",
    "fsdp_param_spec",
    "fsdp_placement",
    "fsdp_units",
    "initialize_distributed",
    "is_main_process",
    "make_mesh",
    "process_count",
    "process_index",
    "shard_model",
]
