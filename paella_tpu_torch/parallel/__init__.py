from .distributed import initialize_distributed, is_main_process, process_count, process_index
from .mesh import FSDP_MIN_SIZE, data_parallel, fsdp_auto_wrap_policy, fsdp_param_spec

__all__ = [
    "FSDP_MIN_SIZE",
    "data_parallel",
    "fsdp_auto_wrap_policy",
    "fsdp_param_spec",
    "initialize_distributed",
    "is_main_process",
    "process_count",
    "process_index",
]
