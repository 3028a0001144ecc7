from .compression import compress_with_feedback, compression_ratio, init_residual
from .fault_tolerance import FaultTolerantLoop, LoopConfig, make_failure_injector

__all__ = ["compress_with_feedback", "compression_ratio", "init_residual",
           "FaultTolerantLoop", "LoopConfig", "make_failure_injector"]
