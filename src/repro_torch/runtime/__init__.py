"""The fault runtime: the admission guard, typed faults, session health,
the divergence watchdog, backend failover and the chaos seams
(counterpart of ``repro.runtime``, with its public names)."""
from repro_torch.runtime.errors import (AdmissionError, CheckpointCorrupt,
                                        DivergenceError, KernelFailure,
                                        PoolOverflowError,
                                        PoolSaturatedError, RuntimeFault)
from repro_torch.runtime.admission import (ADMISSION_POLICIES,
                                           AdmissionGuard, DeadLetterBuffer,
                                           QuarantineRecord, Violation)
from repro_torch.runtime.health import PoolHealth, SessionHealth
from repro_torch.runtime.failover import FailoverPolicy, backoff_delay
from repro_torch.runtime import faults
from repro_torch.runtime import watchdog

__all__ = [
    "RuntimeFault", "AdmissionError", "PoolOverflowError", "KernelFailure",
    "CheckpointCorrupt", "DivergenceError", "PoolSaturatedError",
    "AdmissionGuard", "DeadLetterBuffer", "QuarantineRecord", "Violation",
    "ADMISSION_POLICIES", "SessionHealth", "PoolHealth", "FailoverPolicy",
    "backoff_delay", "faults", "watchdog",
]
