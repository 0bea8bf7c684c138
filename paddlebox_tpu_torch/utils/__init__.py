"""Host-side utilities: stats, stage timers, fault injection, device
selection, the native host tier (``native``)."""

from paddlebox_tpu_torch.utils.faultinject import (  # noqa: F401
    InjectedFault,
    fail_always,
    fail_nth,
    fail_once,
    fail_prob,
    inject,
)
from paddlebox_tpu_torch.utils.monitor import (  # noqa: F401
    STAT_ADD,
    STAT_GET,
    STAT_OBSERVE,
    STAT_RESET,
)
from paddlebox_tpu_torch.utils.timer import ScopedTimer, Timer, TimerRegistry  # noqa: F401
