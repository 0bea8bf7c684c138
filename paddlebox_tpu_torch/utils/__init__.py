"""Host-side utilities: stats, fault injection, device selection."""

from paddlebox_tpu_torch.utils.faultinject import (  # noqa: F401
    InjectedFault,
    fail_always,
    fail_nth,
    fail_once,
    fail_prob,
    inject,
)
from paddlebox_tpu_torch.utils.monitor import STAT_ADD, STAT_GET, STAT_RESET  # noqa: F401
