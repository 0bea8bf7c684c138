"""The port's stage timers (``utils/timer.py``): ``tests/test_utils.py``'s
``test_timer_registry`` run against the port and against the JAX
package, and the two registries' reports side by side on a pinned
clock."""

from types import SimpleNamespace

import pytest

import paddlebox_tpu.utils.timer as jtimer
import paddlebox_tpu_torch.utils.timer as ptimer
from paddlebox_tpu.utils import ScopedTimer as JScopedTimer
from paddlebox_tpu_torch.utils import ScopedTimer, Timer, TimerRegistry


@pytest.mark.parametrize("mod", [ptimer, jtimer], ids=["port", "jax"])
def test_timer_registry(mod):
    reg = mod.TimerRegistry()
    with reg.scope("pull"):
        pass
    with reg.scope("pull"):
        pass
    assert reg["pull"].count == 2
    assert "pull=" in reg.report()
    reg.reset()
    assert reg["pull"].count == 0
    t = mod.Timer()
    t.start()
    t.pause()
    assert t.elapsed_sec() >= 0
    assert mod.STAGE_TIMERS is not None


def test_reports_match_the_jax_package_on_a_pinned_clock(monkeypatch):
    """Both packages' timers read ``time.perf_counter``; on one pinned
    sequence of readings the reports, dicts and counts are the same."""

    def clock_from(values):
        it = iter(values)
        return SimpleNamespace(perf_counter=lambda: next(it))

    # three closed intervals, then "push" left running: the report and the
    # dict each read the clock once more
    seq = [1.0, 1.25, 2.0, 2.5, 3.0, 3.125, 10.0, 12.0, 12.0]
    out = {}
    for name, mod, scoped in (("port", ptimer, ScopedTimer), ("jax", jtimer, JScopedTimer)):
        monkeypatch.setattr(mod, "time", clock_from(seq))
        reg = mod.TimerRegistry()
        with reg.scope("pull"):
            pass
        with reg.scope("push"):
            pass
        with scoped(reg["pull"]):
            pass
        reg["push"].start()  # running: elapsed includes the open interval
        out[name] = (reg.report(), reg.as_dict(), reg["pull"].count, reg["pull"].elapsed_ms())
    assert out["port"] == out["jax"]
    assert out["port"][0] == "pull=0.375s/2 push=2.500s/1"
    assert out["port"][1] == {"pull": 0.375, "push": 2.5}


def test_paused_timer_keeps_its_total_and_reset_clears_it(monkeypatch):
    it = iter([0.0, 2.0, 5.0, 6.5, 9.0, 9.5])
    monkeypatch.setattr(ptimer, "time", SimpleNamespace(perf_counter=lambda: next(it)))
    t = Timer()
    t.pause()  # not started: nothing counted
    assert t.count == 0 and t.elapsed_sec() == 0.0
    t.start()
    t.pause()
    t.start()
    t.pause()
    assert t.count == 2 and t.elapsed_sec() == 3.5 and t.elapsed_ms() == 3500.0
    t.reset()
    assert t.count == 0 and t.elapsed_sec() == 0.0
    reg = TimerRegistry()
    assert reg["x"] is reg["x"]
    with pytest.raises(RuntimeError):
        with reg.scope("x"):
            raise RuntimeError("boom")
    assert reg["x"].count == 1 and reg["x"].elapsed_sec() == 0.5  # paused on the way out of the error
