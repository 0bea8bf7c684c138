"""The window's loops, one module a kind, named by a traffic mix's
``loop`` key. Each gives ``setup(ctx)``, ``window(run, seconds)``,
``traced(run)``, ``release(run)`` and ``check(run)``."""
