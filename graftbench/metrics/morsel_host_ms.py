"""Host ms of one morsel through its pipelines (NumPy), less backend calls."""

from graftbench.readings import morsel_host_ms as read  # noqa: F401
