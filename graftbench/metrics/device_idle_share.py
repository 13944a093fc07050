"""Share of the traced window in which no operation ran on the card."""

from graftbench.readings import device_idle_share as read  # noqa: F401
