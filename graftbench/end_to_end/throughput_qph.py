"""Queries' worth of work completed in the window, per hour of window:
each query running in the window counts with the share of its time, from
sending to completion, that lies inside it."""

from graftbench.readings import window_work


def read(run):
    return window_work(run) * 3600.0 / run.window.seconds
