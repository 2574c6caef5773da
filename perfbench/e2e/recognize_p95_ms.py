"""The 95th percentile of every timed recognition call's host-clock time."""

from perfbench.window import percentile


def read(window, setup_s):
    if window.unit != "words" or not window.call_seconds:
        return None
    return 1e3 * percentile(window.call_seconds, 95)
