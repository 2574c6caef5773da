"""Every training sample the window's completed steps consumed, over the
window's seconds."""

from perfbench.window import rate


def read(window, setup_s):
    return rate(window.work, window.seconds) if window.unit == "samples" else None
