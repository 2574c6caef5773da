"""Every word whose text the window's calls returned, over the window's seconds."""

from perfbench.window import rate


def read(window, setup_s):
    return rate(window.work, window.seconds) if window.unit == "words" else None
