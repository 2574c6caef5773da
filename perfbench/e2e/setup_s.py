"""Seconds from the process's start to the first timed call."""


def read(window, setup_s):
    return setup_s
