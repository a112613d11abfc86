"""Seconds from the process's start to the window's opening."""


def read(run):
    return run.setup_s
