"""Seconds from process start to the window's opening."""
from perfbench import readers


def read(run):
    return readers.setup_s(run)
