"""Seconds from the process's start to the window's open: imports, the
kernels built or loaded, weights and data made, the styler, the
warm-up."""


def read(window):
    return window["setup_s"]
