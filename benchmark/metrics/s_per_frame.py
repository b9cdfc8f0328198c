"""Seconds per output frame: all the window's host seconds over all the
frames finished in it (a TNST frame when its density is on the host, an
LNST frame when its interpolated particles are)."""


def read(window):
    return window["window_s"] / window["frames"] if window["frames"] else None
