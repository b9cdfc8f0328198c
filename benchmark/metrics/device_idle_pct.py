"""Share of the traced stretch in which no kernel, copy or memset ran on
the card: 100 * (1 - union of device intervals / the stretch's wall
time), both from the same stretch (``busy_s`` and ``window_s`` of the
line's ``device``). Device tracing adds host time to each launch, so a
stretch that the host bounds reads idler than it runs untraced. Not
clipped: a reading below 0 means the
intervals or the wall are counted wrong."""


def read(summary):
    if not summary.get("window_s") or not summary.get("busy_s"):
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
