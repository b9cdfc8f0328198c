"""Device milliseconds per Adam iteration under the program's span
``nfs.splat_color``: LNST's 5-channel colour pass and its normalization,
forward plus backward (``benchmark/spans.py`` puts a backward kernel to
its forward's span), over the ``nfs.iter`` spans of the kind's traced
host pass. None without that pass's span reduction (``spans``) or
without the span, as in a program that has none."""


def read(summary):
    s = summary.get("spans")
    if not s or not s["iters"] or "nfs.splat_color" not in s["device_s"]:
        return None
    return 1e3 * s["device_s"]["nfs.splat_color"] / s["iters"]
