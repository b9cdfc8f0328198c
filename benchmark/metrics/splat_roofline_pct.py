"""The binned splat kernels' (K4-K5, ``binsplat_*``) share of their
roofline: the least seconds of the splats the traced keyframes need, each
particle's position and density and each grid cell moved once at the HBM
bandwidth (``roofline/counts.py``), over the device time of the
``binsplat_`` kernels."""


def read(summary):
    dev = summary.get("device_s", {}).get("binsplat")
    if not dev or not summary.get("splat_least_s"):
        return None
    return 100.0 * summary["splat_least_s"] / dev
