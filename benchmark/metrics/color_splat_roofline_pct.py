"""The colour pass's share of its roofline: the least seconds of the
traced host pass's colour passes, their bytes once at the HBM bandwidth
(``roofline/color.py``), over the device time under ``nfs.splat_color``
in the same pass. None where either is missing."""


def read(summary):
    s = summary.get("spans")
    dev = s["device_s"].get("nfs.splat_color") if s else None
    if not dev or not summary.get("color_splat_least_s"):
        return None
    return 100.0 * summary["color_splat_least_s"] / dev
