"""The advection kernels' (K1-K3, ``advect_*``) share of their roofline:
the least seconds of the advections the traced frames need, their bytes
once at the HBM bandwidth (``roofline/counts.py``), over the device time
of the ``advect_`` kernels."""


def read(summary):
    dev = summary.get("device_s", {}).get("advect")
    if not dev or not summary.get("transport_least_s"):
        return None
    return 100.0 * summary["transport_least_s"] / dev
