"""Device milliseconds per Adam iteration in elementwise, reduction,
copy and memset kernels: the glue of the render, the losses and Adam."""


def read(summary):
    s = summary.get("device_s", {})
    if not summary.get("iters") or not s.get("elementwise"):
        return None
    return 1e3 * s["elementwise"] / summary["iters"]
