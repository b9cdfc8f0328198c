"""Device milliseconds per Adam iteration in VGG's convolution and
pooling kernels (cuDNN), forward and backward."""


def read(summary):
    s = summary.get("device_s", {})
    if not summary.get("iters") or not (s.get("conv") or s.get("pool")):
        return None
    return 1e3 * (s.get("conv", 0.0) + s.get("pool", 0.0)) / summary["iters"]
