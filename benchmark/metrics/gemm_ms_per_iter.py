"""Device milliseconds per Adam iteration in GEMM kernels: the shear
rotations' batched products and the Gram matrices, forward and
backward."""


def read(summary):
    s = summary.get("device_s", {})
    if not summary.get("iters") or not s.get("gemm"):
        return None
    return 1e3 * s["gemm"] / summary["iters"]
