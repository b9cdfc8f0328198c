"""CUDA launch calls the host made per Adam iteration in the traced
stretch (``cudaLaunchKernel``, ``cuLaunchKernel*``, ``cudaGraphLaunch``
among the profiler's host events): the octave loop's dispatch cost, which
a CUDA graph or a fused kernel cuts."""


def read(summary):
    if not summary.get("iters"):
        return None
    return summary["launches"] / summary["iters"]
