"""The whole step's share of the card's peak: the least seconds of a
frame's iterations (``roofline/counts.py``: bfloat16 convolutions and Gram
products at the bfloat16 peak, float32 shears and resizes at the float32
peak, forward and backward), over the untraced seconds per output frame
of the same run."""


def read(summary):
    if not summary.get("s_per_frame") or "least_frame_s" not in summary:
        return None
    return 100.0 * summary["least_frame_s"] / summary["s_per_frame"]
