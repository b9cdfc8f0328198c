"""Bytes and operations of LNST's colour pass, counted from shapes: the
yardstick of ``color_splat_roofline_pct`` and the colour render's share
of ``step_mfu_pct``.

The count follows the work, not the program's layout: a 5-channel pass
[density, colour (3), ones] over ``n`` particles onto ``cells`` cells,
whatever kernel or slot layout computes it.

- Forward: each particle's 3 position and 4 attribute floats (density,
  colour) read once, 5 floats written per cell.
- Backward: the 5 gradient floats read per cell, each particle's position
  and attributes read again, and its 3 + 4 gradients written.

The colour render rotates the colour volume's 3 channels with the
density, by the same six shears, and resizes a 3-channel image where the
grey render resizes one (``counts.render_flops``).
"""

from __future__ import annotations

from typing import Sequence

from benchmark.roofline import counts

POSITION, ATTRS, CHANNELS = 3, 4, 5


def color_pass_floats(cells: int, n: int) -> float:
    """Floats the colour pass moves once, forward plus backward."""
    forward = (POSITION + ATTRS) * n + CHANNELS * cells
    backward = CHANNELS * cells + (POSITION + ATTRS) * n \
        + (POSITION + ATTRS) * n
    return float(forward + backward)


def color_pass_least_s(cells: int, n: int) -> float:
    """Least seconds of one iteration's colour pass at the HBM
    bandwidth."""
    return 4.0 * color_pass_floats(cells, n) / counts.HBM_BYTES_PER_S


def color_render_extra_least_s(shape: Sequence[int], out_size: Sequence[int],
                               views: int) -> float:
    """Least seconds one iteration's colour render adds to the grey
    render that ``counts.tnst_iteration_least_s`` counts: three more
    rotations and two more resized channels a view, float32, forward and
    backward."""
    rotation = counts.shear_rotate_flops(shape)
    resize = counts.render_flops(shape, out_size) - rotation
    return 2.0 * views * (3 * rotation + 2 * resize) / counts.PEAK_F32
