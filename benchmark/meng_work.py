"""The Meng 2015 albedo's frozen yardstick: the span that holds it, the
least work any implementation of it must do in a train step, and the
device time of the kernels launched inside that span.

The work is counted from what every implementation must move and compute,
whatever builds the albedo (the port's point-weight tensor and its
contraction, or a fused kernel without them), so that it reads the same
work before and after such a change:

- per step, each lane's hero wavelength ``lambda_0`` read once (4 B a lane);
- per bounce, each lane's texel word read once (4 B) and its S hero
  reflectances written once (4 S B);
- the grid's tables read once a step: the 186 x 81 point spectra, the 168
  cells' rows of 20 values and the 6 terms of the xy-to-uv matrix, in f32;
- 15 S FP32 operations a lane and bounce: the smallest stencil, 3 grid
  points, each a lerp between 2 of the 5-nm bins (3 operations) and a
  weighted add (2).

Lanes come from the run (``facts["k1_rays"]``, one sample a lane in the
train traffic); bounces (``max_depth - 1``) and S (``n_wavelengths``) from
the configuration file of :data:`CONFIG`, found by its name in
``BENCHMARK.json``.
"""

from __future__ import annotations

import bisect
import json
import os
from typing import Optional, Tuple

from benchmark import harness, program_spans
from benchmark.common import STEP_SPAN

# The program's span around the whole Meng albedo of one bounce
# (``render/shading.py``), frozen here like ``program_spans``' names.
MENG = "ss.meng"

# The configuration whose shapes the floor reads.
CONFIG = "cornell-srgb-meng-512"

# The grid of Meng et al. 2015 (``spectrum_grid.h``): 186 points of 81 bins,
# 12 x 14 cells, each row of the cell table 20 f32 values (inside, num, 6
# point ids, 6 u, 6 v), and the 2 x 3 xy-to-uv matrix.
GRID_POINTS = 186
GRID_BINS = 81
GRID_CELLS = 168
CELL_ROW = 20
UV_MATRIX = 6

# FP32 operations per lane, bounce and hero wavelength: 3 points x (lerp 3 +
# weighted add 2).
OPS_PER_LANE_WAVELENGTH = 15


def table_bytes() -> int:
    """Bytes of the grid's tables in f32."""
    return 4 * (GRID_POINTS * GRID_BINS + GRID_CELLS * CELL_ROW + UV_MATRIX)


def meng_work(lanes: int, bounces: int, n_wavelengths: int) -> Tuple[float, float]:
    """(FP32 operations, bytes) of the Meng albedo of one train step."""
    ops = float(OPS_PER_LANE_WAVELENGTH) * n_wavelengths * lanes * bounces
    bytes_moved = 4 * lanes + bounces * lanes * (4 + 4 * n_wavelengths) + table_bytes()
    return ops, float(bytes_moved)


def config_shape(root: str = harness.ROOT) -> Tuple[int, int]:
    """(bounces, hero wavelengths) of :data:`CONFIG`, from its file."""
    entry = {c["name"]: c for c in harness.load_spec(root)["configs"]}[CONFIG]
    with open(os.path.join(root, entry["file"])) as f:
        render = json.load(f)["render"]
    return int(render["max_depth"]) - 1, int(render["n_wavelengths"])


def device_us_per_step(run) -> Optional[float]:
    """The device time of the kernels launched inside :data:`MENG` spans,
    per traced train step, in microseconds (kernels paired with their
    launches by ``program_spans.matched_kernels``).  None where there is
    nothing to read: another kind, no trace, no such span (a program
    without it), unpaired kernels, or no kernel inside the spans."""
    tr = run.trace
    if run.kind != "train" or tr is None:
        return None
    iv = program_spans.intervals(tr, MENG)
    pairs = program_spans.matched_kernels(tr, STEP_SPAN) if iv else None
    if not pairs:
        return None
    starts = [s for s, _ in iv]

    def inside(t):
        j = bisect.bisect_right(starts, t) - 1
        return j >= 0 and t < iv[j][1]

    total = sum(ke - ks for call in pairs for t, (_, ks, ke) in call if inside(t))
    return total / len(pairs) if total > 0 else None
