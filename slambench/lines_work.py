"""What the line path's tile section needs on the card, for its roofline share
(``slambench/metrics/line_tiles_roofline.py``).  Pure arithmetic from the
frame's size, so that the CPU tests hold it.

The section ``line_tiles`` of the step (``features.lines.detect_lines`` up to
its stamp) takes the gray image through the gradients and the 16 px tiles'
edge statistics to the directed tile graph, each tile joined to at most its 8
neighbours, and to that graph's reach closure, [T, T].  The count is of what
that function needs, not of how the program computes it: the program closes
the graph with dense matrix products, but a search of the sparse graph from
each tile reaches the same closure with far fewer operations, and the closure
must be written whichever way it is made.  ``TILE`` and ``EDGES`` are frozen
copies of the program's ``features.lines.TILE`` and ``len(SHIFTS)``
(commit 5c23dda); a test holds them equal.
"""

from __future__ import annotations

#: the detector's tile side, px
TILE = 16
#: a tile's neighbours in the tile graph: the edges a tile can have
EDGES = 8
#: float32 statistics the tile pass writes a tile: weight, count, centroid
#: (2), second moment (4), the double-angle means (2) and the coherence
TILE_FLOATS = 11


def line_tiles_work(h: int, w: int) -> dict:
    """The section's work at an H x W image.  Operations: a search of the
    tile graph from each of its T tiles tests each reached tile's ``EDGES``
    edges once, ``EDGES T^2``; the pixel pass's few dozen operations a pixel
    are left out.  Bytes: the image read once (float32), the tile statistics
    and the line flag written a tile, the closure written once as one byte a
    tile pair.  Bytes bound it on the card.  The work does not depend on the
    image."""
    t = (h // TILE) * (w // TILE)
    return {"tiles": t, "flops": EDGES * t * t,
            "bytes": 4 * h * w + (4 * TILE_FLOATS + 1) * t + t * t}
