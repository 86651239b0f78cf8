"""The components kernel, modelled in numpy, against the JAX loop.

``csrc/components.cu`` labels the plane extraction's cell graph in one CTA:
a flags pass takes each cell's symmetric edges whose two ends are planar and
its run of right edges along its warp's 32 cells (a ballot), then rounds of
min-label propagation, each over a cell's vertical neighbours and the
horizontal ones across a warp, then over its whole run (a segmented shuffle
minimum), then one pointer jump, until a round changes no label.  The kernel
cannot run here; ``kernel_model`` runs its passes as written, every CUDA warp
a generator that yields between its reads and its writes, and a scheduler
that interleaves the warps in lockstep (ascending or descending) or in a
seeded random order, so a warp reads some of the round's writes of the others
and misses the rest.  The labels must equal JAX ``_connected_components``
(``rgbd_slam_tpu/features/primitives.py:267``) and the port's plain version
``components_reference`` on every grid and in every order: the labels do not
depend on the order of the warps.  A model that drops one kind of edge gives
other labels on some grid, so the cases can see a missing edge.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rgbd_slam_tpu.features import primitives as j_prim
from rgbd_slam_tpu_torch.ops import components_cuda, nvcc

WARP = 32
#: the kernel's threads a CTA at most, and its flag bits (``csrc/components.cu``)
CC_THREADS = 1024
CC_PLANAR, CC_UP, CC_DOWN, CC_LEFT_OUT, CC_RIGHT_OUT = 1, 2, 4, 8, 16
CC_START_SHIFT, CC_END_SHIFT = 5, 10
EDGE_FLAGS = {"up": CC_UP, "down": CC_DOWN, "left_out": CC_LEFT_OUT,
              "right_out": CC_RIGHT_OUT}
#: rounds a model run may take: a loop that does not end fails the test
MAX_ROUNDS = 2000


def _border_wrap(gh, gw):
    """Every cell planar and only the directed edges that ``roll`` wraps
    around the border: the first column's e0 and the last's e1, the first
    row's e2 and the last's e3.  Each cell is its own component."""
    edges = np.zeros((4, gh, gw), bool)
    edges[0, :, 0] = edges[1, :, -1] = edges[2, 0, :] = edges[3, -1, :] = True
    return edges, np.ones(gh * gw, bool)


def _border_full(gh, gw):
    """The wrap-around edges beside the real edges along the border (the
    first and last rows and columns joined), the inside cut off."""
    edges, planar = _border_wrap(gh, gw)
    edges[1, 0, :] = edges[1, -1, :] = edges[3, :, 0] = edges[3, :, -1] = True
    planar.reshape(gh, gw)[1:-1, 1:-1] = False
    return edges, planar


#: name -> (edges [4, gh, gw], planar [C]) numpy bool
GRIDS = {
    "serpentine_32x24": lambda: chip_smoke.serpentine_grid(24, 32),
    "spiral_32x24": lambda: chip_smoke.spiral_grid(24, 32),
    "full_32x24": lambda: (np.ones((4, 24, 32), bool), np.ones(24 * 32, bool)),
    "non_planar_32x24": lambda: (chip_smoke.random_grid(24, 32, 1)[0],
                                 np.zeros(24 * 32, bool)),
    "row_40x1": lambda: chip_smoke.random_grid(1, 40, 2, planar_ends=False),
    "column_1x40": lambda: chip_smoke.random_grid(40, 1, 3, planar_ends=False),
    "random_32x24": lambda: chip_smoke.random_grid(24, 32, 4, planar_ends=False),
    "random_40x30": lambda: chip_smoke.random_grid(30, 40, 5, planar_ends=False),
    "border_wrap_33x5": lambda: _border_wrap(5, 33),
    "border_full_33x5": lambda: _border_full(5, 33),
}
ORDERS = ["lockstep", "lockstep_descending", "random_0", "random_1", "random_2"]


def kernel_flags(edges, planar, gh, gw):
    """The kernel's flags pass: each cell's flags (planar; an edge up, down,
    left out of its warp's first lane, right out of its last; the first and
    last lane of its run along the warp)."""
    c = gh * gw
    e = edges.reshape(4, c)
    i = np.arange(c)
    y, x = i // gw, i % gw
    right = np.zeros(c, bool)
    down = np.zeros(c, bool)
    r = x < gw - 1
    right[r] = planar[r] & planar[i[r] + 1] & (e[0][i[r] + 1] | e[1][r])
    d = y < gh - 1
    down[d] = planar[d] & planar[i[d] + gw] & (e[2][i[d] + gw] | e[3][d])
    left = np.zeros(c, bool)
    left[1:] = right[:-1]         # the same symmetric edge, seen from its other end
    up = np.zeros(c, bool)
    up[gw:] = down[:-gw]
    flags = np.zeros(c, np.int64)
    for i0 in range(0, c, WARP):
        lanes = range(min(WARP, c - i0))
        runs = sum(1 << lane for lane in lanes if right[i0 + lane]) & 0x7FFFFFFF  # ballot
        for lane in lanes:
            breaks = ~runs & ((1 << lane) - 1)
            start = breaks.bit_length()                                  # 32 - __clz
            end = min(WARP - 1, lane + ((~(runs >> lane)) & -(~(runs >> lane))).bit_length() - 1)
            k = i0 + lane
            flags[k] = (int(planar[k]) * CC_PLANAR | int(up[k]) * CC_UP | int(down[k]) * CC_DOWN
                        | int(lane == 0 and left[k]) * CC_LEFT_OUT
                        | int(lane == WARP - 1 and right[k]) * CC_RIGHT_OUT
                        | start << CC_START_SHIFT | end << CC_END_SHIFT)
    return flags


def kernel_model(edges, planar, gh, gw, order, drop=0):
    """The kernel's labels [C] int64 and its rounds, the warps interleaved in
    ``order``; ``drop`` clears those edge flags (a fault planted in the model)."""
    c = gh * gw
    threads = min(CC_THREADS, -(-c // WARP) * WARP)
    flags = kernel_flags(edges, planar, gh, gw) & ~drop
    lbl = np.where(planar, np.arange(c), c).astype(np.int64)
    rng = np.random.default_rng(int(order.split("_")[1])) if order.startswith("random") \
        else None

    def warp(w, changed):
        for i0 in range(w * WARP, c, threads):
            idx = np.arange(i0, min(i0 + WARP, c))
            f = flags[idx]
            own = lbl[idx].copy()
            m = own.copy()
            for bit, step in ((CC_UP, -gw), (CC_DOWN, gw), (CC_LEFT_OUT, -1), (CC_RIGHT_OUT, 1)):
                has = (f & bit) != 0
                m[has] = np.minimum(m[has], lbl[idx[has] + step])
            yield                                       # the neighbour reads are done
            start = (f >> CC_START_SHIFT) & 31
            end = (f >> CC_END_SHIFT) & 31
            run_min = np.array([m[start[k]:end[start[k]] + 1].min() for k in range(len(idx))])
            here = (f & CC_PLANAR) != 0
            jumped = run_min.copy()
            jumped[here] = np.minimum(run_min[here], lbl[run_min[here]])
            yield                                       # the pointer jump's read is done
            lower = here & (jumped < own)
            lbl[idx[lower]] = jumped[lower]
            changed[0] |= bool(lower.any())

    for rounds in range(1, MAX_ROUNDS):
        changed = [False]
        live = [warp(w, changed) for w in range(threads // WARP)]
        if order == "lockstep_descending":
            live.reverse()
        while live:
            ticks = list(live) if rng is None else [live[int(rng.integers(len(live)))]]
            for gen in ticks:
                try:
                    next(gen)
                except StopIteration:
                    live.remove(gen)
        if not changed[0]:
            return lbl, rounds
    raise AssertionError("the rounds did not end")


@functools.lru_cache(maxsize=None)
def jax_labels(name):
    edges, planar = GRIDS[name]()
    gh, gw = edges.shape[1:]
    return np.asarray(j_prim._connected_components(jnp.asarray(edges), jnp.asarray(planar),
                                                   gh, gw)).astype(np.int64)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_the_kernels_rounds_give_the_jax_labels_in_any_order(name, order):
    edges, planar = GRIDS[name]()
    gh, gw = edges.shape[1:]
    want = jax_labels(name)
    plain = components_cuda.components_reference(torch.from_numpy(edges),
                                                 torch.from_numpy(planar), gh, gw)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(kernel_model(edges, planar, gh, gw, order)[0], want)


def test_the_grids_hold_what_their_names_say():
    """The cases are not trivial: the spiral is two long chains, the random
    grids hold many components and edges into non-planar cells, the wrap-around
    edges join nothing."""
    c = 24 * 32
    spiral = jax_labels("spiral_32x24")
    assert len(np.unique(spiral)) == 3 and (spiral == c).sum() == 1
    assert min((spiral == k).sum() for k in np.unique(spiral[spiral < c])) > 300
    for name in ("random_32x24", "random_40x30"):
        edges, planar = GRIDS[name]()
        assert len(np.unique(jax_labels(name))) > 20
        assert (edges & ~planar.reshape(edges.shape[1:])[None]).any()
    np.testing.assert_array_equal(jax_labels("border_wrap_33x5"), np.arange(5 * 33))
    np.testing.assert_array_equal(np.unique(jax_labels("border_full_33x5")), [0, 5 * 33])
    assert (jax_labels("non_planar_32x24") == c).all()
    assert (jax_labels("full_32x24") == 0).all()


def test_a_row_run_takes_one_round():
    """A label crosses a run of right edges in one round: the serpentine,
    whose 24 rows are runs, ends in far fewer rounds than its 768 cells (the
    first design's own order took 36 on the card)."""
    edges, planar = GRIDS["serpentine_32x24"]()
    assert kernel_model(edges, planar, 24, 32, "lockstep")[1] <= 8


def test_the_model_is_the_sources():
    """The model's thread count, flag bits and passes are the kernel's, as
    the source reads."""
    with open(f"{nvcc.CSRC}/components.cu") as f:
        text = f.read()
    for name, value in [("CC_THREADS", CC_THREADS), ("CC_PLANAR", CC_PLANAR), ("CC_UP", CC_UP),
                        ("CC_DOWN", CC_DOWN), ("CC_LEFT_OUT", CC_LEFT_OUT),
                        ("CC_RIGHT_OUT", CC_RIGHT_OUT), ("CC_START_SHIFT", CC_START_SHIFT),
                        ("CC_END_SHIFT", CC_END_SHIFT)]:
        assert f"#define {name} {value}\n" in text, name
    for line in ["const unsigned runs = __ballot_sync(FULL_MASK, right) & 0x7fffffffu;",
                 "const int start = breaks ? 32 - __clz(breaks) : 0;",
                 "const int end = min(31, lane + __ffs(~(runs >> lane)) - 1);",
                 "lbl[i] = here ? i : c;",
                 "if (f & CC_UP) m = min(m, lbl[i - gw]);",
                 "if (f & CC_DOWN) m = min(m, lbl[i + gw]);",
                 "if (f & CC_LEFT_OUT) m = min(m, lbl[i - 1]);",
                 "if (f & CC_RIGHT_OUT) m = min(m, lbl[i + 1]);",
                 "if (lane + d <= end) m = min(m, v);",
                 "m = __shfl_sync(FULL_MASK, m, (f >> CC_START_SHIFT) & 31);",
                 "m = min(m, lbl[m]);",
                 "while (__syncthreads_or(cc_step(lbl, i, f, own, gw, lane))) {}",
                 "changed |= cc_step(lbl, i, i < c ? flags[i] : none, own, gw, lane);"]:
        assert line in text, line


@pytest.mark.parametrize("edge", sorted(EDGE_FLAGS))
def test_a_model_without_one_edge_kind_gives_other_labels(edge):
    """Each kind of edge the kernel reads is needed: with it dropped, the
    model's labels differ from the JAX loop's on some grid."""
    wrong = []
    for name in ("spiral_32x24", "random_32x24", "random_40x30", "row_40x1", "column_1x40"):
        edges, planar = GRIDS[name]()
        gh, gw = edges.shape[1:]
        got = kernel_model(edges, planar, gh, gw, "lockstep", drop=EDGE_FLAGS[edge])[0]
        wrong += [name] if not np.array_equal(got, jax_labels(name)) else []
    assert wrong
