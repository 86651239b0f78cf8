"""The line growth kernel, modelled in numpy, against the plain version.

``csrc/line_grow.cu`` grows the line detector's 16 seeds in one CTA: the edge
planes and ``is_line`` as bit rows (32 tiles a word), then one warp, a row a
lane in chunks of 32 rows, picking each seed (the largest key, weight bits
above the inverted tile index, over the available tiles) and growing it in
rounds: the diagonal in-edges one step from the round's start, a
carry-propagate add along each row right and left from the same set
(``__brev`` for the leftward one), then a Kogge-Stone scan down and up each
column over the lanes from the same set, chunks carried in turn, until a
round adds no tile.  The kernel cannot run here; ``kernel_model`` runs those
steps word by word as written, over numpy arrays whose rows are the lanes.
Its members and ``proceed`` must equal ``grow_seeds_reference`` (the closure rows for
``min_tiles <= 2``, ``_propagate`` above) and the seed loop over
``_propagate`` for every ``min_tiles``, on random directed 8-neighbour graphs
at 40x30 (the 640x480 grid), 120x67 (1920x1080's) and odd sizes, from sparse
to full, with equal weights and with no line tile; a model that drops one
kind of edge gives other members on some graph, so the cases see each edge.
On the striped wall's tile graphs it needs at most 3 rounds a seed, where a
search a tile a round needs 8-14.
"""

import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from rgbd_slam_tpu_torch import config, synthetic
from rgbd_slam_tpu_torch.features import lines
from rgbd_slam_tpu_torch.ops import line_grow_cuda, nvcc

torch.set_num_threads(2)

M32 = np.uint64(0xFFFFFFFF)
LANES = 32
SEEDS = line_grow_cuda.MAX_LINE_SEEDS


def _source() -> str:
    with open(os.path.join(nvcc.CSRC, "line_grow.cu")) as f:
        return f.read()


def _pack(plane, gh, gw):
    """[gh, gw] bool -> [gh, W] uint64 words of 32 bits, bit b of word k the
    tile (y, 32k + b)."""
    w = -(-gw // 32)
    padded = np.zeros((gh, 32 * w), bool)
    padded[:, :gw] = plane
    bits = padded.reshape(gh, w, 32).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)).sum(axis=-1).astype(np.uint64)


def _unpack(words, gh, gw):
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1)
    return bits.reshape(gh, -1)[:, :gw].astype(bool)


def _brev(x):
    """``__brev`` of each 32-bit word."""
    out = np.zeros_like(x)
    for b in range(32):
        out |= ((x >> np.uint64(b)) & np.uint64(1)) << np.uint64(31 - b)
    return out


def _from_left(rows, k):
    """Word k of every row with tile x taking x - 1's bit (the kernel's ``ul``
    and ``dl``)."""
    lo = rows[:, k - 1] >> np.uint64(31) if k > 0 else np.uint64(0)
    return ((rows[:, k] << np.uint64(1)) & M32) | lo


def _from_right(rows, k):
    """The same with tile x taking x + 1's bit (``ur``, ``dr``)."""
    w = rows.shape[1]
    hi = (rows[:, k + 1] << np.uint64(31)) & M32 if k + 1 < w else np.uint64(0)
    return (rows[:, k] >> np.uint64(1)) | hi


def _scan(g, p, down):
    """``lg_scan`` over 32 lanes: Kogge-Stone of the maps X -> g | p & X."""
    lane = np.arange(LANES)
    for d in (1, 2, 4, 8, 16):
        if down:
            g2, p2, take = np.roll(g, d), np.roll(p, d), lane >= d
        else:
            g2, p2, take = np.roll(g, -d), np.roll(p, -d), lane + d < LANES
        g, p = np.where(take, g | (p & g2), g), np.where(take, p & p2, p)
    return g, p


def _columns(e, avail, h, gh, down):
    """Step 3 of a round, down or up: every chunk of 32 rows scanned, then the
    chunks carried in turn (down from the first, up from the last)."""
    p_all = e & avail
    out = h.copy()
    starts = list(range(0, gh, LANES))
    for k in range(h.shape[1]):
        carry = np.uint64(0)
        for y0 in (starts if down else starts[::-1]):
            y = y0 + np.arange(LANES)
            inside = y < gh
            g = np.zeros(LANES, np.uint64)
            p = np.zeros(LANES, np.uint64)
            g[inside] = h[y[inside], k]
            p[inside] = p_all[y[inside], k]
            g, p = _scan(g, p, down)
            g = g | (p & carry)
            out[y[inside], k] = g[inside]
            carry = g[LANES - 1 if down else 0]
    return out


def _round(planes, avail, cur, gh, dropped=()):
    """A round of ``lg_seeds`` from ``cur``: (the next set, whether a tile
    joined).  ``dropped`` edge planes are left out (a faulty model)."""
    e = {s: (planes[s] if s not in dropped else np.zeros_like(planes[s])) for s in range(8)}
    w = cur.shape[1]
    zero = np.zeros((1, w), np.uint64)
    up = np.concatenate([zero, cur[:-1]])      # row y - 1 (none above row 0)
    down = np.concatenate([cur[1:], zero])     # row y + 1
    # 1. the diagonal in-edges, one step
    a = np.zeros_like(cur)
    for k in range(w):
        g = (e[4][:, k] & _from_left(up, k)) | (e[5][:, k] & _from_right(up, k)) \
            | (e[6][:, k] & _from_left(down, k)) | (e[7][:, k] & _from_right(down, k))
        a[:, k] = cur[:, k] | (g & avail[:, k])
    # 2. along each row, right over plane 0 and left over plane 1, both from a
    h = a.copy()
    carry = np.zeros(gh, np.uint64)
    spill = np.zeros(gh, np.uint64)
    for k in range(w):
        p = e[0][:, k] & avail[:, k]
        g = (((a[:, k] << np.uint64(1)) & M32) | spill) & p
        spill = a[:, k] >> np.uint64(31)
        total = p + g + carry
        carry = total >> np.uint64(32)
        h[:, k] |= g | (((total & M32) ^ p ^ g) & p)
    carry = np.zeros(gh, np.uint64)
    spill = np.zeros(gh, np.uint64)
    for k in reversed(range(w)):
        p = e[1][:, k] & avail[:, k]
        g = ((a[:, k] >> np.uint64(1)) | ((spill << np.uint64(31)) & M32)) & p
        spill = a[:, k] & np.uint64(1)
        rp, rg = _brev(p), _brev(g)
        total = rp + rg + carry
        carry = total >> np.uint64(32)
        h[:, k] |= g | (_brev((total & M32) ^ rp ^ rg) & p)
    # 3. down each column over plane 2 and up over plane 3, both from h
    nxt = _columns(e[2], avail, h, gh, down=True) | _columns(e[3], avail, h, gh, down=False)
    return nxt, bool((nxt != cur).any())


def _keys(weight):
    """A tile's key: its float32 weight's bits above its index inverted, as
    64-bit integers (Python ints)."""
    bits = np.asarray(weight, np.float32).view(np.uint32).astype(object)
    return [(int(b) << 32) | (0xFFFFFFFF - t) for t, b in enumerate(bits)]


def _pick(avail, keys, gw):
    """The seed: each lane's largest key over the available tiles of its rows
    (rows lane, lane + 32, ...), then a butterfly of shuffles taking the
    larger.  Returns the key (0: no available tile)."""
    tiles = _unpack(avail, avail.shape[0], gw)
    best = [0] * LANES
    for y, x in zip(*np.nonzero(tiles)):
        best[y % LANES] = max(best[y % LANES], keys[y * gw + x])
    for d in (16, 8, 4, 2, 1):
        best = [max(best[lane], best[lane ^ d]) for lane in range(LANES)]
    assert len(set(best)) == 1       # every lane holds the same seed
    return best[0]


def kernel_model(edges, is_line, weight, min_tiles, dropped=()):
    """(members [S, T] bool, proceed [S] bool, rounds [S] int) as
    ``line_grow_kernel`` computes them, from numpy inputs."""
    gh, gw = edges.shape[1:]
    t_count = gh * gw
    planes = {s: _pack(edges[s], gh, gw) for s in range(8)}
    avail = _pack(is_line.reshape(gh, gw), gh, gw)
    keys = _keys(weight)
    members = np.zeros((SEEDS, t_count), bool)
    proceed = np.zeros(SEEDS, bool)
    rounds = np.zeros(SEEDS, np.int64)
    for s in range(SEEDS):
        best = _pick(avail, keys, gw)
        if best == 0 or not np.uint32(best >> 32).view(np.float32) > 0.0:
            break
        seed = 0xFFFFFFFF - (best & 0xFFFFFFFF)
        sy, sx = divmod(seed, gw)
        cur = np.zeros_like(avail)
        cur[sy, sx // 32] = np.uint64(1) << np.uint64(sx % 32)
        changed = True
        while changed:
            rounds[s] += 1
            assert rounds[s] <= t_count + 1
            cur, changed = _round(planes, avail, cur, gh, dropped)
        m = cur & avail
        members[s] = _unpack(m, gh, gw).reshape(-1)
        proceed[s] = True
        if members[s].sum() >= min_tiles:
            avail &= ~m
        else:
            avail[sy, sx // 32] &= ~(np.uint64(1) << np.uint64(sx % 32))
    return members, proceed, rounds


def loop_members(edges, is_line, weight, min_tiles):
    """The seed loop over ``_propagate`` for any ``min_tiles``, as the JAX
    ``seed_step`` runs it: (members, proceed) numpy."""
    gh, gw = edges.shape[1:]
    e = torch.from_numpy(edges)
    available = is_line.copy()
    members, proceeds = [], []
    for _ in range(SEEDS):
        seed_w = np.where(available & is_line, weight, -1.0)
        seed = int(np.argmax(seed_w))
        proceed = bool(seed_w[seed] > 0)
        active = line_grow_cuda._propagate(torch.tensor([seed]), e, line_grow_cuda.SHIFTS,
                                           torch.from_numpy(available), gh, gw).numpy()
        active = active & is_line & available
        if proceed and active.sum() >= min_tiles:
            available = available & ~active
        elif proceed:
            available[seed] = False
        members.append(active)
        proceeds.append(proceed)
    return np.stack(members), np.array(proceeds)


def _reference(edges, is_line, weight, min_tiles):
    m, p = line_grow_cuda.grow_seeds_reference(torch.from_numpy(edges),
                                               torch.from_numpy(is_line),
                                               torch.from_numpy(weight), min_tiles)
    return m.numpy(), p.numpy()


#: (gh, gw): the 640x480 grid, 1920x1080's, and odd ones (one word and a
#: bit, a column past a chunk of 32 rows, a single row and column)
SIZES = {"40x30": (30, 40), "120x67": (67, 120), "37x29": (29, 37), "7x5": (5, 7),
         "33x33": (33, 33), "65x1": (1, 65), "1x70": (70, 1)}
DENSITIES = {"sparse": 0.1, "mid": 0.45, "dense": 0.8, "full": 1.0}
#: grids small enough for the [T, T] closure on the CPU
CLOSURE_TILES = 1500


def _graph(size, density, seed=7, **kw):
    gh, gw = SIZES[size]
    share = 1.0 if density == "full" else 0.7
    return chip_smoke.random_line_graph(gh, gw, seed, DENSITIES[density], line_share=share,
                                        **kw)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("size", SIZES)
def test_model_equals_the_plain_version(size, density):
    """For min_tiles 1-4: the model's members and proceed equal the seed loop
    over ``_propagate``, and, where the grid is small, ``grow_seeds_reference``
    (its closure rows for min_tiles <= 2)."""
    edges, is_line, weight = _graph(size, density)
    for min_tiles in (1, 2, 3, 4):
        got_m, got_p, rounds = kernel_model(edges, is_line, weight, min_tiles)
        want_m, want_p = loop_members(edges, is_line, weight, min_tiles)
        np.testing.assert_array_equal(got_p, want_p)
        np.testing.assert_array_equal(got_m, want_m)
        assert ((rounds > 0) == got_p).all()
        if is_line.size <= CLOSURE_TILES:
            ref_m, ref_p = _reference(edges, is_line, weight, min_tiles)
            np.testing.assert_array_equal(ref_p, want_p)
            np.testing.assert_array_equal(ref_m, want_m)


@pytest.mark.parametrize("size", ["40x30", "120x67"])
def test_model_on_equal_weights(size):
    """Weights of 3 whole numbers: most seeds are picked among equals, and the
    first (lowest) tile wins, as ``argmax`` picks."""
    edges, is_line, weight = _graph(size, "mid", seed=11, weight_levels=3)
    for min_tiles in (2, 3):
        got_m, got_p, _ = kernel_model(edges, is_line, weight, min_tiles)
        want_m, want_p = loop_members(edges, is_line, weight, min_tiles)
        np.testing.assert_array_equal(got_p, want_p)
        np.testing.assert_array_equal(got_m, want_m)
    assert got_p.all()


@pytest.mark.parametrize("size", ["40x30", "7x5"])
def test_model_with_no_line_tile(size):
    """No line tile: no seed proceeds and every member row is empty, in the
    model, the loop and the plain version."""
    edges, is_line, weight = _graph(size, "dense", seed=3)
    edges[:] = False
    is_line[:] = False
    got_m, got_p, rounds = kernel_model(edges, is_line, weight, 2)
    for m, p in (_reference(edges, is_line, weight, 2), loop_members(edges, is_line, weight, 2)):
        np.testing.assert_array_equal(got_m, m)
        np.testing.assert_array_equal(got_p, p)
    assert not got_p.any() and not got_m.any() and not rounds.any()


def test_model_stops_when_the_tiles_run_out():
    """The full grid in one set: the first seed consumes every tile, and the
    15 after it neither proceed nor hold a member."""
    edges, is_line, weight = _graph("120x67", "full")
    got_m, got_p, _ = kernel_model(edges, is_line, weight, 2)
    assert got_p[0] and not got_p[1:].any()
    assert got_m[0].all() and not got_m[1:].any()
    np.testing.assert_array_equal(got_m, loop_members(edges, is_line, weight, 2)[0])


@pytest.mark.parametrize("plane", range(8), ids=[str(s) for s in line_grow_cuda.SHIFTS])
def test_a_model_without_an_edge_kind_differs(plane):
    """A model that drops one edge plane gives other members on one of the
    cases: each kind of edge is exercised."""
    for size, density in (("40x30", "dense"), ("40x30", "full"), ("33x33", "mid")):
        edges, is_line, weight = _graph(size, density)
        got = kernel_model(edges, is_line, weight, 2, dropped=(plane,))[0]
        if not np.array_equal(got, loop_members(edges, is_line, weight, 2)[0]):
            return
    pytest.fail(f"no case sees edge plane {plane}")


def _wall_frames(n):
    cam = config.TUM_FR1
    scene = synthetic.StripeWallScene(cam, texture_scale=0.03, stripe_period_z=2400.0)
    return [scene.render(q, p)[0] for q, p in synthetic.lateral_trajectory(n, speed_mm=4.0)]


@pytest.mark.parametrize("frame", [0, 3, 20])
def test_model_on_the_striped_wall(frame):
    """The tile graph of a 640x480 striped-wall frame (the cell
    ``fr1_lines.stripe_wall``'s scene): the model equals the plain version,
    every seed proceeds, and each takes at most 3 rounds, where its stripe
    edges run 8-14 tiles down the image."""
    gray = _wall_frames(frame + 1)[frame]
    edges, is_line, weight = (x.numpy() for x in chip_smoke.line_graph(gray, "cpu"))
    got_m, got_p, rounds = kernel_model(edges, is_line, weight, 2)
    want_m, want_p = _reference(edges, is_line, weight, 2)
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_m, want_m)
    assert got_p.all() and rounds.max() <= 3, rounds
    assert got_m.sum(axis=1).max() >= 8


def test_grow_seeds_on_the_cpu_is_the_plain_version():
    """``grow_seeds`` on CPU tensors runs ``grow_seeds_reference``; the
    kernel's wrapper refuses them."""
    edges, is_line, weight = (torch.from_numpy(x) for x in _graph("40x30", "mid"))
    got = line_grow_cuda.grow_seeds(edges, is_line, weight, 2)
    want = line_grow_cuda.grow_seeds_reference(edges, is_line, weight, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].shape == (SEEDS, 1200) and got[1].shape == (SEEDS,)
    with pytest.raises(ValueError, match="CUDA tensors"):
        line_grow_cuda.grow_seeds_cuda(edges, is_line, weight, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        line_grow_cuda.grow_seeds(edges, is_line.to("meta"), weight, 2)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that says it lies on the card: the wrapper takes its CUDA
    path for it."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_the_wrapper_raises_and_never_falls_back(monkeypatch):
    """For a CUDA tensor the wrapper launches its kernel or raises: when the
    library does not build, the error reaches ``detect_lines``' caller and the
    plain version is never called; what the kernel does not take raises
    before any build."""
    def refuse(*args, **kw):
        raise AssertionError("the plain version ran for a CUDA tensor")

    def no_nvcc(*args, **kw):
        raise RuntimeError("nvcc failed on line_grow.cu")

    monkeypatch.setattr(line_grow_cuda, "grow_seeds_reference", refuse)
    monkeypatch.setattr(line_grow_cuda.LIBRARY, "lib", None)
    monkeypatch.setattr(nvcc, "load_library", no_nvcc)
    edges, is_line, weight = (torch.from_numpy(x).as_subclass(_CudaLooking)
                              for x in _graph("40x30", "mid"))
    with pytest.raises(RuntimeError, match="nvcc failed on line_grow.cu"):
        line_grow_cuda.grow_seeds(edges, is_line, weight, 2)
    with pytest.raises(ValueError, match="float32"):
        line_grow_cuda.grow_seeds(edges, is_line, weight.double().as_subclass(_CudaLooking), 2)
    with pytest.raises(ValueError, match="at most"):
        line_grow_cuda.grow_seeds(torch.zeros(8, 97, 40, dtype=torch.bool)
                                  .as_subclass(_CudaLooking), is_line, weight, 2)


def _defines(text: str) -> dict:
    values = {}
    for name, expr in re.findall(r"^#define (\w+) (.+)$", text, flags=re.M):
        try:
            values[name] = int(eval(expr.split("//")[0], {}, dict(values)))
        except (NameError, SyntaxError, TypeError):
            continue
    return values


def test_the_source_matches_the_wrapper_and_the_model():
    """The kernel's seeds, edge planes (in SHIFTS' order), shared memory
    layout and limit are the wrapper's, and ``detect_lines`` uses the same
    seeds and shifts."""
    text = _source()
    defs = _defines(text)
    shifts = re.search(r"// LG_SHIFTS (.+)$", text, flags=re.M).group(1)
    assert eval(f"({shifts})") == line_grow_cuda.SHIFTS == lines.SHIFTS
    assert defs["LG_SEEDS"] == SEEDS == lines.MAX_LINE_SEEDS
    assert defs["LG_PLANES"] == line_grow_cuda.PLANES
    assert defs["LG_HEAD_BYTES"] == line_grow_cuda.HEAD_BYTES
    assert defs["LG_MAX_SMEM"] == line_grow_cuda.MAX_SMEM_BYTES
    assert 32 * defs["LG_MAX_CHUNKS"] == line_grow_cuda.MAX_ROWS
    assert 32 * defs["LG_MAX_WORDS"] == line_grow_cuda.MAX_COLS
    assert (defs["LG_LINE"], defs["LG_MEMBERS"], defs["LG_KEY_BYTES"]) == (8, 9, 8)
    # one instance of the seeds a grid shape: every chunk and word count
    cases = set(re.findall(r"LG_CASE\((\d), (\d)\)", text))
    assert cases == {(str(c), str(w)) for c in range(1, defs["LG_MAX_CHUNKS"] + 1)
                     for w in range(1, defs["LG_MAX_WORDS"] + 1)}


def test_the_grid_limit():
    """1920x1080's 120x67 tiles fit (past the 48 KB a CTA gets without the
    opt-in); the largest grid, 128x96, fits one CTA's shared memory, and a
    row or a column more is refused."""
    line_grow_cuda.check_grid(30, 40)
    line_grow_cuda.check_grid(67, 120)
    assert 48 * 1024 < line_grow_cuda.smem_bytes(67, 120) <= line_grow_cuda.MAX_SMEM_BYTES
    assert line_grow_cuda.smem_bytes(30, 40) == 128 + 8 * 1200 + 4 * 25 * 60
    rows, cols = line_grow_cuda.MAX_ROWS, line_grow_cuda.MAX_COLS
    assert (rows, cols) == (96, 128)
    assert line_grow_cuda.smem_bytes(rows, cols) <= line_grow_cuda.MAX_SMEM_BYTES
    line_grow_cuda.check_grid(rows, cols)
    for gh, gw in ((rows + 1, cols), (rows, cols + 1)):
        with pytest.raises(ValueError, match="at most"):
            line_grow_cuda.check_grid(gh, gw)
    with pytest.raises(ValueError, match="empty"):
        line_grow_cuda.check_grid(0, 40)


def test_the_bound_counts_what_the_function_reads_and_writes():
    """At 640x480 (40x30 tiles): 15,600 bytes in (eight edge planes and
    is_line a byte a tile, the weights four) and 19,216 out (16 member rows
    and 16 flags), 0.0104 us at 3.35 TB/s."""
    work = line_grow_cuda.grow_work(30, 40)
    assert work == {"bytes": 15_600 + 19_216}
    assert work["bytes"] / 3.35e12 * 1e6 == pytest.approx(0.0104, abs=1e-4)

