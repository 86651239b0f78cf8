"""The plane extraction's cylinder stage (``ops.cylinders_cuda``) on the CPU:
its plain version ``cylinders_reference``, which ``find_primitives`` runs for
a CPU tensor, against the JAX code the CUDA kernel replaces (``_cylinder_axis``
over every region, the cumsum selection, ``_fit_cylinder`` over the slots and
the one-hot routing back, as the jitted ``find_primitives`` runs them) on the
cylinder stage's inputs of the scenes of ``test_torch_primitives.py``, as
found and with every non-empty region made a candidate (more candidates than
slots) and with the tunnel's region cut in six (more candidates that pass the
axis gate than slots); ``cylinders_work`` against hand counts; the card
check's MSAC flip rule (``chip_smoke.subsegment_flip``) on the plain version's
own rounds and on planted faults; the wrapper raising, and never taking its plain
version, for CUDA tensors whose library does not build.  The kernel itself
runs only on the card (``tests/test_torch_cuda.py``).

Tolerances, float32 on both sides, as at the head of
``test_torch_primitives.py``: the axis gate and the selection equal; the axis
of a region that holds a slot 1e-5 (sign included), plus what the closed
form's conditioning moves it where the region's two smallest eigenvalues
nearly tie (a region of planes, which the forced cases hold); each slot's
sub-segments against the JAX ``_fit_cylinder`` from the port's axis: valid
flags and inlier cells equal (or a round the card check's flip rule permits),
centre and radius 1e-2 mm (plus the LLS fit's conditioning,
``chip_smoke.lls_length_tolerance``, where the inliers' normals point one way),
MSE 1e-6 radius^2 plus what those move it; the regions without a slot hold 0,
inf and False.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rgbd_slam_tpu.features import primitives as j_prim
from rgbd_slam_tpu_torch import config as tcfg
from rgbd_slam_tpu_torch.features import primitives
from rgbd_slam_tpu_torch.ops import cylinders_cuda, nvcc
from test_primitives import CFG
from test_torch_primitives import SCENES, _scene_depth, _within

torch.set_num_threads(2)

DET = tcfg.DetectionConfig()


def _jax_stage(grid, member, try_cyl, min_activated):
    """The JAX find_primitives' cylinder stage (primitives.py:497-525)."""
    g = j_prim.CellGrid(**{k: jnp.asarray(v.numpy()) for k, v in grid._asdict().items()})
    member, try_cyl = jnp.asarray(member.numpy()), jnp.asarray(try_cyl.numpy())
    k_cand, n_cells = member.shape
    n_slots, s_ = j_prim.MAX_CYLINDERS, j_prim.CYL_SUBSEGMENTS
    cy_axis, axis_ok = jax.vmap(lambda m: j_prim._cylinder_axis(g, m, CFG))(member)
    cyl_cand = try_cyl & axis_ok
    r_rank = jnp.cumsum(cyl_cand.astype(jnp.int32)) - 1
    r_sel = cyl_cand & (r_rank < n_slots)
    region_idx = jnp.zeros((n_slots,), jnp.int32).at[
        jnp.where(r_sel, r_rank, n_slots)].set(jnp.arange(k_cand, dtype=jnp.int32),
                                                mode="drop")
    region_live = jnp.arange(n_slots) < jnp.sum(r_sel.astype(jnp.int32))
    sel_centers, sel_radii, sel_mses, sel_valids, sel_inliers = jax.vmap(
        lambda m, ax, ok: j_prim._fit_cylinder(g, m, ax, ok, CFG, min_activated))(
        member[region_idx], cy_axis[region_idx], region_live)
    tgt = jnp.where(region_live, region_idx, k_cand)
    r_onehot = (tgt[None, :] == jnp.arange(k_cand)[:, None]).astype(jnp.float32)
    cy_centers = (r_onehot @ sel_centers.reshape(n_slots, -1)).reshape(k_cand, s_, 3)
    cy_radii = r_onehot @ sel_radii
    cy_valids = (r_onehot @ sel_valids.astype(jnp.float32)) > 0.5
    cy_mses = jnp.where(cy_valids, r_onehot @ jnp.where(jnp.isfinite(sel_mses), sel_mses,
                                                        0.0), jnp.inf)
    cy_inliers = ((r_onehot @ sel_inliers.reshape(n_slots, -1).astype(jnp.float32))
                  > 0.5).reshape(k_cand, s_, n_cells)
    return [np.asarray(x) for x in (cy_axis, axis_ok, r_sel, cy_centers, cy_radii,
                                    cy_valids, cy_mses, cy_inliers)]


def _stage_inputs(scene, forced):
    depth, _, cam = _scene_depth(scene)
    grid, member, try_cyl, min_activated = chip_smoke.cylinder_inputs(
        cam, DET, torch.from_numpy(np.asarray(depth, np.float32)))
    if forced:   # every region with cells a candidate: more than the slots
        try_cyl = member.any(dim=-1)
    return grid, member, try_cyl, min_activated


@pytest.mark.parametrize("forced", [False, True], ids=["found", "forced"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_cylinders_reference_matches_jax(scene, forced):
    grid, member, try_cyl, min_activated = _stage_inputs(scene, forced)
    got = cylinders_cuda.cylinder_stage(grid, member, try_cyl, DET, min_activated)
    assert isinstance(got, cylinders_cuda.CylinderStage)
    t = [x.numpy() for x in got]
    j = _jax_stage(grid, member, try_cyl, min_activated)
    names = cylinders_cuda.CylinderStage._fields
    for k in (1, 2):   # axis_ok, selected
        np.testing.assert_array_equal(t[k], j[k], err_msg=names[k])
    _hold_selected(grid, member, min_activated, got, j)
    idle = ~j[2]
    assert not t[5][idle].any() and not t[7][idle].any()
    assert np.all(t[3][idle] == 0) and np.all(t[4][idle] == 0) and np.all(np.isinf(t[6][idle]))
    assert np.all(np.isinf(t[6][~t[5]]))
    if forced and scene in ("corner", "room", "tunnel"):
        assert j[2].sum() >= 1


def _hold_selected(grid, member, min_activated, got, j):
    """Each region that holds a slot: its axis to 1e-5, or, where the
    region's two smallest eigenvalues lie within the closed form's tolerance
    of each other (a region of planes: its axis is not determined), to what
    that moves it (``chip_smoke.eig3_tolerance``, as the card check holds
    it); then its sub-segments to the JAX ``_fit_cylinder`` run from the
    port's own axis: valid flags and inliers equal, or a differing round
    permitted by ``chip_smoke.subsegment_flip`` (the later rounds of that
    region then start from other cells and are not compared)."""
    g = j_prim.CellGrid(**{k: jnp.asarray(v.numpy()) for k, v in grid._asdict().items()})
    w0 = (member & grid.planar).double()
    nrm = grid.normal.double()
    nn64 = torch.einsum("kc,ci,cj->kij", w0, nrm, nrm)
    tol_lam, lam = chip_smoke.eig3_tolerance(nn64, w0.sum(-1) ** 2 * chip_smoke.F32_EPS)
    tol_axis = (1e-5 + tol_lam / (lam[:, 1] - lam[:, 0]).clamp_min(1e-30)).numpy()
    n_hyp = primitives._msac_iterations(DET)
    trunc = DET.cylinder_ransac_sqrt_max_distance
    for r in np.flatnonzero(j[2]):
        _within(got.axis[r].numpy(), j[0][r], tol_axis[r], f"axis of region {r}")
        ref = [np.array(x) for x in j_prim._fit_cylinder(
            g, jnp.asarray(member[r].numpy()), jnp.asarray(got.axis[r].numpy()),
            jnp.asarray(True), CFG, min_activated)]
        centers, radii, mses, valids, inliers = ref
        remaining = member[r] & grid.planar
        for si in range(valids.shape[0]):
            if bool(got.valids[r, si]) != bool(valids[si]) \
                    or not np.array_equal(got.inliers[r, si].numpy(), inliers[si]):
                f = chip_smoke.subsegment_flip(grid, got.axis[r], remaining, si, n_hyp,
                                               trunc, got.valids[r, si], got.inliers[r, si])
                assert f["permitted"], (r, si, f)
                break
            if valids[si]:
                rad = abs(float(radii[si]))
                tol = chip_smoke.lls_length_tolerance(grid, got.axis[r],
                                                      torch.from_numpy(inliers[si]), rad)
                _within(got.centers[r, si].numpy(), centers[si], tol, "centers")
                _within(got.radii[r, si].numpy(), radii[si], tol, "radii")
                _within(got.mses[r, si].numpy(), mses[si],
                        1e-6 * rad ** 2 + 4 * np.sqrt(mses[si]) * tol + 4 * tol ** 2, "mses")
            remaining = remaining & ~torch.from_numpy(inliers[si])


def _tunnel_split(parts):
    """The tunnel scene's cylinder region cut into ``parts`` regions of
    consecutive cells, each a candidate (a strip of a cylinder passes the axis
    gate)."""
    grid, member, try_cyl, min_activated = _stage_inputs("tunnel", False)
    r = int((try_cyl & member.any(dim=-1)).nonzero()[0])
    cells = (member[r] & grid.planar).nonzero().flatten()
    member = torch.zeros_like(member)
    for i, chunk in enumerate(cells.chunk(parts)):
        member[i, chunk] = True
    return grid, member, member.any(dim=-1), min_activated


def test_candidates_past_the_slots():
    """Six candidate regions (the tunnel cut in six) for four slots: the
    first four in region order hold them, each held to JAX as above, and the
    other two keep the fill values."""
    grid, member, try_cyl, min_activated = _tunnel_split(6)
    got = cylinders_cuda.cylinder_stage(grid, member, try_cyl, DET, min_activated)
    j = _jax_stage(grid, member, try_cyl, min_activated)
    cand = (try_cyl & got.axis_ok).nonzero().flatten()
    assert len(cand) == 6
    assert torch.equal(got.selected.nonzero().flatten(), cand[:primitives.MAX_CYLINDERS])
    np.testing.assert_array_equal(got.selected.numpy(), j[2])
    _hold_selected(grid, member, min_activated, got, j)
    assert got.valids[:4].any() and not got.valids[4:].any()


def test_cylinders_work_at_640x480():
    """Hand counts at the main path's shapes (768 cells, 20 regions, 43
    hypotheses, 3 sub-segments): 34,580 bytes read (normals and means 9,216
    each, planar 768, regions 15,360, candidates 20) and 47,620 written (axes
    240, two flags 40, centres 720, radii, MSEs 240 each, valid flags 60,
    inliers 46,080); 20 x (19 x 768 + 160) = 295,040 flops of the axis gate,
    and for each live region 30 x 768 + 3 x (60 x 43 + 23 x 43 x 768 + 59 x
    768) = 2,445,372."""
    dead = cylinders_cuda.cylinders_work(768, 20, 43, 3, 0)
    assert dead == {"live": 0, "bytes": 34_580 + 47_620, "flops": 295_040}
    one = cylinders_cuda.cylinders_work(768, 20, 43, 3, 1)
    assert one["flops"] == 295_040 + 23_040 + 3 * (2_580 + 759_552 + 45_312)
    assert cylinders_cuda.cylinders_work(768, 20, 43, 3, 4)["flops"] \
        == 295_040 + 4 * (one["flops"] - 295_040)
    assert primitives._msac_iterations(DET) == 43


def test_msac_flip_rule_passes_the_plain_rounds_and_fails_planted_faults():
    """``chip_smoke.subsegment_flip`` (the card check's rule for a round whose
    result differs) permits the plain version's own result of each round of
    the tunnel regions, and refuses inliers that no hypothesis gives (ten
    inliers far from the threshold dropped) and the inliers of a hypothesis
    whose score lies far above the best."""
    grid, member, try_cyl, min_activated = _tunnel_split(3)
    want = cylinders_cuda.cylinders_reference(grid, member, try_cyl, DET, min_activated)
    n_hyp = primitives._msac_iterations(DET)
    trunc = DET.cylinder_ransac_sqrt_max_distance
    planted = 0
    for r in want.selected.nonzero().flatten().tolist():
        remaining = member[r] & grid.planar
        for si in range(primitives.CYL_SUBSEGMENTS):
            f = chip_smoke.subsegment_flip(grid, want.axis[r], remaining, si, n_hyp, trunc,
                                           want.valids[r, si], want.inliers[r, si])
            assert f["permitted"], f
            if bool(want.valids[r, si]):
                scores, d2, d2_bound, _ = chip_smoke.msac_round64(
                    grid, want.axis[r], remaining, si, n_hyp, trunc)
                far = want.inliers[r, si] & ((d2[f["best"]] - trunc).abs()
                                             > 10 * d2_bound[f["best"]])
                dropped = want.inliers[r, si].clone()
                dropped[far.nonzero().flatten()[:10]] = False
                bad = chip_smoke.subsegment_flip(grid, want.axis[r], remaining, si, n_hyp,
                                                 trunc, torch.tensor(True), dropped)
                assert not bad["permitted"], bad
                planted += int(bool(far.any()))
                order = scores.argsort(descending=True).tolist()
                for b in order:
                    inl = remaining & (d2[b] < trunc)
                    if bool(inl.sum() >= 6) and not torch.equal(inl, want.inliers[r, si]):
                        bad = chip_smoke.subsegment_flip(grid, want.axis[r], remaining, si,
                                                         n_hyp, trunc, torch.tensor(True), inl)
                        assert not bad["permitted"], bad
                        planted += 1
                        break
            remaining = remaining & ~want.inliers[r, si]
    assert planted >= 1


class _CudaLooking(torch.Tensor):
    """A CPU tensor that says it lies on the card: the wrapper takes its CUDA
    path for it."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cylinders_wrapper_raises_and_never_falls_back(monkeypatch):
    """For CUDA tensors the wrapper launches its kernel or raises: when the
    library does not build, the error reaches the caller and the plain
    version is never called."""
    grid, member, try_cyl, min_activated = _stage_inputs("cylinder", False)

    def refuse(*args, **kw):
        raise AssertionError("the plain version ran for CUDA tensors")

    def no_nvcc(*args, **kw):
        raise RuntimeError("nvcc failed on cylinders.cu")

    def card(t):
        return t.as_subclass(_CudaLooking)

    monkeypatch.setattr(cylinders_cuda, "cylinders_reference", refuse)
    monkeypatch.setattr(cylinders_cuda.LIBRARY, "lib", None)
    monkeypatch.setattr(nvcc, "load_library", no_nvcc)
    c_grid = grid._replace(normal=card(grid.normal), mean=card(grid.mean),
                           planar=card(grid.planar))
    with pytest.raises(RuntimeError, match="nvcc failed on cylinders.cu"):
        cylinders_cuda.cylinder_stage(c_grid, card(member), card(try_cyl), DET,
                                      min_activated)
    # what the kernel does not take raises before any build
    with pytest.raises(ValueError, match="member must be"):
        cylinders_cuda.cylinder_stage(c_grid, card(member.to(torch.uint8)), card(try_cyl),
                                      DET, min_activated)
    with pytest.raises(ValueError, match="cells: the cylinders kernel takes 1 to"):
        big = cylinders_cuda.MAX_CELLS + 1   # past the global-memory path too
        cylinders_cuda.check_inputs(
            grid._replace(normal=card(torch.zeros(big, 3)), mean=card(torch.zeros(big, 3)),
                          planar=card(torch.zeros(big, dtype=torch.bool))),
            card(torch.zeros(20, big, dtype=torch.bool)),
            card(torch.zeros(20, dtype=torch.bool)), 43, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        cylinders_cuda.cylinder_stage(grid, member.to("meta"), try_cyl, DET, min_activated)
