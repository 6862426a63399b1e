"""The calibrating norm's plan (``kernels.ailayernorm.calib_plan``), which
lays out ``calib_norm_kernel``'s launch from the shape alone, and the
wrapper's meta branch, which allocates what the launch writes and reports
the kernel's work to the dry run's cost counter.

The plan decides no bit of a result (the calibration is a maximum, exact in
any order; the card tests hold every route to the torch chain), so these
tests check its geometry: every row taken by exactly one CTA, the CTAs
within the co-resident limit they were given, a CTA's shared memory within
the H100's 227 KB, the route on each side of its boundaries, and the
source's constants mirrored. Exact integer checks, no tolerance.
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import ailayernorm as KN
from repro_torch.roofline.cost import CostCounter

SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
       / "csrc" / "ailayernorm.cu")
H100_SMEM_PER_CTA = 232448                  # 227 KB, the most a CTA may take
ROWS = (1, 8, 40, 127, 128, 129, 2400, 153600)
WIDTHS = (64, 768, 896, 2048, 3584, 4096, 6144, 8192, 12288)


def _r16(n):
    return -(-n // 16) * 16


def _check(plan, rows, c, itemsize, groups, sms):
    assert plan.route in ("cluster", "grid")
    # every row exactly once: CTA k takes the rows of groups
    # [k sets / ctas, (k + 1) sets / ctas), at most chunk rows, whole groups
    assert plan.chunk >= 1 and plan.chunk % groups == 0
    sets = rows // groups
    assert 1 <= plan.ctas <= sets
    taken = [0] * rows
    for k in range(plan.ctas):
        lo, hi = (sets * k // plan.ctas * groups,
                  sets * (k + 1) // plan.ctas * groups)
        assert 0 < hi - lo <= plan.chunk and (hi - lo) % groups == 0
        for i in range(lo, hi):
            taken[i] += 1
    assert set(taken) == {1}
    assert plan.chunk == -(-sets // plan.ctas) * groups
    # the co-resident limit: a cluster of at most 16, a grid of one CTA an SM
    if plan.route == "cluster":
        assert plan.ctas <= KN.CALIB_CLUSTER_MAX and plan.scratch == 0
    else:
        assert plan.ctas <= sms
        assert plan.scratch == plan.ctas * (c + 1) + c
    # shared memory: the fixed part, then as many rows of h as fit
    fixed = (_r16(4 * c) + _r16(c)
             + (_r16(4 * -(-c // plan.ctas)) if plan.ctas > 1 else 0))
    assert 0 <= plan.keep <= plan.chunk
    assert plan.smem == fixed + plan.keep * _r16(c * itemsize)
    assert plan.smem <= KN.CALIB_SMEM_MAX < H100_SMEM_PER_CTA
    if plan.keep < plan.chunk:
        assert plan.smem + _r16(c * itemsize) > KN.CALIB_SMEM_MAX
    # teams: a power of two of lanes covering the row's 16-byte units up
    # to a warp, widened while the teams still take every row at once
    tt = KN.CALIB_THREADS // plan.teams
    assert tt * plan.teams == KN.CALIB_THREADS and tt & (tt - 1) == 0
    units = -(-c * itemsize // 16)
    assert tt >= min(32, units)
    assert (tt == KN.CALIB_THREADS or tt >= units
            or plan.teams // 2 < plan.chunk)
    assert plan.teams >= plan.chunk or tt <= 32 or tt >= units


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("rows", ROWS)
def test_plan_covers_every_row_within_the_card(rows, c, itemsize):
    plan = KN.calib_plan(rows, c, itemsize)
    _check(plan, rows, c, itemsize, 1, KN.H100_SMS)
    decode = rows < KN.CALIB_PREFILL_ROWS or rows * c <= \
        KN.CALIB_DECODE_ELEMENTS
    assert plan.route == ("cluster" if decode else "grid")


@pytest.mark.parametrize("rows,c,route", [
    (1, 896, "cluster"), (8, 896, "cluster"), (40, 4096, "cluster"),
    (127, 6144, "cluster"), (128, 896, "grid"), (129, 6144, "grid"),
    (2400, 6144, "grid"), (512, 64, "cluster"), (128, 256, "cluster"),
    (128, 257, "grid"), (8192, 64, "grid"), (153600, 64, "grid")])
def test_route_on_each_side_of_the_boundaries(rows, c, route):
    """Decode and verify rows (fewer than 128, or at most 32,768 elements:
    rwkv6's 512 GroupNorm rows of 64) take a cluster; from 128 rows and
    more elements, the grid."""
    assert KN.calib_plan(rows, c, 2).route == route


@pytest.mark.parametrize("rows", [64, 512, 8192, 153600])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_grouped_rows_keep_whole_groups(rows, itemsize):
    """rwkv6's per-head GroupNorm (G = 64): each CTA takes whole groups of
    rows, so row r of any CTA takes affine row r mod G."""
    plan = KN.calib_plan(rows, 64, itemsize, groups=64)
    _check(plan, rows, 64, itemsize, 64, KN.H100_SMS)
    with pytest.raises(ValueError):
        KN.calib_plan(rows + 1, 64, itemsize, groups=64)


@pytest.mark.parametrize("sms", [1, 16, 114, 132])
@pytest.mark.parametrize("rows,c", [(128, 896), (2400, 6144), (153600, 64)])
def test_grid_within_the_co_resident_limit_given(rows, c, sms):
    """The grid route takes at most one CTA on each SM it is given (an
    H100 PCIe has 114), and still every row once."""
    groups = 64 if c == 64 else 1
    plan = KN.calib_plan(rows, c, 2, groups=groups, sms=sms)
    assert plan.route == "grid"
    _check(plan, rows, c, 2, groups, sms)


def test_prefill_spreads_over_the_card_and_decode_stays_small():
    """Prefill rows reach every SM (not one cluster of at most 16 CTAs);
    a decode step is a cluster of one row a CTA, h in shared memory, one
    team a row."""
    for rows, c in ((2400, 896), (2400, 6144), (2048, 3584), (153600, 64)):
        plan = KN.calib_plan(rows, c, 2, groups=64 if c == 64 else 1)
        assert plan.ctas > 16 and plan.ctas >= KN.H100_SMS - 8
    for c, teams in ((768, 4), (896, 4), (3584, 1), (4096, 1), (6144, 1)):
        plan = KN.calib_plan(8, c, 2)
        assert (plan.route, plan.ctas, plan.chunk, plan.keep,
                plan.teams) == ("cluster", 8, 1, 1, teams)
    plan = KN.calib_plan(40, 4096, 2)
    assert (plan.ctas, plan.chunk, plan.teams) == (16, 3, 4)
    # the h slab: whole where it fits; 2,400 rows of 6,144 keep most rows
    plan = KN.calib_plan(2400, 6144, 2)
    assert 0 < plan.keep < plan.chunk and plan.keep >= 0.8 * plan.chunk


def test_plan_mirrors_the_source_constants():
    """The Python plan and the CUDA source agree on the block size, the
    cluster cap and the shared memory a CTA may take."""
    src = SRC.read_text()

    def const(name):
        m = re.search(rf"constexpr \w+ {name} = ([^;]+);", src)
        assert m, name
        return eval(m.group(1).replace("(size_t)", ""))  # noqa: S307
    assert const("kCalThreads") == KN.CALIB_THREADS
    assert const("kCalClusterMax") == KN.CALIB_CLUSTER_MAX
    assert const("kCalSmemMax") == KN.CALIB_SMEM_MAX


@pytest.mark.parametrize("rows,c,rms,residual,groups,quant", [
    (8, 896, True, True, 1, False), (8, 896, True, True, 1, True),
    (2400, 6144, False, True, 1, False), (2400, 6144, False, True, 1, True),
    (40, 4096, False, False, 1, False), (153600, 64, False, False, 64, False)])
def test_meta_branch_reports_the_kernels_bytes(rows, c, rms, residual,
                                               groups, quant):
    """On meta tensors the wrapper reports one ``ailayernorm_calib`` launch
    with the bytes it moved before the plan (x, r, the affine, h, the
    output, alpha and scale once each; the grid route's scratch is not
    counted) and allocates the launch's outputs, scratch included."""
    x = torch.empty((rows, c), dtype=torch.bfloat16, device="meta")
    r = torch.empty_like(x) if residual else None
    shape = (groups, c) if groups > 1 else (c,)
    gamma = torch.empty(shape, device="meta")
    beta = None if rms else torch.empty(shape, device="meta")
    with CostCounter() as counter:
        h, res, alpha, scale = KN.calibrated_norm(
            x, r, gamma, beta, rms=rms, out_dtype=torch.bfloat16,
            quant_out=quant)
    recs = {k: v for k, v in counter.records.items()
            if k[0] == "kernel:ailayernorm_calib"}
    assert [v[0] for v in recs.values()] == [1]
    act = rows * c * 2
    out = rows * c + rows * 4 if quant else act
    want = (act * (3 if residual else 1) + out
            + 4 * gamma.numel() * (1 if rms else 2) + 4 * c + 4)
    assert [v[1] for v in recs.values()] == [want]
    assert alpha.shape == (c,) and scale.shape == (1,)
    assert (h.shape == x.shape) and (res[0].shape if quant else
                                     res.shape) == x.shape
    plan = KN.calib_plan(rows, c, 2, groups)
    assert counter.cost.peak_bytes >= 4 * plan.scratch
