"""Launch plans of the per-sample window-attention kernels
(``forward_plan`` / ``backward_plan`` in etmppo_tpu_torch.ops.window_attention).

The kernels run only on the card; what is checked here is the plan the
wrapper hands them: for every shipped configuration that runs the kernels
(``use_pallas_attention: true``) and for chip_smoke.py's shapes, the plan fits
the card's shared memory and thread limits, it is one the kernels accept, and
its tiles cover every window row exactly once.
"""
from pathlib import Path

import pytest

import chip_smoke
from etmppo_tpu_torch.config import load_config
from etmppo_tpu_torch.ops import window_attention as wa

CONFIG_DIR = Path(__file__).resolve().parent.parent / "etmppo_tpu" / "configs"
KERNEL_CONFIGS = (
    "headroom_768.yaml", "minigrid.yaml", "mortar_mayhem_grid.yaml",
    "mortar_mayhem_grid_seed1.yaml", "mystery_path_grid.yaml",
    "mystery_path_grid_gtrxl.yaml", "mystery_path_grid_seed1.yaml",
    "mystery_path_grid_seed2.yaml", "mystery_path_grid_seed3.yaml",
    "mystery_path_grid_seed4.yaml", "searing_spotlights.yaml",
    "searing_spotlights_beta.yaml", "searing_spotlights_shaped.yaml")
PLANS = {"forward": wa.forward_plan, "backward": wa.backward_plan}
SMEM_PER_CTA = 232448       # 227 KB, the most one CTA may have on sm_90
THREADS_PER_CTA = 1024


def _window_shape(name: str):
    config = load_config(str(CONFIG_DIR / name))
    trx = config.transformer
    return trx.memory_length, trx.embed_dim, trx.num_heads


def _warps_per_head(plan) -> int:
    return getattr(plan, "warps_per_head", 1)


def _check_plan(plan, L: int, D: int, H: int) -> None:
    """What the kernels' C entries require of a plan, and the card's limits."""
    wph = _warps_per_head(plan)
    rows, threads, smem = plan.rows_per_tile, plan.threads, plan.smem_bytes
    assert smem <= SMEM_PER_CTA and threads <= THREADS_PER_CTA
    assert threads <= wa.MAX_THREADS and threads == H * wph * 32
    assert rows % wph == 0
    per_warp = rows // wph
    assert per_warp & (per_warp - 1) == 0
    if isinstance(plan, wa.BackwardPlan):
        assert 1 <= per_warp <= 32
        assert smem == wa.backward_smem_bytes(L, D, H, rows, wph)
    else:
        assert isinstance(plan, wa.ForwardPlan)
        assert 1 <= rows <= 8
        assert smem == wa.forward_smem_bytes(D, rows)


def _rows_walked(plan, L: int) -> list:
    """The window rows each (tile, warp, lane row) of the plan takes, walked
    as the kernels walk them: tile t holds rows [t * rows, (t + 1) * rows),
    warp k of a head the k-th run of rows // warps_per_head of them, and
    lane row j the j-th of those; rows past L are skipped."""
    rows, wph = plan.rows_per_tile, _warps_per_head(plan)
    per_warp = rows // wph
    walked = []
    for t in range(-(-L // rows)):
        n_rows = min(rows, L - t * rows)
        for k in range(wph):
            for j in range(per_warp):
                r = k * per_warp + j
                if r < n_rows:
                    walked.append(t * rows + r)
    return walked


def test_kernel_configs_are_the_shipped_ones():
    shipped = sorted(p.name for p in CONFIG_DIR.glob("*.yaml")
                     if load_config(str(p)).use_pallas_attention)
    assert shipped == sorted(KERNEL_CONFIGS)


@pytest.mark.parametrize("which", sorted(PLANS))
@pytest.mark.parametrize("name", KERNEL_CONFIGS)
def test_plan_fits_each_shipped_config(name, which):
    L, D, H = _window_shape(name)
    plan = PLANS[which](L, D, H)
    _check_plan(plan, L, D, H)
    # Every shipped shape leaves room for two CTAs on one SM.
    assert plan.smem_bytes <= wa.SMEM_TWO_PER_SM
    assert sorted(_rows_walked(plan, L)) == list(range(L))


@pytest.mark.parametrize("which", sorted(PLANS))
@pytest.mark.parametrize("shape", sorted(chip_smoke.plan_shapes()))
def test_plan_fits_chip_smoke_shapes(shape, which):
    L, D, H = chip_smoke.plan_shapes()[shape]
    plan = PLANS[which](L, D, H)
    _check_plan(plan, L, D, H)
    assert sorted(_rows_walked(plan, L)) == list(range(L))


@pytest.mark.parametrize("which", sorted(PLANS))
@pytest.mark.parametrize("L, D, H", [(1, 4, 1), (13, 40, 4), (118, 384, 4),
                                     (7, 6, 3), (33, 1000, 8), (200, 64, 16)])
def test_any_window_is_covered_once(L, D, H, which):
    """Windows of any length, odd widths and head counts up to 16."""
    plan = PLANS[which](L, D, H)
    _check_plan(plan, L, D, H)
    walked = _rows_walked(plan, L)
    assert len(walked) == L and sorted(walked) == list(range(L))


def test_plans_that_cannot_run_raise():
    with pytest.raises(ValueError, match="threads"):
        wa.forward_plan(16, 1024, 32)
    with pytest.raises(ValueError, match="shared memory"):
        wa.backward_plan(16, 40000, 4)
    with pytest.raises(ValueError, match="shared memory"):
        wa.backward_plan(20000, 256, 4)


def test_per_sample_wrappers_pass_the_plan():
    """The C entries take the seven shapes and the plan's ints: rows per
    tile, (the backward's warps per head,) threads and shared memory."""
    assert wa.window_attention_fwd.n_ints == 7 + len(wa.ForwardPlan._fields)
    assert wa.window_attention_bwd.n_ints == 7 + len(wa.BackwardPlan._fields)
    assert (wa.window_attention_fwd.n_ints,
            wa.window_attention_bwd.n_ints) == (10, 11)
    for kernel in (wa.window_attention_fwd_grouped,
                   wa.window_attention_bwd_grouped):
        assert kernel.n_ints == 7 + len(wa.GroupedPlan._fields)


def test_per_sample_kernels_share_the_ring():
    """Both per-sample kernels include the one ring header, and the wrapper's
    shared-memory count uses its ring depth and barrier floats."""
    header = wa.FWD_SOURCE.parent / "window_ring.cuh"
    text = header.read_text()
    assert f"constexpr int kStages = {wa.RING_STAGES};" in text
    assert f"constexpr int kBarFloats = {wa.RING_BAR_FLOATS};" in text
    for source in (wa.FWD_SOURCE, wa.BWD_SOURCE):
        assert '#include "window_ring.cuh"' in source.read_text()
