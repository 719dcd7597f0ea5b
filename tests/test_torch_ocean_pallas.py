"""repro_torch's OCEAN trajectory with the pallas solver (the K1 sweep)
against the JAX reference, on the scan path and on the fused path (K3's
plain version on the CPU against the reference's ``traj="fused"``
interpret-mode kernel), at the K = 6, T = 40, frame_len = 13 setting of
tests/test_torch_ocean.py, whose helpers it uses.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_ocean import _port, check_teacher_forced, check_whole_trajectory  # noqa: E402


def test_scan_rounds_teacher_forced_match_reference():
    check_teacher_forced("pallas")


@pytest.mark.parametrize("traj", ["scan", "fused"])
def test_whole_trajectory_matches_reference(traj):
    check_whole_trajectory("pallas", traj)


def test_scan_equals_fused_bitwise_on_cpu():
    """On the CPU the fused backend is K3's plain version, the scan loop
    through ocean_round with the plain K1: bit-identical to the scan path."""
    s_scan, d_scan = _port("pallas", "scan")
    s_fused, d_fused = _port("pallas", "fused")
    for f in ("a", "b", "e", "q", "rho", "objective", "num_selected"):
        assert torch.equal(getattr(d_scan, f), getattr(d_fused, f)), f
    assert torch.equal(s_scan.q, s_fused.q)
    assert torch.equal(s_scan.energy_spent, s_fused.energy_spent)
