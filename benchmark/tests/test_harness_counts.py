"""The benchmark's frozen counts equal the port's at the cells' shapes."""

import pytest

from benchmark import counts
from distributedconvrl_pde_control_torch.ops.kernels import ks_kernel, ns_advection


@pytest.mark.parametrize("nx,oversampling", [(192, 30), (190, 30), (6000, 30)])
def test_ks_flops_per_row(nx, oversampling):
    assert counts.ks_flops_per_row(nx, oversampling) == ks_kernel.flops_per_row(nx, oversampling)


@pytest.mark.parametrize("n,batch", [(256, 16), (256, 1), (96, 4)])
def test_ns_flops_and_bytes(n, batch):
    assert counts.ns_flops(n, batch) == ns_advection.flops(n, batch)
    assert counts.ns_min_bytes(n, batch) == ns_advection.min_bytes(n, batch)


def test_bounds_of_the_cells():
    # K1 at 16384 x 192, 30 substeps: 4,460,191,482 operations -> 0.0666 ms at 67 TFLOP/s
    assert counts.ks_flops_per_row(192, 30) * 16384 == pytest.approx(4460191482, rel=1e-9)
    assert counts.ks_step_bound_s(192, 30, 16384) == pytest.approx(6.657e-5, rel=1e-3)
    # K2 at 256^2: bound by bytes, 1 MB at batch 1 over 3.35 TB/s per evaluation
    per_eval = counts.ns_min_bytes(256, 1) / counts.PEAK_BYTES_PER_S
    assert per_eval > counts.ns_flops(256, 1) / counts.PEAK_FLOPS_FP32
    assert counts.ns_step_bound_s(256, 1, 81) == pytest.approx(4 * 81 * per_eval)


def test_network_counts():
    assert counts.chain_params([2, 140, 1]) == 2 * 140 + 140 + 140 + 1
    assert counts.chain_flops([1, 6, 1], 8) == 8 * (2 * 6 + 2 * 6 + 2 * 6 + 2)
