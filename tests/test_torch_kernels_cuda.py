"""The hand-written Hopper kernels against their plain versions on the card —
the same sweep as ``chip_smoke.py``'s kernel phase.  These need an NVIDIA GPU
and nvcc; where there is none they skip with the reason.  Run them on the
card with ``PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels import checks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_qgemm_kernel_equals_plain_version(cuda):
    res = checks.qgemm_sweep(cuda)
    torch.cuda.synchronize()
    assert res["failures"] == [], checks.summarize(res)
    assert res["max_abs_err"] == 0.0


@pytest.mark.cuda
def test_qconv_dw_kernel_equals_plain_version(cuda):
    res = checks.qconv_dw_sweep(cuda)
    torch.cuda.synchronize()
    assert res["failures"] == [], checks.summarize(res)
    assert res["max_abs_err"] == 0.0


@pytest.mark.cuda
def test_kernels_count_launches(cuda):
    from repro_torch.kernels.qconv_dw.ops import qconv_dw
    from repro_torch.kernels.qmatmul.ops import qgemm
    before = (qgemm.launches, qconv_dw.launches)
    checks.qgemm_sweep(cuda, shapes=[(3, 9, 8)])
    checks.qconv_dw_sweep(cuda, shapes=[(1, 5, 5, 8)], strides=[(1, 1)],
                          pads=["SAME"])
    assert qgemm.launches - before[0] == 5 * 3 * 2 * 2
    assert qconv_dw.launches - before[1] == 5 * 3 * 2 * 2
