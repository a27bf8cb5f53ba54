"""The trace reduction behind the device busy/idle share
(experiments/profile_step.py)."""

import argparse

import pytest

from experiments import profile_step as ps


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 2)], 2.0),
    ([(0, 2), (5, 6)], 3.0),
    ([(0, 4), (1, 2)], 4.0),          # nested: a kernel inside another's span
    ([(3, 6), (0, 4)], 6.0),          # overlapping, out of order
    ([(0, 2), (2, 3)], 3.0),          # touching
])
def test_busy_time_is_the_union_of_kernel_intervals(intervals, want):
    assert ps._union_length(intervals) == want


@pytest.mark.parametrize("name,cls", [
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize64x64x32", "matmul library"),
    ("gemm_fusion_dot_13", "matmul library"),
    ("MemcpyD2D", "copy"),
    ("input_multiply_reduce_fusion", "XLA fusion"),
    ("loop_dynamic_update_slice_fusion_7", "XLA fusion"),
    ("ncclDevKernel_AllReduce_Sum_f32", "collective"),
])
def test_kernel_classes(name, cls):
    assert ps.classify(name) == cls


def test_traced_windows_and_missing_gpu_planes(tmp_path):
    """On the CPU the step runs and is timed, and the reduction refuses a
    trace that has no GPU stream line instead of reporting zero busy time."""
    args = argparse.Namespace(
        target="many_gmm", mode="MCD_CAIS_var_sn", nbridges=2, n=8,
        emb_dim=4, nn_arch="geffner", steps=2, eval=False,
    )
    step, state = ps.build_step(args)
    untraced, traced = ps.run_traced(step, state, 2, str(tmp_path))
    assert untraced > 0 and traced > 0
    with pytest.raises(RuntimeError, match="no kernel events"):
        ps.parse_trace(str(tmp_path), 2)
