"""The kernel-1 roofline arithmetic."""
from perfbench import roofline


def test_kernel1_bytes_and_bound_at_640x480():
    n = roofline.kernel1_bytes(480, 640)
    # the kernel table's row 1 counts 33.5 MB with only the reference rows
    # one view fetches; counting every row is the most one launch needs
    assert abs(n / 33.5e6 - 1) < 0.05
    assert n == 4 * (480 * 640 * 28 + 24 + 29)
    assert abs(roofline.kernel1_bound_s(480, 640) * 1e3 - 0.0100) < 0.0005


def test_kernel1_is_found_by_its_name_alone():
    assert roofline.is_kernel1("(anonymous namespace)::fused_aligner_kernel(float const*, float4 const*, float const*, "
                               "float*, pwn::Geometry)")
    assert not roofline.is_kernel1("(anonymous namespace)::fused_aligner_batch_kernel(float const*)")
    assert not roofline.is_kernel1("reduce_blocks_kernel(float const*, int, double*)")
