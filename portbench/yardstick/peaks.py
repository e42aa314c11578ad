"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit): HBM bandwidth and the float32 rate outside the tensor cores, which
is the rate of every float32 matrix product while TF32 is off; TF32's
tensor-core rate for a program that turns it on."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12


def matmul_peak(tf32: bool) -> float:
    """The peak of the precision float32 products run in."""
    return TF32_FLOPS if tf32 else F32_FLOPS
