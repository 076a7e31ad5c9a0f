"""The table of peaks every roofline and utilization share is taken
against: one NVIDIA H100 SXM at its full 700 W, dense rates from NVIDIA's
data sheet.  The configurations run float32 with TF32 off, so the
float32 rate outside the tensor cores is the compute peak."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
