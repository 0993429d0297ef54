"""NVIDIA H100 SXM's published dense peaks (NVIDIA's data sheet), at the
card's full 700 W power limit; a card set lower reads below them.

fp32 at fp32's accuracy on the tensor cores is 3xTF32 (each product as
three TF32 products, as the port's K1 and K4 take it): a third of the TF32
rate. The CUDA cores' fp32 rate is kept for the record."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "fp32_cuda_cores": 67e12,
         "float32": 495e12 / 3.0}
# special-function-unit operations (lg2, ex2) per clock per SM on Hopper
SFU_PER_CLOCK_SM = 16


def model_peak(precision: str) -> float:
    """The FLOP/s a configuration's precision can reach at its accuracy:
    989e12 for bfloat16, 165e12 for float32 (3xTF32)."""
    return FLOPS[precision]
