"""Published peaks of the chips the benchmark runs on.

One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W power limit):
989.4 TFLOP/s in bf16 on the tensor cores, 66.9 TFLOP/s in float32 off
them, 3.35 TB/s of HBM3 bandwidth.  A share of a peak is reported against
these numbers whatever the card's power limit; the run prints the card's
name beside it.
"""

H100_SXM = {
    "bf16_flops": 989.4e12,
    "fp32_flops": 66.9e12,
    "hbm_bytes_per_s": 3.35e12,
}

PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def peaks_for(kind: str) -> dict:
    """The peaks of the card named ``kind`` (``torch.cuda.
    get_device_name()``); an unknown card is taken as an H100 SXM, the only
    card the benchmark is defined on."""
    return PEAKS.get(kind, H100_SXM)
