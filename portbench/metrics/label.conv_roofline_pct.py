"""label.conv_roofline_pct: The CLIP ResNet tower's convolutions, their operations by formula over the labeling
window (``roofline_resnet.conv_flops_per_frame`` a frame, frames returned) at float32's 495 TFLOP/s, over the
device time of cuDNN's convolution kernels (%).  The kernels are told by name: implicit-GEMM ``fprop``, direct
``convolve``, and the FFT algorithm's transforms, complex products and complex GEMMs.  cuDNN's layout transforms
(``nchwToNhwc`` / ``nhwcToNchw``) run around the convolutions but compute none, and are left out; the
breakdown names them."""

import re

from portbench.roofline import PEAK_FLOPS

CONV = re.compile(r"fprop|convolve|fft|cf32cf32|_complex<|<float2", re.IGNORECASE)


def read(record: dict):
    flops = record["work"].get("conv_flops")
    spent = sum(seconds for name, (seconds, _) in record["kernels"].items() if CONV.search(name))
    if not flops or spent <= 0:
        return None
    return 100.0 * flops / PEAK_FLOPS[record["work"]["dtype"]] / spent
