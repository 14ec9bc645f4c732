"""Published peaks of the cards a roofline share is taken against: NVIDIA's
data sheet for the H100 SXM (80 GB HBM3), dense rates, at its 700 W
limit."""

PEAKS = {
    "H100": {"bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12},
}


def of(device_name):
    """The peaks of a card by its name (torch.cuda.get_device_name), or None."""
    for key, peak in PEAKS.items():
        if key in device_name:
            return peak
    return None


def bound_s(nbytes, ops, peak):
    """The least time the card could take: the larger of bytes over the
    memory rate and float32 operations over the float32 rate."""
    return max(nbytes / peak["bytes_per_s"], ops / peak["f32_ops_per_s"])
