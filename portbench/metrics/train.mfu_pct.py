"""The whole step's share of the card's float32 peak (67 TFLOP/s): the
FLOPs of an iteration by the benchmark's count over the time of an
iteration in an untraced stretch of the traced run."""

PEAK_F32 = 67e12


def read(layer):
    if layer.get("kind") != "train":
        return None
    return 100.0 * layer["flops_per_unit"] / (layer["unit_s"] * PEAK_F32)
